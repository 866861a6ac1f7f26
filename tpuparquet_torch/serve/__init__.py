"""tpuparquet_torch.serve: the long-lived multi-tenant scan server.

* :mod:`.arbiter` holds one process-wide worker budget split into
  per-tenant shares (adjusted from the ledgers, digests and SLO burn
  rates), with admission control that sheds load by a retryable
  rejection;
* :mod:`.server` runs tenants' :class:`~tpuparquet_torch.shard.scan.
  ShardedScan` jobs from bounded per-tenant queues over the shared plan
  cache and arena pool, with a graceful drain whose durable cursors a
  successor resumes;
* :mod:`.prefetch` warms the disk tier ahead of a job's cursor, as deep
  as its latency objective asks.

The arbiter imports at once (the thread budgets read it); the server,
which pulls in the whole scan stack, loads at its first use.
"""

from .arbiter import (  # noqa: F401
    AdmissionRejected,
    ResourceArbiter,
    ServeStateError,
    activate,
    active,
    current_binding,
    deactivate,
    plan_budget,
    queue_bound_default,
    serve_workers,
    tenant_scope,
    warn_if_oversubscribed,
    write_budget,
)

__all__ = [
    "AdmissionRejected",
    "ResourceArbiter",
    "ScanJob",
    "ScanServer",
    "ServeStateError",
    "activate",
    "active",
    "current_binding",
    "deactivate",
    "plan_budget",
    "queue_bound_default",
    "serve_workers",
    "tenant_scope",
    "warn_if_oversubscribed",
    "write_budget",
]


def __getattr__(name: str):
    if name in ("ScanServer", "ScanJob"):
        from . import server as _server

        return getattr(_server, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
