"""tpuparquet_torch.serve: the serve layer's shared state.

:mod:`.arbiter` holds one process-wide worker budget split into
per-tenant shares (adjusted from the ledgers, digests and SLO burn
rates), with admission control that sheds load by a retryable
rejection.  The reference's scan server (``ScanServer``, ``ScanJob``),
which drives tenants' scans over it, is not ported yet.
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
