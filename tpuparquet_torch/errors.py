"""Error taxonomy of the read path: errors that carry scan coordinates.

A copy of the classes the decode path raises, and of the fault layer's:
a transient read (retried), a failed device dispatch (retried, then
decoded on the host), a deadline past its budget, and what a
quarantining scan may absorb.  Each layer fills the
coordinates it knows (``file``, ``row_group``, ``column``, ``page``) as
the error crosses it, so the failing unit is pinpointed exactly.
"""

from __future__ import annotations

__all__ = [
    "ScanError",
    "CorruptPageError",
    "CorruptChunkError",
    "CorruptFooterError",
    "CorruptManifestError",
    "TransientIOError",
    "DeviceDispatchError",
    "DeadlineExceededError",
    "DispatchDeadlineError",
    "KernelBuildError",
    "KernelLaunchError",
    "ServeStateError",
    "AdmissionRejected",
    "QUARANTINE_ERRORS",
    "never_quarantine",
]

_COORD_FIELDS = ("file", "row_group", "column", "page")


class ScanError(Exception):
    """Base of the taxonomy: an error with scan coordinates (all
    optional; :meth:`annotate` fills blanks without clobbering what an
    inner layer already pinned)."""

    def __init__(self, message: str = "", *, file=None, row_group=None,
                 column=None, page=None):
        super().__init__(message)
        self.message = message
        self.file = file
        self.row_group = row_group
        self.column = column
        self.page = page

    def coordinates(self) -> dict:
        return {
            k: getattr(self, k)
            for k in _COORD_FIELDS
            if getattr(self, k) is not None
        }

    def annotate(self, **coords) -> "ScanError":
        """Fill in *missing* coordinates; returns self for re-raise."""
        for k, v in coords.items():
            if k not in _COORD_FIELDS:
                raise TypeError(f"unknown coordinate {k!r}")
            if getattr(self, k) is None and v is not None:
                setattr(self, k, v)
        return self

    def __str__(self) -> str:
        c = self.coordinates()
        if not c:
            return self.message
        at = ", ".join(f"{k}={v}" for k, v in c.items())
        return f"{self.message} [{at}]"


class CorruptPageError(ScanError, ValueError):
    """One page's bytes are wrong (CRC mismatch, malformed header,
    truncated payload, impossible value counts)."""


class CorruptChunkError(ScanError, ValueError):
    """A column chunk is structurally wrong beyond one page (byte
    range out of bounds, value-count mismatch)."""


class CorruptFooterError(ScanError, ValueError):
    """The file's framing or ``FileMetaData`` is wrong: bad magic, torn
    or truncated footer, thrift that does not decode, or metadata whose
    offsets and counts fail validation against the file
    (``format/validate.py``).  Carries the byte ``offset`` of the
    rejecting check, and the validator's ``findings`` when the strict
    metadata check raised it."""

    def __init__(self, message: str = "", *, offset=None, findings=None,
                 **coords):
        super().__init__(message, **coords)
        self.offset = offset
        self.findings = list(findings) if findings else []

    def coordinates(self) -> dict:
        c = super().coordinates()
        if self.offset is not None:
            c["offset"] = self.offset
        return c


class CorruptManifestError(ScanError, ValueError):
    """A partitioned dataset's manifest snapshot or commit journal failed
    its framing checks: not the envelope format, an unknown version, a
    CRC mismatch over the canonical body, or a body that fails structural
    validation (``dataset/manifest.py``).  ``file`` names the manifest;
    the resolver degrades to the newest older snapshot that validates."""


class TransientIOError(ScanError, OSError):
    """An I/O failure that may succeed on retry.  A remote source's
    throttle (HTTP 429 or 503 with a ``Retry-After`` header,
    ``io/source.py``) sets ``retry_after_s``, which
    ``faults.retry_transient`` honours up to its backoff cap."""


class DeviceDispatchError(ScanError, RuntimeError):
    """Staging or launching a unit's device work failed; the input bytes
    are fine and the host decode can still read them."""


class _DeadlineInfo:
    """The elapsed time, budget and site of the two deadline errors (a
    mixin: they subclass different parents, OSError for the retry ladder
    and RuntimeError for the dispatch ladder)."""

    def _set_deadline(self, elapsed, budget, site):
        self.elapsed = elapsed
        self.budget = budget
        self.site = site

    def _deadline_coords(self, c: dict) -> dict:
        if self.elapsed is not None:
            c["elapsed_s"] = round(self.elapsed, 3)
        if self.budget is not None:
            c["budget_s"] = self.budget
        return c


class DeadlineExceededError(_DeadlineInfo, TransientIOError):
    """A watched operation ran past its time budget.  A
    :class:`TransientIOError`, so a retry retries it and a quarantining
    scan absorbs it."""

    def __init__(self, message: str = "", *, elapsed=None, budget=None,
                 site=None, **coords):
        super().__init__(message, **coords)
        self._set_deadline(elapsed, budget, site)

    def coordinates(self) -> dict:
        return self._deadline_coords(super().coordinates())


class DispatchDeadlineError(_DeadlineInfo, DeviceDispatchError):
    """A watched device dispatch ran past its time budget; the resilient
    read's retry and host-decode ladder takes it as a failed dispatch."""

    def __init__(self, message: str = "", *, elapsed=None, budget=None,
                 site=None, **coords):
        super().__init__(message, **coords)
        self._set_deadline(elapsed, budget, site)

    def coordinates(self) -> dict:
        return self._deadline_coords(super().coordinates())


class KernelBuildError(RuntimeError):
    """A native source did not build (or its compiler is missing)."""


class KernelLaunchError(RuntimeError):
    """A kernel's launch, or a CUDA helper beside it, returned a CUDA
    error (``kernels/_lib.py`` ``launch``)."""


class ServeStateError(RuntimeError):
    """An operation out of the serve layer's order, e.g. activating a
    second process-wide :class:`~tpuparquet_torch.serve.ResourceArbiter`
    while another is active.  A caller's bug, not a scan failure."""


class AdmissionRejected(ServeStateError):
    """Admission control shed a job before it started
    (:meth:`tpuparquet_torch.serve.ResourceArbiter.admit`).

    Always retryable: the job was never queued, so resubmitting after
    ``retry_after_s`` cannot duplicate it.  ``tenant``, ``reason``
    (``"queue_full"``, ``"byte_budget"``, ``"deadline_budget"``) and
    ``retry_after_s`` are what a client's backoff reads."""

    def __init__(self, msg: str, *, tenant: str, reason: str,
                 retry_after_s: float):
        super().__init__(msg)
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = retry_after_s


# What a quarantining scan may absorb a unit: the clean failures
# (ValueError covers the Corrupt* and codec errors, EOFError truncation,
# TypeError and NotImplementedError foreign shapes, OSError an exhausted
# read, RuntimeError a device failure past the dispatch ladder).  Raw crash types (IndexError,
# KeyError, ...) are bugs and propagate; RecursionError subclasses
# RuntimeError, so catch sites pair this with :func:`never_quarantine`.
QUARANTINE_ERRORS = (ValueError, EOFError, TypeError,
                     NotImplementedError, OSError, RuntimeError)


def never_quarantine(exc: BaseException) -> bool:
    """Errors that must propagate although they subclass a member of
    :data:`QUARANTINE_ERRORS`: a RecursionError (a crash), and a kernel
    that did not build or did not launch (:class:`KernelBuildError`,
    :class:`KernelLaunchError`: the port's own fault, which no unit may
    hide by being dropped or by decoding on the host instead)."""
    return isinstance(exc, (RecursionError, KernelBuildError,
                            KernelLaunchError))
