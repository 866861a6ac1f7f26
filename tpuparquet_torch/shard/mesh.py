"""The scan mesh and the SPMD dictionary decode step.

The port of ``tpuparquet/shard/mesh.py``.  A :class:`Mesh` is a grid of
``torch.device``\\ s over two axes:

* ``"rg"`` — data parallel over (file, row group) units: units shard
  across this axis, with no exchange until a gather;
* ``"sp"`` — sequence parallel over the value positions of a unit: each
  slot of an rg block expands its own slice of positions from the shared
  run table (random access after planning, so no halo exchange).

A slot may repeat a device: a CPU mesh (every slot ``cpu``), or a mesh of
several slots on one card, which runs the same placement, assembly and
sp split as a mesh of as many cards.  Collectives become copies between
the mesh's distinct devices (none where the slots share one).

Static shapes as in the reference: every unit's plan is padded to the
batch's buckets (run count, bit-packed lanes, value count), so one step
serves the whole batch.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..kernels.decode import bucket
from ..kernels.gather import spmd_step_slot
from ..kernels.hybrid import HybridPlan, plan_hybrid

__all__ = [
    "Mesh",
    "local_devices",
    "make_mesh",
    "assign_units",
    "resolve_out_sharding",
    "placement_devices",
    "dim0_partitions",
    "BatchedHybridPlan",
    "stack_hybrid_plans",
    "decode_step_spmd",
    "sharded_dict_decode",
]

class Mesh:
    """An ``("rg", "sp")`` grid of ``torch.device``\\ s.  ``devices`` is the
    ``(rg, sp)`` object array; ``shape`` maps each axis to its size."""

    def __init__(self, devices):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError("a mesh is a non-empty (rg, sp) grid of devices")
        self.devices = np.empty(grid.shape, dtype=object)
        for ix, d in np.ndenumerate(grid):
            self.devices[ix] = torch.device(d)

    @property
    def shape(self) -> dict:
        return {"rg": self.devices.shape[0], "sp": self.devices.shape[1]}

    def distinct_devices(self) -> list:
        """The mesh's devices without repeats, in slot order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def local_devices() -> list:
    """This process's cards, ``cuda:0 .. cuda:n-1`` (empty without
    CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, sp: int | None = None,
              devices=None) -> Mesh:
    """Build an ``("rg", "sp")`` mesh over the first ``n_devices`` devices
    (default: this process's cards; raises without one — pass
    ``devices=["cpu"] * n`` for a CPU mesh).

    ``sp`` defaults to 2 when the device count is even and above 2 (so
    both axes are exercised), else 1."""
    if devices is None:
        devs = local_devices()
        if not devs:
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] * n "
                "for a CPU mesh")
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if sp is None:
        sp = 2 if n > 2 and n % 2 == 0 else 1
    if n % sp:
        raise ValueError(f"{n} devices not divisible by sp={sp}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n // sp, sp))


def assign_units(n_units: int, n_shards: int) -> list[list[int]]:
    """Round-robin unit indices over shards (static, deterministic)."""
    out: list[list[int]] = [[] for _ in range(n_shards)]
    for i in range(n_units):
        out[i % n_shards].append(i)
    return out


# ----------------------------------------------------------------------
# Consumer placement
# ----------------------------------------------------------------------

def _gather_to_env():
    """``TPQ_GATHER_TO``: the default ``gather_to`` device index (into
    :func:`local_devices`) of scans.  Unset or empty: replicated.  A
    malformed or out-of-range value raises."""
    raw = os.environ.get("TPQ_GATHER_TO", "")
    if not raw:
        return None
    try:
        idx = int(raw)
    except ValueError:
        raise ValueError(
            f"TPQ_GATHER_TO={raw!r} is not a device index") from None
    devs = local_devices()
    if not 0 <= idx < len(devs):
        raise ValueError(
            f"TPQ_GATHER_TO={idx} out of range: this process has "
            f"{len(devs)} addressable devices")
    return devs[idx]


def resolve_out_sharding(mesh, out_sharding=None, gather_to=None,
                         env_default: bool = True):
    """Resolve a consumer placement into a ``torch.device`` (the one
    target of the gather) or None (the replicated gather).

    ``gather_to`` is a device (or its name) or an index into
    :func:`local_devices`; ``out_sharding`` is ``"replicated"`` (the
    explicit spelling of the replicated gather, overriding an armed
    default) or an already-resolved device.  With neither, the
    ``TPQ_GATHER_TO`` default applies (when ``env_default``), else
    replicated.  A sharding over a consumer mesh or a partition spec has
    no counterpart in the port yet and raises NotImplementedError."""
    if out_sharding is not None and gather_to is not None:
        raise ValueError("pass out_sharding= or gather_to=, not both "
                         "(they are two spellings of one placement)")
    if isinstance(out_sharding, str) and out_sharding == "replicated":
        return None
    if out_sharding is None and gather_to is None:
        if not env_default:
            return None
        gather_to = _gather_to_env()
        if gather_to is None:
            return None
    if gather_to is not None:
        if isinstance(gather_to, int) and not isinstance(gather_to, bool):
            devs = local_devices()
            if not 0 <= gather_to < len(devs):
                raise ValueError(
                    f"gather_to={gather_to} out of range: this process "
                    f"has {len(devs)} addressable devices")
            return devs[gather_to]
        return torch.device(gather_to)
    if isinstance(out_sharding, torch.device):
        return out_sharding
    if isinstance(out_sharding, str):
        raise ValueError(
            f"out_sharding must be a NamedSharding, a PartitionSpec, or "
            f"a Sharding, not {type(out_sharding).__name__}")
    raise NotImplementedError(
        f"out_sharding={out_sharding!r}: tpuparquet_torch places a gather "
        f"replicated or on one device (gather_to=); shardings over a "
        f"consumer mesh wait in ROADMAP A.9b")


def placement_devices(sharding) -> list:
    """The ordered device list of a resolved placement (one device)."""
    return [sharding]


def dim0_partitions(sharding) -> int:
    """How many ways a resolved placement splits the unit axis: a single
    device does not split it."""
    return 1


# ----------------------------------------------------------------------
# Batched hybrid plans
# ----------------------------------------------------------------------

class BatchedHybridPlan:
    """A stack of :class:`HybridPlan` padded to common static shapes (host
    numpy arrays, as the reference's).

    Shapes (U = padded unit count, R = run bucket, B = bp-word bucket):
    ``bp_words`` (U, B_blocks * width) flat per-unit rows, ``run_ends`` /
    ``run_is_rle`` / ``run_value`` / ``run_bp_start`` (U, R).  ``count``
    is the padded per-unit value count; ``counts`` the true ones."""

    __slots__ = ("bp_words", "run_ends", "run_is_rle", "run_value",
                 "run_bp_start", "count", "width", "n_bp", "counts",
                 "n_units")

    def __init__(self, bp_words, run_ends, run_is_rle, run_value,
                 run_bp_start, count, width, n_bp, counts, n_units):
        self.bp_words = bp_words
        self.run_ends = run_ends
        self.run_is_rle = run_is_rle
        self.run_value = run_value
        self.run_bp_start = run_bp_start
        self.count = count
        self.width = width
        self.n_bp = n_bp
        self.counts = counts
        self.n_units = n_units

    def arrays(self):
        return (self.bp_words, self.run_ends, self.run_is_rle,
                self.run_value, self.run_bp_start)


def stack_hybrid_plans(plans: list[HybridPlan], n_units: int | None = None,
                       count: int | None = None) -> BatchedHybridPlan:
    """Pad and stack host plans into one batch (see the class docstring).

    Extra runs repeat the final ``run_end`` (or the unit's count, if
    larger), so a right-side search never selects them for a real
    position; extra units are all-RLE zero plans; positions past a unit's
    true count land in its final run and are cut by ``counts``."""
    if not plans:
        raise ValueError("no plans to stack")
    width = max(p.width for p in plans)
    if any(p.width not in (width, 0) for p in plans):
        raise ValueError("mixed widths in one batch")
    true_n = len(plans)
    n_units = n_units or true_n
    R = bucket(max(len(p.run_ends) for p in plans))
    n_bp = bucket(max(p.n_bp_values for p in plans))
    count = count or bucket(max(p.count for p in plans))
    n_blocks = (n_bp + 31) // 32

    bp_words = np.zeros((n_units, n_blocks, max(width, 1)), dtype=np.uint32)
    run_ends = np.full((n_units, R), count, dtype=np.int32)
    run_is_rle = np.ones((n_units, R), dtype=bool)
    run_value = np.zeros((n_units, R), dtype=np.uint32)
    run_bp_start = np.zeros((n_units, R), dtype=np.int32)
    counts = np.zeros((n_units,), dtype=np.int32)

    for u, p in enumerate(plans):
        nb = p.bp_words.shape[0]
        bp_words[u, :nb, : p.bp_words.shape[1]] = p.bp_words
        nr = len(p.run_ends)
        run_ends[u, :nr] = p.run_ends
        run_ends[u, nr:] = max(int(p.run_ends[-1]), p.count) if nr else count
        run_is_rle[u, :nr] = p.run_is_rle
        run_value[u, :nr] = p.run_value
        run_bp_start[u, :nr] = p.run_bp_start
        counts[u] = p.count
    return BatchedHybridPlan(bp_words.reshape(n_units, -1), run_ends,
                             run_is_rle, run_value, run_bp_start, count,
                             width, n_bp, counts, true_n)


# ----------------------------------------------------------------------
# The SPMD step
# ----------------------------------------------------------------------

def _as_i32(a) -> torch.Tensor:
    """A host array (u32 bits become int32 bits) or tensor as a tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def decode_step_spmd(mesh: Mesh, count: int, width: int, n_bp: int,
                     lanes: int):
    """Build the SPMD decode step of one batch geometry:
    ``step(bp_words, run_ends, run_is_rle, run_value, run_bp_start,
    dictionary)`` over the batch's ``(U, ...)`` arrays (numpy or tensors)
    returns the ``(U, count, lanes)`` u32 values (int32 tensors) on each
    distinct device of the mesh, in slot order.

    Rg block r (units ``[r * U / rg, (r + 1) * U / rg)``) goes to every
    slot of mesh row r and the dictionary to every device; slot (r, s)
    expands positions ``[s * count / sp, (s + 1) * count / sp)`` of its
    block's units and looks them up (KS2, one launch a slot), writing its
    share of the output in place.  The all-gathers over sp and rg are the
    copies of each share to the other distinct devices."""
    sp = mesh.shape["sp"]
    n_rg = mesh.shape["rg"]
    if count % sp:
        raise ValueError(f"count={count} not divisible by sp={sp}")
    local = count // sp
    grid = mesh.devices
    dests = mesh.distinct_devices()

    def step(bw, re, rr, rv, rs, dictionary):
        host = [_as_i32(a) for a in (bw, re, rr, rv, rs)]
        U = host[1].shape[0]
        if U % n_rg:
            raise ValueError(f"{U} units do not divide over rg={n_rg}")
        u_loc = U // n_rg
        dict_h = _as_i32(dictionary)
        if dict_h.dim() != 2 or dict_h.shape[1] != lanes:
            raise ValueError(f"dictionary must be (D, {lanes})")
        outs = {d: torch.empty((U, count, lanes), dtype=torch.int32,
                               device=d) for d in dests}
        dicts = {d: dict_h.to(d) for d in dests}
        for r in range(n_rg):
            block = {}
            for s in range(sp):
                dev = grid[r, s]
                if dev not in block:
                    block[dev] = [a[r * u_loc : (r + 1) * u_loc].to(dev)
                                  .contiguous() for a in host]
                spmd_step_slot(*block[dev], dicts[dev], outs[dev],
                               r * u_loc, s * local, local, width, n_bp)
        for r in range(n_rg):
            for s in range(sp):
                src = grid[r, s]
                share = (slice(r * u_loc, (r + 1) * u_loc),
                         slice(s * local, (s + 1) * local))
                for d in dests:
                    if d != src:
                        outs[d][share].copy_(outs[src][share])
        return tuple(outs[d] for d in dests)

    return step


def sharded_dict_decode(mesh: Mesh, streams, counts, width: int,
                        dictionary: np.ndarray):
    """Sharded decode of many dictionary-index streams.

    ``streams``: raw hybrid-encoded index byte streams; ``counts``: their
    value counts; ``dictionary``: ``(D, lanes)`` u32.  Returns a list of
    ``(count_i, lanes)`` u32 numpy arrays, one a stream."""
    n_rg = mesh.shape["rg"]
    plans = [plan_hybrid(s, c, width) for s, c in zip(streams, counts)]
    n_units = max(len(plans), n_rg)
    n_units = ((n_units + n_rg - 1) // n_rg) * n_rg  # divisible by rg axis
    batch = stack_hybrid_plans(plans, n_units=n_units)
    count = batch.count
    sp = mesh.shape["sp"]
    if count % sp:
        count = int(math.ceil(count / sp) * sp)
        batch = stack_hybrid_plans(plans, n_units=n_units, count=count)
    dictionary = np.asarray(dictionary, dtype=np.uint32)
    step = decode_step_spmd(mesh, batch.count, batch.width, batch.n_bp,
                            dictionary.shape[1])
    out = step(*batch.arrays(), dictionary)[0].cpu().numpy().view(np.uint32)
    return [out[u, : batch.counts[u]] for u in range(batch.n_units)]
