"""Multi-file sharded scan and the gathers.

The port of ``tpuparquet/shard/scan.py``.  The scan unit is (file, row
group); units go round-robin over the mesh's slots and each decodes on
its slot's device through the read pipeline (:func:`pipelined_unit_scan`
over :func:`~tpuparquet_torch.kernels.device.pipelined_reads`: the
columns of the next units plan on a pool of workers while the calling
thread stages and launches the unit before).  Exchange between devices
happens only at :func:`gather_column` and :func:`gather_byte_column`:
each unit densifies straight into its row of its rg block (KS1, KS3),
and the block is copied to the mesh's other devices (replicated) or
permuted onto the target (KS4, ``gather_to=``); a target outside the
mesh (a sink device, such as the host beside a mesh of cards) takes
each unit's row straight (:func:`_assemble_direct`).

Quarantine, salvage, deadlines, hedged reads, filters and
durable checkpoints (ROADMAP A.7) and the telemetry (A.11) are not
ported: their arguments raise NotImplementedError.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..io.reader import FileReader
from ..kernels.decode import scatter_to_dense
from ..kernels.device import DeviceColumn, pipelined_reads
from ..kernels.gather import byte_densify, place_rows
from ..stats import current_stats
from .mesh import Mesh, make_mesh, resolve_out_sharding

__all__ = ["ShardedScan", "scan_units", "open_sources", "cursor_state",
           "cursor_load", "gather_column", "gather_byte_column",
           "pipelined_unit_scan"]

# ShardedScan arguments of the reference that wait for later slices:
# name -> (the values that ask for nothing, what waits and where)
_LATER = {
    "on_error": (("raise",), "on_error='quarantine' (ROADMAP A.7)"),
    "retries": ((None,), "retries (ROADMAP A.7)"),
    "salvage": ((False,), "salvage (ROADMAP A.7)"),
    "strict_metadata": ((None, False), "strict_metadata (ROADMAP A.7)"),
    "unit_deadline": ((None,), "deadlines (ROADMAP A.7)"),
    "scan_deadline": ((None,), "deadlines (ROADMAP A.7)"),
    "hedge_delay": ((None,), "hedged reads (ROADMAP A.7)"),
    "read_deadline": ((None,), "hedged reads (ROADMAP A.7)"),
    "resume_from": ((None,), "durable checkpoints (ROADMAP A.7)"),
    "checkpoint_every": ((None,), "durable checkpoints (ROADMAP A.7)"),
    "progress_export": ((None,), "progress telemetry (ROADMAP A.11)"),
    "progress_label": (("scan",), "progress telemetry (ROADMAP A.11)"),
    "postmortem": ((None,), "post-mortems (ROADMAP A.11)"),
    "filter": ((None,), "filter= (ROADMAP A.7)"),
}


def _refuse_later(kw: dict) -> None:
    for k, v in kw.items():
        if k not in _LATER:
            raise TypeError(
                f"ShardedScan() got an unexpected keyword argument {k!r}")
        if k == "on_error" and v not in ("raise", "quarantine"):
            raise ValueError(f"on_error must be 'raise' or 'quarantine', "
                             f"not {v!r}")
        accepted, what = _LATER[k]
        if not any(v is a or (type(v) is type(a) and v == a)
                   for a in accepted):
            raise NotImplementedError(
                f"{what} is not ported to tpuparquet_torch yet")


def scan_units(readers: list, filter=None) -> list[tuple[int, int]]:
    """Flatten files into ``(file_index, row_group_index)`` work units;
    ``None`` readers contribute none but keep the file indices."""
    if filter is not None:
        raise NotImplementedError(
            "filter= (ROADMAP A.7) is not ported to tpuparquet_torch yet")
    return [(fi, rgi) for fi, r in enumerate(readers) if r is not None
            for rgi in range(r.row_group_count())]


def open_sources(sources, columns, *, on_error: str = "raise") -> list:
    """Open each source (a path, bytes or a file object) with the
    ``columns`` projection; any failure propagates."""
    if on_error != "raise":
        _refuse_later({"on_error": on_error})
    readers = []
    for src in sources:
        if isinstance(src, (list, tuple)):
            raise NotImplementedError(
                "replica groups (hedged reads, ROADMAP A.7) are not "
                "ported to tpuparquet_torch yet")
        readers.append(FileReader(src, *columns))
    return readers


def cursor_state(units, next_key: str, next_value: int, **extra) -> dict:
    """Snapshot a JSON-serializable scan cursor (the reference's
    format)."""
    cur = {"version": 1, next_key: next_value,
           "units": [list(u) for u in units]}
    cur.update(extra)
    return cur


def cursor_load(cursor: dict, units, next_key: str, n_units: int,
                **expected) -> int:
    """Validate a cursor against this scan's shape; returns the resume
    position.  ``expected`` pins fields that must match exactly."""
    if cursor.get("version") != 1:
        raise ValueError(f"unknown cursor version {cursor.get('version')}")
    if [tuple(u) for u in cursor["units"]] != list(units):
        raise ValueError(
            "cursor does not match these sources: unit list differs "
            "(files changed since the cursor was taken?)"
        )
    for k, v in expected.items():
        if cursor.get(k) != v:
            raise ValueError(
                f"cursor {k} {cursor.get(k)!r} does not match this "
                f"run's {v!r}; resuming would misalign the unit "
                "assignment"
            )
    nxt = int(cursor[next_key])
    if not 0 <= nxt <= n_units:
        raise ValueError(f"cursor {next_key} {nxt} out of range")
    return nxt


def pipelined_unit_scan(readers, units, device_for=None, start: int = 0):
    """Yield ``(unit_index, {path: DeviceColumn})`` for ``units[start:]``
    (``(file, row group)`` pairs), unit k on ``device_for(k)``: the
    shared read pipeline of
    :func:`~tpuparquet_torch.kernels.device.pipelined_reads`."""
    yield from pipelined_reads(readers, units, device_for, start)


class ShardedScan:
    """Decode many files' row groups data-parallel across a mesh.

    ``sources`` are paths, bytes or file objects, opened by the scan;
    ``columns`` optionally project.  :meth:`run` decodes every unit on its
    round-robin slot's device and returns per-unit ``{path:
    DeviceColumn}`` dicts, which stay on their devices until gathered.
    The default mesh is :func:`~tpuparquet_torch.shard.mesh.make_mesh`
    over this process's cards; a CPU mesh (``make_mesh(n,
    devices=["cpu"] * n)``) runs every kernel's plain version.

    Resumable: :meth:`state` snapshots a JSON cursor between
    :meth:`run_iter` steps; ``resume=`` continues from it.  Epoch
    shuffling: ``shuffle_seed=`` and ``epoch=`` permute the unit list
    deterministically, as the reference does (the same order for the same
    seed and epoch), before the cursor exists.  ``gather_to=`` (a device
    or an index into the local cards; env default ``TPQ_GATHER_TO``) or
    ``out_sharding="replicated"`` set the default placement of the
    gathers."""

    def __init__(self, sources, *columns: str, mesh: Mesh | None = None,
                 resume=None, shuffle_seed: int | None = None,
                 epoch: int = 0, out_sharding=None, gather_to=None, **later):
        _refuse_later(later)
        self.mesh = mesh if mesh is not None else make_mesh()
        # a bad placement must fail before any source opens
        self.out_sharding = resolve_out_sharding(self.mesh, out_sharding,
                                                 gather_to)
        self.readers = open_sources(sources, columns)
        self.units = scan_units(self.readers)
        self.shuffle_seed = shuffle_seed
        self.epoch = int(epoch)
        if shuffle_seed is not None:
            import random

            # string-seeded Random hashes with sha512: the reference's
            # permutation, whatever PYTHONHASHSEED is
            random.Random(
                f"{int(shuffle_seed)}:{self.epoch}").shuffle(self.units)
        self.devices = list(self.mesh.devices.flat)
        self._next_unit = 0
        if resume is not None:
            self._load_cursor(resume)

    def _shuffle_identity(self) -> dict:
        if self.shuffle_seed is None:
            return {}
        return {"shuffle": [int(self.shuffle_seed), self.epoch]}

    def _load_cursor(self, cursor: dict) -> None:
        if cursor.get("quarantine"):
            raise NotImplementedError(
                "a cursor with quarantined units (ROADMAP A.7) cannot "
                "resume in tpuparquet_torch yet")
        self._next_unit = cursor_load(cursor, self.units, "next_unit",
                                      len(self.units),
                                      **self._shuffle_identity())

    def state(self) -> dict:
        """JSON-serializable cursor: resume with ``ShardedScan(sources,
        ..., resume=state)``; decoding restarts at the first unit not yet
        yielded."""
        return cursor_state(self.units, "next_unit", self._next_unit,
                            quarantine=[], **self._shuffle_identity())

    def device_for(self, unit_index: int) -> torch.device:
        return self.devices[unit_index % len(self.devices)]

    def run_iter(self):
        """Yield ``(unit_index, {path: DeviceColumn})`` from the cursor
        position through :func:`pipelined_unit_scan`, advancing the
        cursor past each unit as it is yielded."""
        for k, out in pipelined_unit_scan(self.readers, self.units,
                                          self.device_for,
                                          start=self._next_unit):
            self._next_unit = k + 1
            yield k, out

    def run(self) -> list[dict[str, DeviceColumn]]:
        """Decode ALL units (position i of the result is unit i); the
        cursor resets to the start first."""
        self._next_unit = 0
        return [out for _, out in self.run_iter()]

    def run_with_stats(self, events: bool = False):
        """:meth:`run` under a fresh collector: ``(results, stats)``."""
        from ..stats import collect_stats

        if events:
            raise NotImplementedError(
                "page event logs (ROADMAP A.11) are not ported to "
                "tpuparquet_torch yet")
        with collect_stats() as st:
            results = self.run()
        return results, st

    def _gather_placement(self, out_sharding, gather_to):
        """An explicit per-call placement wins; else the scan's default."""
        if out_sharding is not None or gather_to is not None:
            return resolve_out_sharding(self.mesh, out_sharding, gather_to)
        return self.out_sharding

    def gather_column(self, results, path: str, *, out_sharding=None,
                      gather_to=None):
        """:func:`gather_column` over this scan's mesh, with the scan's
        default placement."""
        return gather_column(
            self.mesh, results, path,
            out_sharding=self._gather_placement(out_sharding, gather_to))

    def gather_byte_column(self, results, path: str, *, out_sharding=None,
                           gather_to=None):
        """:func:`gather_byte_column` over this scan's mesh, with the
        scan's default placement."""
        return gather_byte_column(
            self.mesh, results, path,
            out_sharding=self._gather_placement(out_sharding, gather_to))

    def close(self):
        for r in self.readers:
            if r is not None:
                r.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()


# ----------------------------------------------------------------------
# Gathers
# ----------------------------------------------------------------------

def _shard_major(n_true: int, n_rg: int, sp: int):
    """The reference's shard-major assembly of ``n_true`` round-robin
    units on an (n_rg, sp) mesh: ``(U, blocks, perm)`` — the padded unit
    count ``max(ceil(n_true / n_dev) * n_dev, n_dev)``, each rg block's
    units (those placed on its sp slots) and each unit's assembly row."""
    n_dev = n_rg * sp
    U = max(((n_true + n_dev - 1) // n_dev) * n_dev, n_dev)
    rows_per_block = U // n_rg
    blocks = [[u for u in range(n_true)
               if r * sp <= (u % n_dev) < (r + 1) * sp]
              for r in range(n_rg)]
    perm = np.empty(n_true, dtype=np.int64)
    for r, mine in enumerate(blocks):
        perm[mine] = r * rows_per_block + np.arange(len(mine))
    return U, blocks, perm


def _count_gather(arrays, n_slots: int) -> None:
    """Meter one gather: what the destination slots received
    (``gather_bytes_moved``) and the share of it that is a copy beyond
    the first (``gather_bytes_replicated``); ``n_slots`` is 1 for a
    placed gather, the mesh's slot count for a replicated one."""
    st = current_stats()
    if st is None:
        return
    for a in arrays:
        nb = a.numel() * a.element_size()
        st.gather_bytes_moved += nb * n_slots
        st.gather_bytes_replicated += nb * (n_slots - 1)


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _assemble_and_gather(mesh: Mesh, n_true: int, streams, fill,
                         placement=None):
    """Assemble per-unit rows into ``(U, *row)`` globals and reshard them.

    ``streams`` is a list of ``(row_shape, dtype)``; ``fill(u, rows)``
    writes unit u's padded rows (one flat tensor a stream, on the unit's
    rg block device) in place.  Units are grouped shard-major, as in the
    reference: rg block r holds the units placed on its sp slots, on the
    device of its first slot; padding rows are zero.  Then, timed as
    ``gather_reshard_s``:

    * ``placement is None`` — each block is copied to every other
      distinct device of the mesh (the all-gather);
    * ``placement`` (a device of the mesh) — the blocks are copied to it
      and KS4 permutes the rows to unit order, rows past ``n_true`` zero;
    * ``placement`` outside the mesh (a sink device) — no global is
      built: each unit's row fills on its own slot's device, and only
      the copies of the rows to the sink are the reshard
      (:func:`_assemble_direct`).

    Returns ``(arrays, perm)``: replicated, ``arrays[i]`` is the global
    on the mesh's first device in assembly order and ``perm`` maps unit
    -> row; placed, ``arrays[i]`` is already in unit order."""
    n_rg, sp = mesh.shape["rg"], mesh.shape["sp"]
    if placement is not None and placement not in mesh.distinct_devices():
        if placement.type == "meta":
            raise ValueError(f"gather_to={placement}: a meta device holds "
                             "no data")
        slots = list(mesh.devices.flat)

        def unit_rows(u):
            rows = [torch.empty(tuple(shape), dtype=dtype,
                                device=slots[u % len(slots)])
                    for shape, dtype in streams]
            fill(u, [r.view(-1) for r in rows])
            return rows

        padded = [unit_rows(u) for u in range(n_true)]
        st = current_stats()
        _sync(dict.fromkeys(slots))
        t0 = time.perf_counter()
        out = _assemble_direct(
            placement, [([rows[i] for rows in padded], shape, dtype)
                        for i, (shape, dtype) in enumerate(streams)],
            n_true)
        _sync([placement])
        if st is not None:
            st.gather_reshard_s += time.perf_counter() - t0
        _count_gather(out, 1)
        return list(out), np.arange(n_true, dtype=np.int64)
    U, blocks, perm = _shard_major(n_true, n_rg, sp)
    rpb = U // n_rg
    homes = [mesh.devices[r, 0] for r in range(n_rg)]
    dests = (mesh.distinct_devices() if placement is None
             else list(dict.fromkeys(homes + [placement])))
    glob = {d: [torch.empty((U,) + tuple(shape), dtype=dtype, device=d)
                for shape, dtype in streams] for d in dests}
    for r, mine in enumerate(blocks):
        home = glob[homes[r]]
        for j, u in enumerate(mine):
            fill(u, [g[r * rpb + j].view(-1) for g in home])
        for g in home:
            g[r * rpb + len(mine) : (r + 1) * rpb] = 0
    st = current_stats()
    _sync(dests)
    t0 = time.perf_counter()
    targets = dests if placement is None else [placement]
    for r in range(n_rg):
        rows = slice(r * rpb, (r + 1) * rpb)
        for d in targets:
            if d != homes[r]:
                for g, src in zip(glob[d], glob[homes[r]]):
                    g[rows].copy_(src[rows])
    if placement is None:
        out = glob[dests[0]]
        n_slots = mesh.devices.size
    else:
        out = [place_rows(g, perm, n_true, max(n_true, 1))
               for g in glob[placement]]
        n_slots = 1
    _sync(targets)
    if st is not None:
        st.gather_reshard_s += time.perf_counter() - t0
    _count_gather(out, n_slots)
    return out, perm


def _assemble_direct(placement, streams, n_true: int):
    """Assembly onto a sink device outside the scan mesh: each unit's
    padded row is copied once to ``placement`` and stacked there in unit
    order; rows at or past ``n_true`` are zero (at least one row).  No
    permute runs and no global is built.  ``streams`` is a list of
    ``(rows, row_shape, dtype)``, ``rows[u]`` unit u's padded row on any
    device.  Returns one ``(max(n_true, 1), *row_shape)`` tensor a
    stream.

    A host sink fed from cards gets pinned memory, so each row's copy is
    one asynchronous DMA; the cards are synchronised once at the end."""
    u_out = max(n_true, 1)
    srcs = list(dict.fromkeys(r.device for rows, _, _ in streams
                              for r in rows[:n_true]))
    pin = placement.type == "cpu" and any(d.type == "cuda" for d in srcs)
    outs = []
    for rows, row_shape, dtype in streams:
        out = torch.empty((u_out,) + tuple(row_shape), dtype=dtype,
                          device=placement, pin_memory=pin)
        for u in range(n_true):
            out[u].copy_(rows[u].view(tuple(row_shape)), non_blocking=pin)
        out[n_true:] = 0
        outs.append(out)
    if pin:
        _sync(srcs)
    return tuple(outs)


def gather_column(mesh: Mesh, results: list, path: str, *,
                  out_sharding=None, gather_to=None):
    """Gather one fixed-width column across the mesh.

    Each unit's values densify straight into its row of its rg block
    (KS1: null slots 0, units padded to a common length L), then:

    * default — replicated: returns ``(values (U, L, lanes) u32 ndarray,
      per-unit true counts)``, the reference's contract;
    * ``gather_to=`` (a device, or an index into the local cards) — the
      column assembles on that device in unit order (KS4 on a device of
      the mesh; copies of each unit's row to a device outside it):
      returns ``(values, counts)`` with ``values`` a ``(U', L, lanes)``
      int32 tensor (u32 bits) on it, rows ``>= len(counts)`` zero.

    Metered as ``gather_bytes_moved`` / ``gather_bytes_replicated`` /
    ``gather_reshard_s``."""
    placement = resolve_out_sharding(mesh, out_sharding, gather_to,
                                     env_default=False)
    cols = [r[path] for r in results]
    if any(c.offsets is not None for c in cols):
        raise TypeError("gather_column handles fixed-width columns; "
                        "use gather_byte_column for BYTE_ARRAY")
    lanes = cols[0].lanes if cols else 1
    if any(c.lanes != lanes for c in cols):
        raise TypeError("gather_column units disagree on value width")
    counts = np.asarray([c.num_values for c in cols], dtype=np.int64)
    L = int(counts.max()) if len(counts) else 0

    def fill(u, rows):
        c = cols[u]
        dev = rows[0].device
        implicit = c._mask_p is None and c._pos_p is None
        scatter_to_dense(
            c.data.to(dev), None if implicit else c.mask.to(dev),
            None if implicit else c.positions.to(dev), lanes, out=rows[0])

    (gathered,), perm = _assemble_and_gather(
        mesh, len(cols), [((L * lanes,), torch.int32)], fill, placement)
    if placement is not None:
        return gathered.view(gathered.shape[0], L, lanes), counts
    out = gathered.cpu().numpy().view(np.uint32).reshape(
        gathered.shape[0], L, lanes)
    return out[perm], counts


def gather_byte_column(mesh: Mesh, results: list, path: str, *,
                       out_sharding=None, gather_to=None):
    """Gather one BYTE_ARRAY column across the mesh.

    Each unit densifies straight into its rows of its rg block (KS3):
    null slots become zero-length values, the offsets (per-unit relative,
    from 0) are edge-padded to Lmax + 1 with the unit's byte total, the
    bytes zero-padded to Bmax.  Placement as :func:`gather_column`.
    Returns ``(offsets (U, Lmax + 1) int32, data (U, Bmax) u8,
    row_counts, byte_counts)``: numpy arrays when replicated, tensors on
    the target (rows ``>= len(row_counts)`` zero) when placed.  Row i of
    unit u spans ``data[u, offsets[u, i]:offsets[u, i + 1]]``."""
    placement = resolve_out_sharding(mesh, out_sharding, gather_to,
                                     env_default=False)
    cols = [r[path] for r in results]
    if any(c.offsets is None for c in cols):
        raise TypeError("gather_byte_column handles BYTE_ARRAY columns; "
                        "use gather_column for fixed-width types")
    row_counts = np.asarray([c.num_values for c in cols], dtype=np.int64)
    byte_counts = np.asarray([c.n_bytes for c in cols], dtype=np.int64)
    L = int(row_counts.max()) + 1 if len(cols) else 1
    B = max(int(byte_counts.max()), 1) if len(cols) else 1

    def fill(u, rows):
        c = cols[u]
        dev = rows[0].device
        implicit = c.num_values == c.n_packed and c._mask_p is None
        byte_densify(c.offsets[: c.n_packed + 1].to(dev), c.n_packed,
                     None if implicit else c.mask.to(dev),
                     None if implicit else c.positions.to(dev),
                     c.data.to(dev), rows[0], rows[1])

    (o_g, d_g), perm = _assemble_and_gather(
        mesh, len(cols), [((L,), torch.int32), ((B,), torch.uint8)], fill,
        placement)
    if placement is not None:
        return o_g, d_g, row_counts, byte_counts
    return (o_g.cpu().numpy()[perm], d_g.cpu().numpy()[perm], row_counts,
            byte_counts)
