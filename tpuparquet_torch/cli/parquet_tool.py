"""parquet_tool: inspect, verify, profile, serve and split Parquet files.

Subcommands: ``cat`` and ``head`` (records, through the row API),
``meta`` (the flat schema with its levels, each chunk's statistics and
index flags; ``--strict`` adds the metadata validator's findings and
exits non-zero on an error), ``schema``, ``rowcount``, ``split`` (rows
into files of a target size), ``verify`` (each row group decoded on the
host and on the device, compared bit for bit), ``profile`` (the
per-column transport and timing table, with ``--json``, ``--events``,
``--perfetto`` and ``--from-events``), ``top`` (the live view of a
scan's progress file), ``watch`` (the RED view of a time-series ring),
``slo report``, ``serve`` (a :class:`~tpuparquet_torch.serve.ScanServer`
from a JSON spec), ``tenants`` (a server's status export), ``flame``
(a sampling profile), ``doctor`` (a scan trace's bound stage),
``rescue`` (a torn file's recoverable row groups into a clean file) and
``compact`` (a partitioned dataset's small files merged through its
atomic manifest commit, ``dataset/compact.py``).

``verify``, ``profile`` and ``serve`` decode on ``--device`` (default
``cuda``, the current card; ``cpu`` runs every kernel's plain version):
``serve`` hands it to its scans as a one-device mesh.

Run as ``python -m tpuparquet_torch.cli.parquet_tool <cmd> <file>``.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..io.reader import FileReader
from ..io.writer import FileWriter
from . import CODECS as _CODECS

# size suffixes of --file-size and --row-group-size, in their usual
# meaning (KB=1000, KiB=1024)
_SUFFIX = {
    "KB": 1000, "KiB": 1024,
    "MB": 1000**2, "MiB": 1024**2,
    "GB": 1000**3, "GiB": 1024**3,
    "TB": 1000**4, "TiB": 1024**4,
    "PB": 1000**5, "PiB": 1024**5,
}


def human_to_bytes(s: str) -> int:
    s = s.strip()
    try:
        return int(s)
    except ValueError:
        pass
    for suf, mult in _SUFFIX.items():
        if s.endswith(suf):
            return int(s[: -len(suf)].strip()) * mult
    raise ValueError(f"invalid size {s!r}")


# ----------------------------------------------------------------------
# Row printing: flat "name = value" lines, nested groups as "name:" with
# dot-prefixed children
# ----------------------------------------------------------------------

def _print_value(out, indent: str, name: str, v) -> None:
    if isinstance(v, dict):
        print(f"{indent}{name}:", file=out)
        _print_row(out, v, indent + ".")
    elif isinstance(v, (list, tuple)):
        for item in v:
            if isinstance(item, dict):
                print(f"{indent}{name}:", file=out)
                _print_row(out, item, indent + ".")
            else:
                _print_value(out, indent, name, item)
    elif isinstance(v, bytes):
        print(f"{indent}{name} = {v.decode('utf-8', 'replace')}", file=out)
    else:
        print(f"{indent}{name} = {v}", file=out)


def _print_row(out, row: dict, indent: str = "") -> None:
    for name, v in row.items():
        _print_value(out, indent, name, v)


def cmd_cat(args, out=None) -> int:
    out = out or sys.stdout
    return _cat(args.file, -1, out, trace=getattr(args, "trace", False))


def cmd_head(args, out=None) -> int:
    out = out or sys.stdout
    return _cat(args.file, args.n, out,
                trace=getattr(args, "trace", False))


def _cat(path: str, n: int, out, trace: bool = False) -> int:
    import contextlib

    from ..stats import collect_stats

    ctx = collect_stats() if trace else contextlib.nullcontext()
    with ctx as st, FileReader(path) as r:
        for i, row in enumerate(r.rows()):
            if n != -1 and i >= n:
                break
            _print_row(out, row)
            print(file=out)
    if trace and st is not None:
        print(st.summary(), file=sys.stderr)
    return 0


def _fmt_stat(v, limit: int = 24) -> str:
    if isinstance(v, bytes):
        s = repr(v.decode("utf-8", "replace"))
    else:
        s = repr(v)
    return s if len(s) <= limit else s[: limit - 2] + ".."


def _chunk_extras(r, cc) -> str:
    """Per-chunk Statistics (decoded to LOGICAL values) + pruning-index
    presence flags for ``meta`` — the operator's view of what predicate
    pushdown has to work with."""
    from ..io.values import handler_for

    cm = cc.meta_data
    bits = []
    st = cm.statistics
    if st is not None:
        node = r.schema.leaf(".".join(cm.path_in_schema))
        if node is not None and (st.min_value is not None
                                 or st.max_value is not None):
            h = handler_for(node.element)
            try:
                mn = (h.decode_stat_logical(st.min_value)
                      if st.min_value is not None else None)
                mx = (h.decode_stat_logical(st.max_value)
                      if st.max_value is not None else None)
                bits.append(f"stats=[{_fmt_stat(mn)} .. {_fmt_stat(mx)}]")
            except (ValueError, TypeError):
                bits.append("stats=<undecodable>")
        if st.null_count is not None:
            bits.append(f"nulls={st.null_count}")
    idx = []
    if cc.column_index_offset is not None:
        idx.append("column")
    if cc.offset_index_offset is not None:
        idx.append("offset")
    if idx:
        bits.append(f"page-index={'+'.join(idx)}")
    if cm.bloom_filter_offset is not None:
        bits.append("bloom=yes")
    return ("  " + "  ".join(bits)) if bits else ""


def cmd_meta(args, out=None) -> int:
    """Flat schema with repetition + R/D levels,
    per-chunk statistics decoded to logical values, and page-index /
    bloom presence flags; ``--strict`` additionally runs the metadata
    validator (``format/validate.py``) and exits nonzero on error
    findings."""
    out = out or sys.stdout
    rc = 0
    with FileReader(args.file) as r:
        _print_flat(out, r.schema.root, 0)
        print(file=out)
        meta = r.metadata()
        print(f"rows: {meta.num_rows}  row groups: "
              f"{len(meta.row_groups)}  created by: {meta.created_by}",
              file=out)
        for i, rg in enumerate(meta.row_groups):
            print(f"row group {i}: {rg.num_rows} rows, "
                  f"{rg.total_byte_size} bytes", file=out)
            for cc in rg.columns:
                cm = cc.meta_data
                print(f"  {'.'.join(cm.path_in_schema)}: "
                      f"{cm.type.name} {cm.codec.name} "
                      f"values={cm.num_values} "
                      f"compressed={cm.total_compressed_size} "
                      f"uncompressed={cm.total_uncompressed_size}"
                      + _chunk_extras(r, cc),
                      file=out)
        if getattr(args, "strict", False):
            rc = _report_findings(r, args.file, out)
    return rc


def _report_findings(r, path: str, out) -> int:
    """Run strict metadata validation on an open reader; print findings;
    return 1 when any is an error."""
    from ..format.validate import validate_metadata

    findings = validate_metadata(r.metadata(), os.path.getsize(path))
    for fd in findings:
        print(f"  {fd}", file=out)
    errors = sum(1 for fd in findings if fd.is_error)
    if errors:
        print(f"metadata: {errors} error finding(s), "
              f"{len(findings) - errors} warning(s)", file=out)
        return 1
    print("metadata: strict validation passed"
          + (f" ({len(findings)} warning(s))" if findings else ""),
          file=out)
    return 0


def _print_flat(out, node, lvl: int) -> None:
    dot = "." * lvl
    for child in node.children:
        rep = child.repetition_type.name if child.repetition_type is not None else "?"
        if child.is_leaf:
            print(f"{dot}{child.name}:\t\t{rep} {child.type.name} "
                  f"R:{child.max_rep_level} D:{child.max_def_level}",
                  file=out)
        else:
            print(f"{dot}{child.name}:\t\t{rep} F:{len(child.children)}",
                  file=out)
            _print_flat(out, child, lvl + 1)


def cmd_schema(args, out=None) -> int:
    out = out or sys.stdout
    with FileReader(args.file) as r:
        print(r.get_schema_definition(), file=out)
    return 0


def cmd_rowcount(args, out=None) -> int:
    out = out or sys.stdout
    with FileReader(args.file) as r:
        print(f"Total RowCount: {r.num_rows}", file=out)
    return 0


def cmd_verify(args, out=None) -> int:
    """Decode every row group on BOTH paths (CPU oracle and device
    kernels) and compare bit-exactly — the file doctor for the decode
    backend.  ``--device`` picks the device path's device."""
    import time

    import numpy as np

    out = out or sys.stdout
    from ..cpu.plain import ByteArrayColumn
    from ..kernels.device import read_row_group_device

    device = getattr(args, "device", "cuda")
    rc = 0
    with FileReader(args.file) as r:
        # metadata first: a footer that fails strict validation makes
        # the decode comparison below meaningless (and possibly a crash)
        if _report_findings(r, args.file, out):
            print("verify: METADATA INVALID", file=out)
            return 1
        for rg in range(r.row_group_count()):
            t0 = time.perf_counter()
            cpu = r.read_row_group_arrays(rg)
            t1 = time.perf_counter()
            # read_row_group_device syncs once before it returns: no
            # sync a column is needed
            dev = read_row_group_device(r, rg, device=device)
            t2 = time.perf_counter()
            n = sum(len(cd.def_levels) for cd in cpu.values())
            bad = []
            for path, cd in cpu.items():
                vals, rep, dl = dev[path].to_numpy()
                ok = (np.array_equal(rep, cd.rep_levels)
                      and np.array_equal(dl, cd.def_levels))
                if ok:
                    if isinstance(cd.values, ByteArrayColumn):
                        ok = vals == cd.values
                    else:
                        # bitwise, not value, comparison: NaN payloads
                        # must compare equal for a bit-exact check
                        a = np.ascontiguousarray(np.asarray(vals))
                        b = np.ascontiguousarray(np.asarray(cd.values))
                        ok = (a.shape == b.shape and a.dtype == b.dtype
                              and a.tobytes() == b.tobytes())
                if not ok:
                    bad.append(path)
            status = "OK" if not bad else f"MISMATCH: {', '.join(bad)}"
            print(f"row group {rg}: {n:,} values  "
                  f"cpu {(t1 - t0) * 1e3:.1f}ms  "
                  f"device {(t2 - t1) * 1e3:.1f}ms  {status}", file=out)
            if bad:
                rc = 1
    print("verify: " + ("all row groups bit-exact" if rc == 0
                        else "MISMATCHES FOUND"), file=out)
    return rc


def profile_report(events, stats=None) -> dict:
    """Machine-readable profile digest: everything the human table
    prints, as one JSON-safe dict.  ``stats`` optional — a profile
    rebuilt from a saved ``pages.jsonl`` has events only, so the
    counter/histogram sections derive from the events where they can
    and are omitted where they can't."""
    from .. import obs

    rep: dict = {
        "columns": obs.column_table(events),
        "transport_counts": events.transport_counts(),
        "event_summary": obs.event_summary(events),
        "plan_cache_spans": obs.plan_cache_span_counts(events),
        "fault_tallies": obs.fault_counts_by_column(events),
        "faults": len(events.faults),
    }
    # phase walls: exact from the collector when present, else the
    # span sums (the same numbers, minus wall_s which only a live
    # collector can know)
    if stats is not None:
        d = stats.as_dict()
        rep["counters"] = d
        rep["histograms"] = stats.histograms_dict()
        rep["phases"] = {k: d[k] for k in
                         ("plan_s", "transfer_s", "dispatch_s",
                          "wall_s")}
        # attribution view: per-stage cpu-seconds derived by the SAME
        # function the scan ledgers/doctor use (obs.stage_seconds), so
        # profile, top and doctor agree on numbers by construction
        rep["attribution"] = {
            "cpu_s": obs.stage_seconds(d),
            "bytes": {"read": d.get("bytes_read", 0),
                      "staged": d.get("bytes_staged", 0),
                      "moved": d.get("gather_bytes_moved", 0)},
        }
    else:
        phases: dict = {}
        for s in events.spans:
            key = {"plan": "plan_s", "transfer": "transfer_s",
                   "dispatch": "dispatch_s"}.get(s.get("name"))
            if key:
                phases[key] = round(phases.get(key, 0.0) + s["dur"], 6)
        rep["phases"] = phases
    return rep


def cmd_profile(args, out=None) -> int:
    """Decode with full telemetry on and print the per-column
    transport/timing table: which wire transport each column's pages
    took, WHY the gate chose it (the competition's wire-size numbers),
    and where the host wall went.  Optional dumps: ``--events`` writes
    the raw per-page JSON-lines log, ``--perfetto`` a Chrome-trace
    JSON of the host phase spans (load at ui.perfetto.dev),
    ``--json`` the whole digest as machine-readable JSON.
    ``--from-events pages.jsonl`` analyzes a SAVED event log instead
    of re-running the decode (no file argument needed).  The device
    path decodes on ``--device``."""
    out = out or sys.stdout
    from .. import obs
    from ..stats import collect_stats

    from ..obs import trace as _trace

    saved = getattr(args, "from_events", None)
    device = getattr(args, "device", "cuda")
    troot = None
    if saved:
        if args.file:
            raise ValueError(
                "profile --from-events analyzes the saved log; drop "
                "the file argument (or drop --from-events to re-run)")
        log = obs.load_jsonl(saved)
        st = None
    elif not args.file:
        raise ValueError("profile needs a parquet file "
                         "(or --from-events pages.jsonl)")
    else:
        mirrors = [m for m in (getattr(args, "mirror", None) or []) if m]
        filt = None
        if getattr(args, "filter", None):
            from ..filter import parse_filter

            filt = parse_filter(args.filter)
        with FileReader(args.file, mirrors=mirrors) as r:
            # with TPQ_TRACE on, the profiled decode runs as its own
            # trace so the TRACE section below can walk its span tree
            with _trace.trace_scope("profile") as troot, \
                    collect_stats(events=True) as st:
                if filt is not None:
                    # predicate-pushdown profile: the pruning section
                    # below shows what the filter statically skipped
                    from ..kernels.device import read_row_group_device

                    for rg in range(r.row_group_count()):
                        if getattr(args, "cpu", False):
                            r.read_row_group_arrays(rg, filter=filt)
                        else:
                            cols = read_row_group_device(
                                r, rg, device=device, filter=filt)
                            for c in cols.values():
                                c.block_until_ready()
                elif getattr(args, "cpu", False):
                    for rg in range(r.row_group_count()):
                        r.read_row_group_arrays(rg)
                else:
                    from ..kernels.device import read_row_groups_device

                    for _rg, cols in read_row_groups_device(
                            r, device=device):
                        for c in cols.values():
                            c.block_until_ready()
        log = st.events
    # causal-trace section (TPQ_TRACE=1): the doctor's critical-path
    # walk over the profiled decode — per-stage share + bound verdict
    trace_diag = None
    if troot is not None and _trace._active is not None:
        from ..obs.attribution import diagnose

        trace_diag = diagnose(
            _trace._active.snapshot(troot["trace"]))
    if getattr(args, "json", False):
        import json as _json

        rep = profile_report(log, st)
        rep["file"] = args.file or saved
        if trace_diag is not None:
            rep["trace"] = {k: trace_diag[k] for k in
                            ("verdict", "bound_stage", "verdict_share",
                             "stage_share", "stages_s", "coverage",
                             "wall_s", "units")}
        _json.dump(rep, out, sort_keys=True, default=str)
        print(file=out)
        # stdout is now a JSON document consumers parse whole: the
        # dump status lines must not corrupt it
        status = sys.stderr
    else:
        _print_profile(log, st, out, trace_diag)
        status = out
    if getattr(args, "events", None):
        log.write_jsonl(args.events)
        print(f"wrote page events to {args.events}", file=status)
    if getattr(args, "perfetto", None):
        obs.write_chrome_trace(log, args.perfetto)
        print(f"wrote Perfetto trace to {args.perfetto}", file=status)
    return 0


def _print_profile(log, st, out, trace_diag=None) -> None:
    """The human rendering of a profile (live collector or saved
    events)."""
    from .. import obs

    print(obs.format_column_table(obs.column_table(log)), file=out)
    if st is not None:
        d = st.as_dict()
        print(f"\nphases: plan {d['plan_s']:.3f}s  "
              f"transfer {d['transfer_s']:.3f}s  "
              f"dispatch {d['dispatch_s']:.3f}s  "
              f"wall {d['wall_s']:.3f}s",
              file=out)
        # attribution section: the stage cpu_s view shared with the
        # scan ledgers / doctor (obs.stage_seconds)
        cpu = obs.stage_seconds(d)
        if any(cpu.values()):
            print("attribution: "
                  + "  ".join(f"{k} {v:.3f}s"
                              for k, v in cpu.items() if v)
                  + f"  read {d['bytes_read']:,}B", file=out)
        if trace_diag is not None and trace_diag.get("bound_stage"):
            print(f"trace: {trace_diag['verdict']} — "
                  f"{trace_diag['bound_stage']} is "
                  f"{100 * trace_diag['verdict_share']:.1f}% of the "
                  f"traced wall "
                  f"(coverage {100 * trace_diag['coverage']:.1f}%)",
                  file=out)
        # footer-keyed plan cache effectiveness (TPQ_PLAN_CACHE_MB):
        # per-span verdicts localize WHICH column plans hit
        cache_spans = obs.plan_cache_span_counts(log)
        if d["plan_cache_hits"] or d["plan_cache_misses"]:
            print(f"plan cache: {d['plan_cache_hits']} hits  "
                  f"{d['plan_cache_misses']} misses  "
                  f"{d['plan_cache_evictions']} evictions  "
                  f"(spans: {cache_spans})", file=out)
        # gather/output-placement section: what the reshard to the
        # consumer placement actually shipped (shard/scan.py gathers)
        if d["gather_bytes_moved"] or d["gather_reshard_s"]:
            print(f"gather: {d['gather_bytes_moved']:,}B to consumers  "
                  f"{d['gather_bytes_replicated']:,}B replication  "
                  f"reshard {d['gather_reshard_s']:.3f}s", file=out)
        # write-pipeline section (io/pages.py native page assembly):
        # how many pages this scope wrote, how many took the native
        # one-pass path, and where the write wall went
        if d["pages_written"]:
            print(f"write: {d['pages_written']} pages "
                  f"({d['pages_assembled_native']} native)  "
                  f"encode {d['write_encode_s']:.3f}s  "
                  f"compress {d['write_compress_s']:.3f}s  "
                  f"assemble {d['write_assemble_s']:.3f}s", file=out)
        # remote-source section (io/source.py byte-range backends):
        # round trips actually issued vs saved by coalescing, and the
        # tiered range cache's hit economics (io/rangecache.py)
        if (d["remote_ranges_fetched"] or d["cache_hits_mem"]
                or d["cache_hits_disk"] or d["cache_misses_mem"]
                or d["cache_misses_disk"]):
            print(f"remote: {d['remote_ranges_fetched']} ranges fetched "
                  f"({d['ranges_coalesced']} coalesced away)  "
                  f"{d['remote_bytes']:,}B  "
                  f"{d['remote_retry']} retries", file=out)
            print(f"range cache: mem {d['cache_hits_mem']}h/"
                  f"{d['cache_misses_mem']}m/"
                  f"{d['cache_evictions_mem']}e  "
                  f"disk {d['cache_hits_disk']}h/"
                  f"{d['cache_misses_disk']}m/"
                  f"{d['cache_evictions_disk']}e", file=out)
        # predicate-pushdown section: what the filter statically skipped
        # and what the exact pass kept (filter.py)
        if (d["row_groups_pruned"] or d["pages_pruned"]
                or d["rows_pruned"] or d["bloom_hits"]
                or d["filter_rows_in"]):
            sel = (f"  selectivity {d['selectivity']:.4f}"
                   if d.get("selectivity") is not None else "")
            print(f"pruning: {d['row_groups_pruned']} row groups  "
                  f"{d['pages_pruned']} pages  "
                  f"{d['rows_pruned']:,} rows skipped  "
                  f"{d['bloom_hits']} bloom hits  "
                  f"exact {d['filter_rows_out']:,}/"
                  f"{d['filter_rows_in']:,} rows{sel}", file=out)
        print(st.summary(), file=out)
    # per-column time-domain tallies: which column's reads hedged /
    # expired (global counts alone can't localize a degraded replica)
    tally = obs.fault_counts_by_column(log)
    if tally:
        print("\nhedges/deadlines per column:", file=out)
        for col in sorted(tally):
            row = tally[col]
            print(f"  {col}: "
                  f"hedges issued {row.get('hedge_issued', 0)}, "
                  f"won {row.get('hedge_won', 0)}, "
                  f"deadlines exceeded "
                  f"{row.get('deadline_exceeded', 0)}", file=out)
    h = None if st is None else st.hists.get("page_comp_bytes")
    if h is not None and h.n:
        print(f"compressed page size: p50 < {h.quantile(0.5):,}B, "
              f"p99 < {h.quantile(0.99):,}B over {h.n} pages", file=out)


def _fmt_eta(s) -> str:
    if s is None:
        return "-"
    s = int(s)
    if s >= 3600:
        return f"{s // 3600}h{(s % 3600) // 60:02d}m"
    if s >= 60:
        return f"{s // 60}m{s % 60:02d}s"
    return f"{s}s"


def render_top_frame(frames: list[dict], width: int = 40) -> str:
    """One ``top`` screen for one or more scan status frames (a
    multi-host scan exports one file per host)."""
    lines = []
    for f in frames:
        done, total = f["units_done"], f["units_total"]
        frac = done / total if total else 1.0
        filled = int(frac * width)
        bar = "#" * filled + "-" * (width - filled)
        lines.append(
            f"{f.get('label', 'scan')} [{bar}] "
            f"{done}/{total} units ({frac * 100:.1f}%)  "
            f"state={f['state']}")
        lines.append(
            f"  rows {f['rows_done']:,} @ {f['rows_per_s']:,.0f}/s  "
            f"elapsed {f['elapsed_s']:.1f}s  "
            f"eta {_fmt_eta(f.get('eta_s'))}  "
            f"inflight {f.get('units_inflight', 0)}"
            + (f"  QUARANTINED {f['units_quarantined']}"
               if f.get("units_quarantined") else "")
            + (f"  staged {f['bytes_staged']:,}B"
               if f.get("bytes_staged") else ""))
        attr = f.get("attribution")
        if attr and attr.get("cpu_s"):
            cpu = "  ".join(f"{k} {v:.2f}s"
                            for k, v in attr["cpu_s"].items() if v)
            by = attr.get("bytes") or {}
            lines.append(
                "  cpu: " + (cpu or "-")
                + (f"  read {by['read']:,}B" if by.get("read") else "")
                + (f"  peak_arena {attr['peak_arena_bytes']:,}B"
                   if attr.get("peak_arena_bytes") else ""))
        prof = f.get("profile")
        if prof and prof.get("samples"):
            lines.append(
                "  PROFILE "
                f"{prof['samples']} samples "
                f"@ {prof.get('rate_hz') or 0:.0f}/s  "
                f"off-cpu {(prof.get('offcpu_share') or 0) * 100:.0f}%"
                f"  top {prof.get('top_frame') or '-'}")
        if f.get("_stale_s") is not None:
            lines.append(
                f"  STALE: no update for {f['_stale_s']:.0f}s "
                f"(writer pid {f.get('pid', '?')} dead or hung? "
                "the cursor, if any, is resumable)")
        for s in f.get("stragglers") or []:
            lines.append(
                f"  STRAGGLER unit {s['unit']}: "
                f"{s['elapsed_s']}s in flight "
                f"(p95 {s['p95_s']}s)")
    return "\n".join(lines)


def cmd_top(args, out=None) -> int:
    """Live view of running scans: tail the JSON status file(s) a
    ``ShardedScan``/``MultiHostScan`` exports (``progress_export=`` /
    ``TPQ_PROGRESS_EXPORT``) and render progress bars, rates, ETA and
    stragglers, refreshing until every scan leaves the running state.
    ``--once`` prints a single frame and exits (scripts/tests)."""
    import time as _time

    from ..obs.progress import read_progress_file

    out = out or sys.stdout
    interval = max(getattr(args, "interval", 1.0), 0.05)
    once = getattr(args, "once", False)
    while True:
        frames = []
        missing = []
        dead_files = []
        for path in args.status:
            try:
                f = read_progress_file(path)
            except (OSError, ValueError):
                missing.append(path)
                continue
            # a "running" frame whose writer went silent well past its
            # own unit cadence is flagged STALE — a SIGKILLed scan
            # never writes its "done"/"error" frame, and a frozen bar
            # with no indication would lie to the operator.  Frames
            # export at unit boundaries (start AND done), so the
            # tolerance scales with the frame's own EWMA unit wall: a
            # scan of 30s units is not "stale" 10s into a unit.
            age = _time.time() - f.get("ts", 0)
            stale_after = max(10.0, 5.0 * interval,
                              10.0 * (f.get("ewma_unit_s") or 0.0))
            if f.get("state") == "running" and age > stale_after:
                f["_stale_s"] = age
            # the harder verdict keys on the FILE's mtime, not the
            # frame's ts (a restored backup carries an old ts with a
            # fresh mtime; only the mtime says whether any writer is
            # alive): a running frame whose file hasn't been touched
            # for 2x its write interval means the writer is gone, and
            # --once must not hand a script old numbers with rc 0
            if f.get("state") == "running":
                try:
                    m_age = _time.time() - os.path.getmtime(path)
                except OSError:
                    m_age = None
                write_iv = max(f.get("ewma_unit_s") or 0.0,
                               5.0, interval)
                if m_age is not None and m_age > 2.0 * write_iv:
                    dead_files.append((path, m_age))
                    f["_stale_s"] = max(f.get("_stale_s") or 0.0,
                                        m_age)
            frames.append(f)
        if frames:
            print(render_top_frame(frames), file=out)
        for path in missing:
            print(f"(waiting for {path})", file=out)
        if once:
            if dead_files:
                for path, m_age in dead_files:
                    print(f"parquet-tool top: {path} is stale "
                          f"(not written for {m_age:.0f}s, > 2x its "
                          f"write interval) — the scan is likely "
                          f"dead; numbers above are old",
                          file=sys.stderr)
                return 1
            return 0 if frames else 1
        if frames and not missing and \
                all(f["state"] != "running" for f in frames):
            return 0
        _time.sleep(interval)
        print(file=out)


def render_watch(frames: list[dict], objectives: list[dict],
                 alerts: list[dict], now: float) -> str:
    """One ``watch`` screen: the RED view (rate / errors / duration)
    per scan label over the fast window, error-budget state per
    objective, and whatever is firing."""
    from ..obs.slo import (
        DEFAULT_FAST_WINDOW_S,
        evaluate,
        window_digest,
        window_ledger,
    )

    lines = []
    if not frames:
        return "(no frames in ring)"
    last = frames[-1]
    labels = sorted(set(last.get("ledgers") or {})
                    | set(last.get("digests") or {}))
    w = DEFAULT_FAST_WINDOW_S
    lines.append(f"RED over last {w:g}s "
                 f"({len(frames)} frames in ring)")
    for label in labels:
        if label == "deadline":
            continue  # expiry-site digests, not a scan label
        led = window_ledger(frames, label, w, now)
        attempts = led.get("row_groups", 0) \
            + led.get("units_quarantined", 0)
        errors = led.get("units_quarantined", 0) \
            + led.get("deadline_exceeded", 0)
        dig = window_digest(frames, label, "unit", w, now)
        dur = ("-" if not dig.n
               else f"p50 {dig.quantile(0.5) / 1000.0:.0f}ms / "
                    f"p99 {dig.quantile(0.99) / 1000.0:.0f}ms")
        lines.append(
            f"  {label}: rate {attempts / w:.2f} units/s  "
            f"errors {errors}"
            + (f" ({errors / attempts * 100.0:.2f}%)" if attempts
               else "")
            + f"  duration {dur}")
    # one-line PROFILE section when a sampler is armed: the sampler
    # mirrors its counters/gauges into the registry, so they ride the
    # same ring frames the RED view reads — stable under --once
    if (last.get("counters") or {}).get("profile_samples"):
        c = last["counters"]
        g = last.get("gauges") or {}
        share = g.get("profile_offcpu_share")
        if share is None and c["profile_samples"]:
            share = (c.get("profile_samples_offcpu", 0)
                     / c["profile_samples"])
        lines.append(
            f"  PROFILE {c['profile_samples']} samples "
            f"@ {g.get('profile_rate_hz') or 0:.0f}/s  "
            f"off-cpu {(share or 0) * 100:.0f}%  "
            f"top {g.get('profile_top_frame') or '-'}"
            + (f"  drops {c['profile_drops']}"
               if c.get("profile_drops") else ""))
    if objectives:
        report = evaluate(frames, objectives, now)
        for row in report["objectives"]:
            b = row.get("budget")
            if b is None:
                continue
            burn = row.get("burn") or {}
            f_burn = burn.get("fast")
            lines.append(
                f"  budget {row['label']}: "
                f"{b['remaining_fraction'] * 100.0:.1f}% remaining"
                + (f"  burn {f_burn:.1f}x" if f_burn is not None
                   else ""))
    for a in alerts:
        label = f" label={a['label']}" if a.get("label") else ""
        lines.append(f"  FIRING [{a.get('severity', 'page')}] "
                     f"{a['name']}{label}: {a.get('msg', '')}")
    return "\n".join(lines)


def cmd_watch(args, out=None) -> int:
    """Live RED view over a time-series ring (``TPQ_TIMESERIES_DIR``):
    per-label rate/errors/duration, error-budget remaining per SLO
    objective, and firing alerts — the one screen an operator tails
    during an incident.  ``--once`` renders a single screen and exits
    (nonzero when the ring is empty)."""
    import time as _time

    from ..obs.alerts import AlertEngine, default_rules
    from ..obs.slo import load_objectives
    from ..obs.timeseries import load_ring

    out = out or sys.stdout
    interval = max(getattr(args, "interval", 2.0), 0.05)
    objectives = load_objectives(args.slo or None)
    engine = AlertEngine(default_rules(objectives), record_path="")
    while True:
        frames = load_ring(args.ring)
        now = _time.time()
        alerts = engine.evaluate(frames, now) if frames else []
        print(render_watch(frames, objectives, alerts, now), file=out)
        if getattr(args, "once", False):
            return 0 if frames else 1
        _time.sleep(interval)
        print(file=out)


def cmd_slo(args, out=None) -> int:
    """Evaluate SLO objectives over a saved time-series ring and
    print the report (error budgets, burn rates, latency verdicts).
    ``report`` is the only action today.  Exits nonzero when any
    objective is in violation — scriptable as a release gate."""
    import json as _json

    from ..obs.slo import evaluate, format_report, load_objectives
    from ..obs.timeseries import load_ring

    out = out or sys.stdout
    if args.action != "report":
        raise ValueError(f"unknown slo action {args.action!r} "
                         f"(expected 'report')")
    objectives = load_objectives(args.slo or None)
    if not objectives:
        raise ValueError("no SLO objectives: pass --slo FILE or set "
                         "TPQ_SLO_FILE")
    frames = load_ring(args.ring)
    report = evaluate(frames, objectives)
    if getattr(args, "json", False):
        print(_json.dumps(report, sort_keys=True), file=out)
    else:
        print(format_report(report), file=out)
    violated = any(
        (row.get("latency") or {}).get("ok") is False
        or (row.get("errors") or {}).get("ok") is False
        for row in report["objectives"])
    return 2 if violated else 0


def _mesh_for(device: str):
    """The mesh of ``serve``'s scans on ``device``: None (the scans'
    default, this process's cards) for ``cuda``, else a one-slot mesh."""
    if device == "cuda":
        return None
    from ..shard.mesh import make_mesh

    return make_mesh(1, devices=[device])


def cmd_serve(args, out=None) -> int:
    """Run a :class:`tpuparquet_torch.serve.ScanServer` from a JSON spec:
    register tenants, submit their jobs, serve until everything is
    done or a SIGTERM drains (in-flight scans checkpoint durable
    cursors; rerunning the same spec on a successor resumes them).

    Spec shape::

        {"state_dir": "...",            # optional (TPQ_SERVE_STATE_DIR)
         "workers": 4,                  # optional global budget
         "status_export": "st.json",    # optional, for `tenants`
         "tenants": [{"label": "a", "weight": 2.0,
                      "byte_budget": null, "latency_target_ms": 500,
                      "error_rate_target": 0.01}],
         "jobs": [{"tenant": "a", "job_id": "j0",
                   "sources": ["a.parquet"], "columns": ["x", "y"],
                   "unit_deadline": 0.2, "scan_deadline": null,
                   "checkpoint_every": 1, "sink_dir": "out/a"}]}

    A job with ``sink_dir`` persists each decoded unit as a keyed
    atomic ``unit<k>.npz`` (tmp + rename — the crash-safe consumer
    discipline), so drained-and-resumed runs converge to a
    duplicate-free, bit-exact union.

    Admission shedding is not failure: a job rejected with a
    retryable :class:`~tpuparquet_torch.errors.AdmissionRejected` (queue
    full, byte budget, drain race) is held back and resubmitted after
    its ``retry_after_s`` hint — the rejection contract guarantees
    the request was never queued, so the retry is duplicate-free.

    Exit 0 = every job done; 3 = drained with work remaining (resume
    on a successor); 1 = a job failed."""
    import json as _json
    import time as _time

    from ..errors import AdmissionRejected
    from ..serve import ScanServer

    out = out or sys.stdout
    with open(args.spec) as f:
        spec = _json.load(f)
    arbiter = None
    if spec.get("workers"):
        from ..serve import ResourceArbiter

        arbiter = ResourceArbiter(total_workers=int(spec["workers"]))
    server = ScanServer(arbiter=arbiter,
                        state_dir=spec.get("state_dir"),
                        mesh=_mesh_for(getattr(args, "device", "cuda")))

    def _submit(j):
        sink = (_npz_sink(j["sink_dir"])
                if j.get("sink_dir") else None)
        return server.submit(
            j["tenant"], j["sources"], *j.get("columns", []),
            job_id=j.get("job_id"),
            unit_deadline=j.get("unit_deadline"),
            scan_deadline=j.get("scan_deadline"),
            checkpoint_every=j.get("checkpoint_every"),
            sink=sink)

    try:
        for t in spec.get("tenants", []):
            server.add_tenant(
                t["label"], weight=float(t.get("weight", 1.0)),
                byte_budget=t.get("byte_budget"),
                latency_target_ms=t.get("latency_target_ms"),
                error_rate_target=t.get("error_rate_target"))
        jobs = []
        pending = []  # [due_monotonic, jobspec] — shed, to resubmit
        for j in spec.get("jobs", []):
            try:
                jobs.append(_submit(j))
            except AdmissionRejected as e:
                hint = e.retry_after_s or 0.5
                print(f"{j['tenant']}/{j.get('job_id') or '?'}: shed "
                      f"({e.reason}), retrying in {hint:g}s", file=out)
                pending.append([_time.monotonic() + hint, j])
        server.install_signal_handlers()
        status_path = spec.get("status_export")
        while pending or not all(job.terminal for job in jobs):
            if server.draining:
                server.drain()
                break
            now = _time.monotonic()
            held = []
            for due, j in pending:
                if now < due:
                    held.append([due, j])
                    continue
                try:
                    jobs.append(_submit(j))
                except AdmissionRejected as e:
                    held.append([now + (e.retry_after_s or 0.5), j])
            pending = held
            if status_path:
                server.write_status(status_path)
            _time.sleep(0.2)
        if status_path:
            server.write_status(status_path)
        for job in jobs:
            job.wait(5.0)
            print(f"{job.tenant}/{job.job_id}: {job.state} "
                  f"({job.units_done}/{job.units_total} units)",
                  file=out)
        for _due, j in pending:
            print(f"{j['tenant']}/{j.get('job_id') or '?'}: shed "
                  f"(never admitted)", file=out)
        if any(job.state == "failed" for job in jobs):
            return 1
        if pending or any(job.state != "done" for job in jobs):
            return 3  # drained: resume on a successor
        return 0
    finally:
        server.shutdown(drain=False)


def _npz_sink(sink_dir: str):
    """Keyed atomic per-unit writer (``tests/checkpoint_child.py``
    discipline): re-decoded units after a crash/drain overwrite with
    identical bytes instead of duplicating."""
    os.makedirs(sink_dir, exist_ok=True)

    def sink(k: int, unit_out: dict) -> None:
        import numpy as np

        arrays = {}
        for name in sorted(unit_out):
            for i, arr in enumerate(unit_out[name].to_numpy()):
                if arr is not None:
                    arrays[f"{name}.{i}"] = np.asarray(arr)
        tmp = os.path.join(sink_dir, f".unit{k}.npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(sink_dir, f"unit{k}.npz"))

    return sink


def cmd_tenants(args, out=None) -> int:
    """Render a running server's tenant table from its
    ``status_export`` JSON (see ``serve``): per-tenant share of the
    global worker budget, queue depth, accounting, and the adaptive
    feedback (bound verdict, error-budget burn, unit p99) the
    arbiter last rebalanced on."""
    import json as _json

    out = out or sys.stdout
    with open(args.status) as f:
        st = _json.load(f)
    if getattr(args, "json", False):
        print(_json.dumps(st, sort_keys=True), file=out)
        return 0
    drain = " DRAINING" if st.get("draining") else ""
    print(f"workers={st.get('total_workers')}{drain} "
          f"state_dir={st.get('state_dir') or '-'}", file=out)
    hdr = (f"{'tenant':<16} {'share':>5} {'queued':>6} {'run':>3} "
           f"{'done':>5} {'rej':>4} {'bound':<12} {'burn':>6} "
           f"{'p99_ms':>8}")
    print(hdr, file=out)
    for label in sorted(st.get("tenants", {})):
        row = st["tenants"][label]
        burn = row.get("burn")
        p99 = row.get("p99_ms")
        burn_s = "-" if burn is None else f"{burn:.2f}"
        p99_s = "-" if p99 is None else f"{p99:.1f}"
        print(f"{label:<16} {row.get('share', 0):>5} "
              f"{len(row.get('queued') or []):>6} "
              f"{1 if row.get('running') else 0:>3} "
              f"{row.get('jobs_done', 0):>5} "
              f"{row.get('rejected', 0):>4} "
              f"{row.get('bound') or '-':<12} "
              f"{burn_s:>6} {p99_s:>8}", file=out)
    return 0


def cmd_flame(args, out=None) -> int:
    """Render a sampling-profile export (the native ``tpq-profile``
    envelope a scan wrote via ``TPQ_PROFILE_EXPORT``): top-N frames
    by self samples with total/share columns, filterable by
    ``--label``/``--stage``.  ``--diff A B`` prints the weighted
    per-frame share delta between two profiles — each normalizes to
    its own sample total, so runs of different length compare and the
    biggest movers localize a regression.  ``--collapsed`` dumps
    collapsed-stack lines for flamegraph.pl / speedscope; ``--json``
    emits machine-readable rows."""
    import json as _json

    from ..obs.profiler import (
        collapsed_lines,
        diff_states,
        load_profile_file,
        top_frames,
    )

    out = out or sys.stdout
    n = getattr(args, "n", 15)
    if getattr(args, "diff", None):
        a = load_profile_file(args.diff[0])
        b = load_profile_file(args.diff[1])
        rows = diff_states(a, b, n=n)
        if getattr(args, "json", False):
            print(_json.dumps(rows, sort_keys=True), file=out)
            return 0
        print(f"share delta {args.diff[0]} -> {args.diff[1]} "
              f"(+ grew in B)", file=out)
        for r in rows:
            print(f"  {r['delta'] * 100:+7.2f}%  "
                  f"{r['share_a'] * 100:6.2f}% -> "
                  f"{r['share_b'] * 100:6.2f}%  {r['frame']}",
                  file=out)
        return 0
    if not getattr(args, "profile_file", None):
        raise ValueError("flame: pass a PROFILE file or --diff A B")
    state = load_profile_file(args.profile_file)
    if getattr(args, "collapsed", False):
        for line in collapsed_lines(state):
            print(line, file=out)
        return 0
    label = getattr(args, "label", None)
    stage = getattr(args, "stage", None)
    rows = top_frames(state, label=label, stage=stage, n=n)
    if getattr(args, "json", False):
        print(_json.dumps(
            {"counters": state.get("counters") or {},
             "period_s": state.get("period_s"),
             "top": rows}, sort_keys=True), file=out)
        return 0
    c = state.get("counters") or {}
    total = c.get("profile_samples", 0)
    off = c.get("profile_samples_offcpu", 0)
    sel = "".join(
        [f" label={label}" if label else "",
         f" stage={stage}" if stage else ""])
    print(f"{total} samples ({off} off-cpu, "
          f"{c.get('profile_drops', 0)} drops) "
          f"@ {state.get('hz') or 0:g} Hz{sel}", file=out)
    if not rows:
        print("  (no samples match)", file=out)
        return 1
    print(f"  {'self':>7} {'total':>7} {'share':>7}  frame", file=out)
    for r in rows:
        print(f"  {r['self_s']:7.3f} {r['total_s']:7.3f} "
              f"{r['share'] * 100:6.2f}%  {r['frame']}", file=out)
    return 0


def _render_doctor_profile(state: dict, d: dict) -> str:
    """The ``doctor --profile`` tail: name the top frames inside the
    diagnosis's dominant stage and cross-check sampled seconds
    against the span-derived stage walls."""
    from ..obs.profiler import profile_consistency, top_frames

    bound = d.get("bound_stage")
    rows = top_frames(state, label=d.get("label"), stage=bound, n=5)
    if not rows:
        # multi-label exports may not key this trace's label; the
        # stage-filtered whole-profile view still answers "what ran"
        rows = top_frames(state, stage=bound, n=5)
    lines = [f"  profile: top frames in {bound} "
             f"({state.get('hz') or 0:g} Hz sampler)"]
    if not rows:
        lines.append("    (no samples in this stage)")
    for r in rows:
        lines.append(f"    {r['self_s']:8.3f}s self  "
                     f"{r['share'] * 100:5.1f}%  {r['frame']}")
    for w in profile_consistency(state, d.get("stages_s") or {}):
        lines.append(f"  WARNING {w}")
    return "\n".join(lines)


def cmd_doctor(args, out=None) -> int:
    """Walk a causal scan trace and say what bounds the wall.

    Input: a trace export — the file a scan wrote via
    ``TPQ_TRACE_EXPORT`` (the native ``tpq-trace`` envelope, read
    live mid-scan or after), a bare span-list JSON, or a
    ``*.perfetto.json`` round trip.  For each trace in the file:
    the per-unit stage decomposition (exclusive-time critical-path
    walk — stage buckets sum to the unit wall exactly), the
    scan-level bound verdict (read-bound / plan-bound /
    decompress-bound / decode-bound / gather-bound) with its share,
    straggler units ranked against the rolling p95 of unit walls
    (``deadline.LatencyTracker``, the same detector ``top`` uses
    live), and the plan-pool concurrency note that turns the
    plan pool's thread degradation into one line.  Attribution
    ledgers embedded in the export print alongside; a ledger whose
    counters show remote-source or range-cache traffic gets a REMOTE
    line (origin fetches vs cache hits, retry/hedge tallies) and an
    ORIGIN-BOUND callout when the read-bound verdict is dominated by
    origin round trips rather than local disk.  ``--json`` emits the
    full machine-readable reports."""
    import json as _json

    out = out or sys.stdout
    from ..obs.attribution import diagnose, format_diagnosis
    from ..obs.export import load_trace_file

    spans, ledgers = load_trace_file(args.trace)
    by_trace: dict = {}
    for s in spans:
        by_trace.setdefault(s.get("trace"), []).append(s)
    sel = getattr(args, "trace_id", None)
    if sel is not None:
        if sel not in by_trace:
            raise ValueError(
                f"trace id {sel!r} not in {args.trace!r}; present: "
                f"{sorted(k for k in by_trace if k is not None)}")
        by_trace = {sel: by_trace[sel]}
    if not by_trace:
        print("(no spans — was TPQ_TRACE=1 set on the scan?)",
              file=out)
        return 1
    reports = [diagnose(ss) for _tid, ss in
               sorted(by_trace.items(),
                      key=lambda kv: min(s["t0"] for s in kv[1]))]
    pstate = None
    if getattr(args, "profile", None):
        from ..obs.profiler import load_profile_file

        pstate = load_profile_file(args.profile)
    if getattr(args, "json", False):
        from ..obs.attribution import remote_report

        verdict0 = reports[0].get("verdict") if reports else None
        doc = {"reports": reports, "ledgers": ledgers,
               "remote": {
                   label: remote_report(
                       (led or {}).get("counters") or {},
                       verdict=verdict0)
                   for label, led in sorted((ledgers or {}).items())}}
        if pstate is not None:
            from ..obs.profiler import profile_consistency, top_frames

            doc["profile"] = [
                {"trace": d.get("trace"),
                 "bound_stage": d.get("bound_stage"),
                 "top_frames": top_frames(
                     pstate, stage=d.get("bound_stage"), n=5),
                 "warnings": profile_consistency(
                     pstate, d.get("stages_s") or {})}
                for d in reports]
        _json.dump(doc, out, sort_keys=True, default=str)
        print(file=out)
        return 0
    for i, d in enumerate(reports):
        if i:
            print(file=out)
        print(format_diagnosis(d, ledgers if i == 0 else None),
              file=out)
        if pstate is not None:
            print(_render_doctor_profile(pstate, d), file=out)
    return 0


def cmd_rescue(args, out=None) -> int:
    """Rewrite a torn/corrupt file's recoverable row groups into a
    clean file: open through the salvage path (footer recovery /
    valid-prefix trim, ``format/recover.py``), byte-copy each
    recovered chunk (no re-encode — the output is bit-identical to
    the surviving data), and write a fresh validated footer.  The
    output reopens under ``strict_metadata=True`` and under pyarrow."""
    from ..format.metadata import CompressionCodec

    out = out or sys.stdout
    like = getattr(args, "like", None) or None
    # a recovery tool must never destroy its own input: opening the
    # output 'wb' would truncate the source if they are the same file
    if os.path.exists(args.output) and \
            os.path.samefile(args.file, args.output):
        raise ValueError(
            "rescue output must differ from the input file")
    created: list = []
    try:
        rc = _rescue(args, like, out, CompressionCodec, created)
    except BaseException:
        # don't leave a truncated, footer-less output behind — but only
        # remove a file THIS invocation created: a failure before the
        # output was opened must not delete a pre-existing file
        if created:
            try:
                os.unlink(args.output)
            except OSError:
                pass
        raise
    return rc


def _rescue(args, like, out, CompressionCodec, created: list) -> int:
    from ..format.footer import MAGIC, write_footer
    from ..format.metadata import (
        ColumnChunk,
        ColumnMetaData,
        FileMetaData,
        KeyValue,
        RowGroup,
    )
    from ..format.recover import SALVAGED_KEY, encode_salvage_hint
    from ..format.schema import Schema

    with FileReader(args.file, salvage=True, salvage_like=like) as r, \
            open(args.file, "rb") as src, \
            open(args.output, "wb") as dst:
        created.append(True)  # output now exists (and was truncated)
        meta = r.metadata()
        dst.write(MAGIC)
        schema = Schema.from_elements(meta.schema)
        codec = None
        new_rgs = []
        for i, rg in enumerate(meta.row_groups):
            cols = []
            for cc in rg.columns:
                cm = cc.meta_data
                if codec is None:
                    codec = cm.codec
                    # rescued files are themselves salvageable — but a
                    # codec enum from a future writer (strict treats it
                    # as a warning; rescue byte-copies without decoding)
                    # cannot be named in the hint, so skip the frame
                    if isinstance(cm.codec, CompressionCodec):
                        dst.write(encode_salvage_hint(
                            schema, cm.codec,
                            created_by="parquet-tool rescue"))
                start = cm.data_page_offset
                if cm.dictionary_page_offset is not None:
                    start = min(start, cm.dictionary_page_offset)
                src.seek(start)
                blob = src.read(cm.total_compressed_size)
                if len(blob) != cm.total_compressed_size:
                    raise ValueError(
                        f"short read copying chunk at {start}")
                pos = dst.tell()
                dst.write(blob)
                shift = pos - start
                ncm = ColumnMetaData(**{
                    name: getattr(cm, name) for name in cm._NAMES})
                ncm.data_page_offset = cm.data_page_offset + shift
                if cm.dictionary_page_offset is not None:
                    ncm.dictionary_page_offset = \
                        cm.dictionary_page_offset + shift
                # page/bloom indexes are NOT copied: drop their offsets
                ncm.index_page_offset = None
                ncm.bloom_filter_offset = None
                ncm.bloom_filter_length = None
                cols.append(ColumnChunk(file_offset=pos, meta_data=ncm))
            new_rgs.append(RowGroup(
                columns=cols,
                total_byte_size=rg.total_byte_size,
                total_compressed_size=rg.total_compressed_size,
                num_rows=rg.num_rows,
                sorting_columns=rg.sorting_columns,
                ordinal=i,
            ))
        kv = [x for x in (meta.key_value_metadata or [])
              if x.key != SALVAGED_KEY]
        kv.append(KeyValue(key="tpq.rescued.from",
                           value=os.path.basename(args.file)))
        write_footer(dst, FileMetaData(
            version=meta.version if meta.version is not None else 1,
            schema=meta.schema,
            num_rows=sum(rg.num_rows for rg in new_rgs),
            row_groups=new_rgs,
            key_value_metadata=kv,
            created_by=meta.created_by,
        ))
        if r.salvaged:
            rep = r.salvage_report or {}
            print(f"salvaged {len(new_rgs)} row group(s) "
                  f"({sum(rg.num_rows for rg in new_rgs)} rows) from "
                  f"{args.file}; stop: {rep.get('stop_reason', '?')} "
                  f"at offset {rep.get('stop_offset', '?')}", file=out)
        else:
            print(f"{args.file} was already clean; copied "
                  f"{len(new_rgs)} row group(s)", file=out)
    # the point of rescue: the output must stand on its own
    with FileReader(args.output, strict_metadata=True) as check:
        print(f"wrote {args.output}: {check.num_rows} rows in "
              f"{check.row_group_count()} row group(s), "
              "strict validation passed", file=out)
    return 0


def cmd_split(args, out=None) -> int:
    """Re-shard into multiple files of ~--file-size each
    through the row API."""
    out = out or sys.stdout
    target = human_to_bytes(args.file_size)
    rg_size = human_to_bytes(args.row_group_size)
    codec = _CODECS[args.compression.lower()]
    folder = args.target_folder or os.path.dirname(os.path.abspath(args.file))
    base = os.path.splitext(os.path.basename(args.file))[0]

    with FileReader(args.file) as r:
        schema_def = r.get_schema_definition()
        part = 0
        w = None
        f = None
        current = None

        def open_part():
            nonlocal part, w, f, current
            current = os.path.join(folder, f"{base}_{part:03d}.parquet")
            f = open(current, "wb")
            try:
                w = FileWriter(f, schema_def, codec=codec,
                               max_row_group_size=rg_size or None,
                               created_by="parquet-tool split")
            except BaseException:
                f.close()
                f = None
                raise
            print(f"writing {current}", file=out)
            part += 1

        def close_part():
            nonlocal w, f
            w.close()
            f.close()
            w = f = None

        try:
            # Parts open lazily so a threshold hit on the last row
            # doesn't leave a trailing empty file.
            for row in r.rows():
                if w is None:
                    open_part()
                w.add_data(row)
                if (w.current_file_size()
                        + w.current_row_group_size() >= target):
                    close_part()
            if w is not None:
                close_part()
            elif part == 0:  # empty input: emit one valid (empty) file
                open_part()
                close_part()
        except BaseException:
            # Don't leave a footer-less, truncated part behind.
            if f is not None:
                f.close()
                try:
                    os.unlink(current)
                except OSError:
                    pass
            raise
    return 0


def cmd_compact(args, out=None) -> int:
    """Merge a partitioned dataset's small files into rolling
    target-sized ones through the atomic manifest commit."""
    out = out or sys.stdout
    from ..dataset import compact_dataset

    try:
        rep = compact_dataset(
            args.dataset,
            sort_by=args.sort_by,
            target_mb=args.target_mb,
            manifest_keep=args.keep,
        )
    except (FileNotFoundError, ValueError, NotImplementedError) as e:
        print(f"compact: {e}", file=out)
        return 1
    print(f"compacted {args.dataset}: {rep['files_before']} -> "
          f"{rep['files_after']} files, {rep['rows']} rows, "
          f"manifest v{rep['version']}", file=out)
    for rel in rep["gc"]:
        print(f"  gc {rel}", file=out)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parquet-tool", description="Tool to manage parquet files")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("cat", help="print the parquet file content")
    c.add_argument("--trace", action="store_true",
                   help="print decode statistics to stderr")
    c.add_argument("file")
    c.set_defaults(fn=cmd_cat)

    h = sub.add_parser("head", help="print the first N records")
    h.add_argument("--trace", action="store_true",
                   help="print decode statistics to stderr")
    h.add_argument("-n", type=int, default=5,
                   help="number of records to print")
    h.add_argument("file")
    h.set_defaults(fn=cmd_head)

    m = sub.add_parser("meta", help="print the file metadata")
    m.add_argument("--strict", action="store_true",
                   help="run strict metadata validation and exit "
                        "nonzero on error findings")
    m.add_argument("file")
    m.set_defaults(fn=cmd_meta)

    s = sub.add_parser("schema", help="print the file schema definition")
    s.add_argument("file")
    s.set_defaults(fn=cmd_schema)

    v = sub.add_parser(
        "verify",
        help="decode on the CPU and device paths and compare bit-exactly")
    v.add_argument("--device", default="cuda",
                   help="device of the device path (default cuda; cpu "
                        "runs the kernels' plain versions)")
    v.add_argument("file")
    v.set_defaults(fn=cmd_verify)

    pf = sub.add_parser(
        "profile",
        help="decode with telemetry on; print the per-column "
             "transport/timing table")
    pf.add_argument("--cpu", action="store_true",
                    help="profile the CPU oracle path instead of the "
                         "device path")
    pf.add_argument("--device", default="cuda",
                    help="device of the device path (default cuda; cpu "
                         "runs the kernels' plain versions)")
    pf.add_argument("--mirror", action="append", metavar="FILE",
                    help="replica copy to hedge chunk reads against "
                         "(repeatable); hedge/deadline counters appear "
                         "in the summary and per-column table")
    pf.add_argument("--events", metavar="FILE", default="",
                    help="write the per-page event log as JSON-lines")
    pf.add_argument("--perfetto", metavar="FILE", default="",
                    help="write a Chrome-trace JSON of the host phase "
                         "spans (ui.perfetto.dev)")
    pf.add_argument("--json", action="store_true",
                    help="emit the whole profile digest as "
                         "machine-readable JSON instead of the table")
    pf.add_argument("--filter", default="",
                    help="predicate to push down, e.g. "
                         "\"x > 100 & s in ('a','b')\" — the profile "
                         "then shows the pruning counters")
    pf.add_argument("--from-events", metavar="FILE", default="",
                    dest="from_events",
                    help="analyze a SAVED pages.jsonl event log "
                         "instead of re-running the decode")
    pf.add_argument("file", nargs="?", default="")
    pf.set_defaults(fn=cmd_profile)

    tp = sub.add_parser(
        "top",
        help="live view of a running scan's exported progress "
             "status file(s)")
    tp.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    tp.add_argument("--interval", type=float, default=1.0,
                    help="refresh interval in seconds")
    tp.add_argument("status", nargs="+",
                    help="progress status file(s) a scan exports via "
                         "progress_export= / TPQ_PROGRESS_EXPORT")
    tp.set_defaults(fn=cmd_top)

    w = sub.add_parser(
        "watch",
        help="live RED view (rate/errors/duration, budgets, alerts) "
             "over a time-series ring directory")
    w.add_argument("--once", action="store_true",
                   help="render one screen and exit")
    w.add_argument("--interval", type=float, default=2.0,
                   help="refresh interval in seconds")
    w.add_argument("--slo", default="",
                   help="SLO objectives JSON (default: TPQ_SLO_FILE)")
    w.add_argument("ring",
                   help="time-series ring directory a process records "
                        "via TPQ_TIMESERIES_DIR")
    w.set_defaults(fn=cmd_watch)

    so = sub.add_parser(
        "slo",
        help="evaluate SLO objectives over a saved time-series ring "
             "(error budgets, burn rates); nonzero exit on violation")
    so.add_argument("action", choices=["report"],
                    help="what to do (report: print the evaluation)")
    so.add_argument("--slo", default="",
                    help="SLO objectives JSON (default: TPQ_SLO_FILE)")
    so.add_argument("--json", action="store_true",
                    help="emit the machine-readable report")
    so.add_argument("ring",
                    help="time-series ring directory to evaluate")
    so.set_defaults(fn=cmd_slo)

    sv = sub.add_parser(
        "serve",
        help="run the multi-tenant scan server from a JSON spec "
             "(tenants + jobs); SIGTERM drains with durable cursors "
             "so rerunning the spec resumes")
    sv.add_argument("--device", default="cuda",
                    help="device of the scans (default cuda: this "
                         "process's cards; cpu runs the kernels' plain "
                         "versions)")
    sv.add_argument("spec",
                    help="server spec JSON (tenants, jobs, state_dir, "
                         "status_export — see the command docstring)")
    sv.set_defaults(fn=cmd_serve)

    tn = sub.add_parser(
        "tenants",
        help="render a running scan server's per-tenant status table "
             "from its status_export JSON")
    tn.add_argument("status",
                    help="status JSON the server exports "
                         "(spec key status_export)")
    tn.add_argument("--json", action="store_true",
                    help="emit the raw status document")
    tn.set_defaults(fn=cmd_tenants)

    dr = sub.add_parser(
        "doctor",
        help="walk a causal scan trace (TPQ_TRACE_EXPORT file) and "
             "name the bounding stage, stragglers and attribution")
    dr.add_argument("--json", action="store_true",
                    help="emit the full diagnosis reports as "
                         "machine-readable JSON")
    dr.add_argument("--trace-id", default=None, dest="trace_id",
                    help="analyze only this trace id (default: every "
                         "trace in the file)")
    dr.add_argument("--profile", default=None,
                    help="sampling-profile export (TPQ_PROFILE_EXPORT "
                         "native envelope): name the top frames inside "
                         "the dominant stage and cross-check sampled "
                         "seconds against the span stage walls")
    dr.add_argument("trace",
                    help="trace export: the tpq-trace envelope a scan "
                         "writes via TPQ_TRACE_EXPORT, a bare span "
                         "list, or a *.perfetto.json round trip")
    dr.set_defaults(fn=cmd_doctor)

    fl = sub.add_parser(
        "flame",
        help="render a sampling-profile export (TPQ_PROFILE_EXPORT): "
             "top frames by self time, or --diff two profiles")
    fl.add_argument("--diff", nargs=2, metavar=("A", "B"),
                    default=None,
                    help="weighted per-frame share delta between two "
                         "profile exports (regression localization)")
    fl.add_argument("--label", default=None,
                    help="only samples of this scan label")
    fl.add_argument("--stage", default=None,
                    help="only samples tagged with this stage "
                         "(read/plan/decompress/transfer/dispatch/"
                         "gather/write/other)")
    fl.add_argument("-n", type=int, default=15,
                    help="rows to print (default 15)")
    fl.add_argument("--collapsed", action="store_true",
                    help="dump collapsed-stack lines "
                         "(flamegraph.pl / speedscope input)")
    fl.add_argument("--json", action="store_true",
                    help="emit machine-readable rows")
    fl.add_argument("profile_file", nargs="?", default=None,
                    metavar="profile",
                    help="a native tpq-profile export (not needed "
                         "with --diff)")
    fl.set_defaults(fn=cmd_flame)

    rc = sub.add_parser("rowcount", help="print the total row count")
    rc.add_argument("file")
    rc.set_defaults(fn=cmd_rowcount)

    rs = sub.add_parser(
        "rescue",
        help="rewrite a torn file's recoverable row groups into a "
             "clean, strictly-valid file")
    rs.add_argument("--like", default="",
                    help="schema donor (a healthy sibling file) for "
                         "torn files without an embedded salvage hint")
    rs.add_argument("file")
    rs.add_argument("output")
    rs.set_defaults(fn=cmd_rescue)

    sp = sub.add_parser("split", help="split into multiple parquet files")
    sp.add_argument("-s", "--file-size", default="100MB",
                    help="target output file size")
    sp.add_argument("-t", "--target-folder", default="",
                    help="target folder (default: source folder)")
    sp.add_argument("-r", "--row-group-size", default="128MB",
                    help="uncompressed row group size")
    sp.add_argument("-c", "--compression", default="snappy",
                    choices=sorted(_CODECS), help="compression codec")
    sp.add_argument("file")
    sp.set_defaults(fn=cmd_split)

    cp = sub.add_parser(
        "compact",
        help="merge a partitioned dataset's small files atomically")
    cp.add_argument("--sort-by", default=None,
                    help="re-sort each partition by this data column "
                         "so page min/max stats become tight")
    cp.add_argument("--target-mb", type=int, default=None,
                    help="rolling output file target in MiB "
                         "(default: TPQ_DATASET_TARGET_MB or 64)")
    cp.add_argument("--keep", type=int, default=None,
                    help="manifest snapshots to retain "
                         "(default: TPQ_DATASET_MANIFEST_KEEP or 3)")
    cp.add_argument("dataset", help="dataset root directory or URI")
    cp.set_defaults(fn=cmd_compact)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError, KeyError) as e:
        print(f"parquet-tool: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
