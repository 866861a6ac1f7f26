"""CLI entry: ``python -m tpuparquet_torch.analyze``.

Exit 0 = gate passed (zero unsuppressed findings, no stale allowlist
entries); 1 = violations; 2 = usage error.  ``--json`` emits the
whole result as one machine-readable document (the same digest
``parquet-tool analyze --json`` prints).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import (DEFAULT_ALLOWLIST, PASSES, Allowlist, RepoTree,
               repo_root, run_analysis)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpq-analyze",
        description="static invariant passes over the port's tree")
    p.add_argument("--root", default=None,
                   help="repo root (default: autodetected from this "
                        "file's location)")
    p.add_argument("--pass", dest="passes", action="append",
                   metavar="NAME", choices=sorted(PASSES),
                   help="run only this pass (repeatable; default all; "
                        "stale-allowlist checking needs the full run)")
    p.add_argument("--allowlist", default=DEFAULT_ALLOWLIST,
                   help="allowlist JSON path (default: the checked-in "
                        "allowlist.json beside the analyzer)")
    p.add_argument("--no-allowlist", action="store_true",
                   help="report raw findings with no suppression")
    p.add_argument("--json", action="store_true",
                   help="emit the full result as JSON on stdout")
    p.add_argument("--lock-graph", action="store_true",
                   help="print the whole-program static lock-order "
                        "graph (sites, edges, unresolved) and exit")
    p.add_argument("--verify-lockcheck", metavar="DUMP",
                   help="check a runtime lockcheck dump (JSON from "
                        "TPQ_LOCKCHECK_OUT) is violation-free and a "
                        "subgraph of the static graph, then exit")
    p.add_argument("--allowlist-audit", action="store_true",
                   help="list allowlist entries by age/pass and fail "
                        "on entries whose target file is gone")
    return p


def _lock_graph(args) -> int:
    from . import threads
    tree = RepoTree.from_disk(args.root or repo_root())
    g = threads.static_graph(tree)
    if args.json:
        json.dump(g, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        for site, info in sorted(g["sites"].items()):
            print(f"lock {site} [{info['kind']}] {info['label']}")
        for a, b in g["edges"]:
            print(f"edge {a} -> {b}")
        for u in g["unresolved"]:
            print(f"unresolved {u['file']}:{u['line']} "
                  f"{u['expr']} in {u['function']}()")
        print(f"lock-graph: {len(g['sites'])} site(s), "
              f"{len(g['edges'])} edge(s), "
              f"{len(g['unresolved'])} unresolved")
    return 1 if g["unresolved"] else 0


def _verify_lockcheck(args) -> int:
    from . import threads
    tree = RepoTree.from_disk(args.root or repo_root())
    with open(args.verify_lockcheck, encoding="utf-8") as f:
        recorded = json.load(f)
    problems = threads.verify_runtime_graph(tree, recorded)
    if args.json:
        json.dump({"problems": problems, "ok": not problems},
                  sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        for pr in problems:
            print(f"lockcheck: {pr}")
        n_edges = len(recorded.get("edges") or [])
        print(f"verify-lockcheck: {n_edges} recorded edge(s), "
              f"{len(problems)} problem(s): "
              + ("PASSED" if not problems else "FAILED"))
    return 0 if not problems else 1


def _allowlist_audit(args) -> int:
    tree = RepoTree.from_disk(args.root or repo_root())
    report = Allowlist.load(args.allowlist).audit(tree)
    if args.json:
        json.dump(report, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        for e in report["entries"]:
            mark = " MISSING-TARGET" if not e["target_exists"] else ""
            print(f"{e['added']}  {e['pass']:20s} {e['file']}::"
                  f"{e['key']}{mark}")
        print(f"allowlist-audit: {len(report['entries'])} entr(y/ies),"
              f" {len(report['missing_target'])} with missing target "
              f"file: " + ("PASSED" if report["ok"] else "FAILED"))
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.lock_graph:
        return _lock_graph(args)
    if args.verify_lockcheck:
        return _verify_lockcheck(args)
    if args.allowlist_audit:
        return _allowlist_audit(args)
    res = run_analysis(
        root=args.root, passes=args.passes,
        allowlist=None if args.no_allowlist else args.allowlist)
    if args.json:
        json.dump(res, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        for f in res["findings"]:
            print(f"{f['file']}:{f['line']}: [{f['pass']}/{f['code']}]"
                  f" {f['key']}: {f['why']}")
        for e in res["stale_allowlist"]:
            print(f"allowlist: stale entry ({e['pass']}, {e['file']}, "
                  f"{e['key']}) suppresses nothing — drop it "
                  f"(reason was: {e['reason']})")
        total = sum(res["counts"].values())
        print(f"tpq-analyze: {len(res['findings'])} finding(s) "
              f"({total} raw, {len(res['suppressed'])} allowlisted"
              f"{', ' + str(len(res['stale_allowlist'])) + ' stale allowlist entr(y/ies)' if res['stale_allowlist'] else ''}) "
              f"across {len(res['counts'])} pass(es): "
              + ("gate PASSED" if res["ok"] else "gate FAILED"))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
