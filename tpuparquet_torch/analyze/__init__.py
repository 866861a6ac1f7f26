"""tpq-analyze over the port: the repo's conventions as machine-checked
contracts.

The port of ``tools/analyze``, shipped inside the package so the port
carries its own gate.  Eight AST invariant passes over the package
(``astutil.PKG``) turn documented disciplines — exact counter merges, registered fault sites, the
env-knob catalog, atomic durable writes, guarded flight-recorder hot
sites, lock-guarded module state with an acyclic whole-program lock
graph, released-on-all-paths resource lifecycles, and taxonomy-typed
raises — into a zero-findings CI gate.  Run::

    python -m tpuparquet_torch.analyze [--json] [--pass NAME]

The gate is **zero findings, not zero noise**: real, justified
exceptions live in ``allowlist.json`` beside this file, with a reason
each, matched by ``(pass, file, key)`` where ``key`` is a stable
symbol/site/knob name (never a line number).  A stale allowlist entry
— one that matches nothing anymore — is itself a finding, so the
exception list can only shrink truthfully; ``--allowlist-audit``
additionally lists every entry by age and fails on entries whose
target file no longer exists.

The static thread-safety pass has a runtime twin: with
``TPQ_LOCKCHECK=1`` the library records its real lock-acquisition
graph (the package's ``lockcheck.py``), and ``--verify-lockcheck DUMP``
checks that recording is cycle-free and a subgraph of the static
graph — each side validating the other.
"""

from __future__ import annotations

import json
import os
import time

from . import (atomicwrite, counters, envknobs, faultsites,
               lifecycle, raises, recorderguard, threads)
from .astutil import Finding, RepoTree

__all__ = ["PASSES", "RepoTree", "Finding", "Allowlist",
           "run_analysis", "repo_root", "DEFAULT_ALLOWLIST"]

#: registry of invariant passes, in report order
PASSES = {
    counters.PASS: counters.run,
    faultsites.PASS: faultsites.run,
    envknobs.PASS: envknobs.run,
    atomicwrite.PASS: atomicwrite.run,
    recorderguard.PASS: recorderguard.run,
    threads.PASS: threads.run,
    lifecycle.PASS: lifecycle.run,
    raises.PASS: raises.run,
}

_DIR = os.path.dirname(os.path.abspath(__file__))
DEFAULT_ALLOWLIST = os.path.join(_DIR, "allowlist.json")


def repo_root() -> str:
    """The repo root this analyzer ships in (the package's parent)."""
    return os.path.dirname(os.path.dirname(_DIR))


class Allowlist:
    """Justified exceptions: entries ``{pass, file, key, reason}``
    plus an optional ``added`` date (YYYY-MM-DD) the hygiene audit
    sorts by.

    Matching is exact on ``(pass, file, key)``; a ``reason`` is
    mandatory — an allowlist row without one is rejected at load so
    "TODO" exceptions can't accrete."""

    def __init__(self, entries: list[dict] | None = None):
        self.entries = list(entries or [])
        for e in self.entries:
            for field in ("pass", "file", "key", "reason"):
                if not e.get(field):
                    raise ValueError(
                        f"allowlist entry {e!r} missing {field!r} — "
                        f"every exception needs pass/file/key and a "
                        f"reason")
        self._used: set[int] = set()

    @classmethod
    def load(cls, path: str | None) -> "Allowlist":
        if not path or not os.path.exists(path):
            return cls([])
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        return cls(doc.get("entries") or [])

    def suppresses(self, finding: Finding) -> bool:
        for i, e in enumerate(self.entries):
            if (e["pass"] == finding.pass_name
                    and e["file"] == finding.file
                    and e["key"] == finding.key):
                self._used.add(i)
                return True
        return False

    def stale_entries(self) -> list[dict]:
        """Entries that suppressed nothing in the last run."""
        return [e for i, e in enumerate(self.entries)
                if i not in self._used]

    def audit(self, tree: "RepoTree") -> dict:
        """Hygiene report: every entry by age/pass, plus the entries
        whose target FILE no longer exists in the tree (a stronger
        staleness than key-match — the justified code is gone
        entirely, so the exception must go with it).  ``README.md``,
        whose knob catalog the env-knob pass reads, counts as a file."""
        rows = []
        missing = []
        for e in self.entries:
            row = {
                "pass": e["pass"],
                "file": e["file"],
                "key": e["key"],
                "added": e.get("added") or "(pre-audit)",
                "reason": e["reason"],
                "target_exists": (e["file"] in tree.files
                                  or (e["file"] == "README.md"
                                      and tree.readme is not None)),
            }
            rows.append(row)
            if not row["target_exists"]:
                missing.append(row)
        rows.sort(key=lambda r: (r["added"], r["pass"], r["file"],
                                 r["key"]))
        return {"entries": rows, "missing_target": missing,
                "ok": not missing}


def run_analysis(root: str | None = None,
                 passes: list[str] | None = None,
                 allowlist: "Allowlist | str | None" = DEFAULT_ALLOWLIST,
                 tree: RepoTree | None = None) -> dict:
    """Run the selected passes and fold in the allowlist.

    Returns ``{"findings": [...], "suppressed": [...], "stale":
    [...], "counts": {...}, "timings_s": {...}, "ok": bool}`` —
    ``ok`` is the gate: no live findings, no parse errors, no stale
    allowlist entries.  ``timings_s`` carries per-pass wall time (the
    parsed-AST cache in :class:`RepoTree` is shared across passes, so
    the first pass pays the parse and the rest measure pure
    analysis)."""
    if tree is None:
        tree = RepoTree.from_disk(root or repo_root())
    if isinstance(allowlist, str) or allowlist is None:
        allowlist = Allowlist.load(allowlist)
    selected = passes or list(PASSES)
    unknown = [p for p in selected if p not in PASSES]
    if unknown:
        raise ValueError(f"unknown pass(es) {unknown}; "
                         f"have {sorted(PASSES)}")
    live: list[Finding] = []
    suppressed: list[Finding] = []
    counts: dict[str, int] = {}
    timings: dict[str, float] = {}
    for name in selected:
        t0 = time.monotonic()
        found = PASSES[name](tree)
        timings[name] = round(time.monotonic() - t0, 4)
        counts[name] = len(found)
        for f in found:
            (suppressed if allowlist.suppresses(f) else live).append(f)
    for path, err in tree.parse_errors:
        live.append(Finding("analyze", path, 1, "parse-error", path,
                            f"unparseable source: {err}"))
    # staleness is judged only for entries whose pass actually ran —
    # a --pass subset must not condemn the other passes' exceptions
    stale = [e for e in allowlist.stale_entries()
             if e["pass"] in selected]
    return {
        "findings": [f.as_dict() for f in live],
        "suppressed": [f.as_dict() for f in suppressed],
        "stale_allowlist": stale,
        "counts": counts,
        "timings_s": timings,
        "ok": not live and not stale,
    }
