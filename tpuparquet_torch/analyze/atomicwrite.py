"""Atomic-write pass: durable artifacts go through tmp+rename.

Every durable runtime artifact in the tree — cursor checkpoints,
scan-progress status frames, post-mortems, metrics snapshots — is
published with the atomic discipline (same-directory tmp,
``os.replace``, fsync where loss matters) via
``obs.live.atomic_write_text`` or ``shard.scan.save_cursor_file``.  A
plain ``open(path, "w")`` on such a path can expose a torn file to a
concurrent reader (``parquet-tool top``, a Prometheus scraper, a
resuming scan) or lose the artifact on crash mid-write.

The pass flags every *text-mode* write-open in the package whose
enclosing function does not itself complete the tmp+``os.replace``
dance.  Binary write-opens are out of scope: those are user-requested
parquet data files whose torn-write story is the salvage layer, not
the atomic-rename discipline.  User-requested export APIs that take
an explicit path/stream (event-log dumps, Chrome traces) are the
allowlist's territory — with a reason each.
"""

from __future__ import annotations

import ast

from .astutil import (PKG, Finding, RepoTree, call_name, const_str,
                      enclosing_function)

PASS = "atomic-write"

_WRITE_MODES = ("w", "wt", "a", "at", "w+", "a+", "x", "xt")


def _write_mode(call: ast.Call) -> bool:
    """Is this an ``open`` call in a text write mode?"""
    if call_name(call) != "open":
        return False
    mode = None
    if len(call.args) > 1:
        mode = const_str(call.args[1])
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = const_str(kw.value)
    return mode in _WRITE_MODES


def _replaces_atomically(fn) -> bool:
    """Does the function body call ``os.replace``/``os.rename``
    (the promote step of the tmp+rename discipline)?"""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                call_name(node) in ("replace", "rename"):
            return True
    return False


def run(tree: RepoTree) -> list[Finding]:
    findings: list[Finding] = []
    for path, mod in tree.modules(PKG):
        for node in ast.walk(mod):
            if not (isinstance(node, ast.Call) and _write_mode(node)):
                continue
            fn = enclosing_function(node)
            fname = fn.name if fn is not None else "<module>"
            if fn is not None and _replaces_atomically(fn):
                continue  # tmp + os.replace in the same function
            findings.append(Finding(
                PASS, path, node.lineno, "non-atomic-write", fname,
                f"text-mode open(..., 'w') in {fname}() without a "
                f"tmp+os.replace promote — a concurrent reader can "
                f"see a torn file and a crash mid-write loses the "
                f"artifact; route it through obs.live."
                f"atomic_write_text (or justify in the allowlist)"))
    return findings
