"""Recorder-guard pass: hot telemetry sites skip kwargs when off.

``obs.recorder.flight`` — and its causal-tracing sibling
``obs.trace.emit_span`` — are internally no-ops when their layer is
disabled, but the *call site* still evaluates and boxes its keyword
arguments first.  On per-page/per-chunk paths that cost is real, so
the repo's discipline (``obs/recorder.py`` and ``obs/trace.py``
docstrings) is to guard the call itself::

    if _flightrec._active is not None:
        _flightrec.flight("page", site=..., file=..., page=...)

    if _trace._active is not None:
        _trace.emit_span("read", t0, dt, file=..., column=...)

The longitudinal layer keeps the same discipline for its own emit
surfaces — ``obs.digest.observe`` (per-unit/per-scan latency
observations) and ``obs.alerts.emit_alert``::

    if _digest._active is not None:
        _digest.observe(label, "unit", us, trace=..., unit=...)

The round-20 sampling profiler adds two more: ``stage_begin`` (the
per-window stage hints at the write/transfer/dispatch/gather sites)
and ``wait_begin`` (the off-CPU IO markers in the chunk reader)::

    ptok = _profiler.stage_begin("write") \
        if _profiler._active is not None else None

Their ``stage_end``/``wait_end`` twins are exempt like
``close_span``: they take the instance-carrying token ``stage_begin``
returned (None when off) and build nothing.

This pass enforces the pattern structurally, for ALL vocabularies:

* every *module-qualified* call (``<alias>.flight(...)`` /
  ``<alias>.emit_span(...)`` / ``<alias>.open_span(...)`` /
  ``<alias>.observe(...)`` / ``<alias>.emit_alert(...)`` — the form
  hot sites use precisely so they can reach ``_active``) must sit
  under an ``if`` whose test checks ``_active is not None`` (or
  ``recorder()``/``tracer()``/``digests()``/``engine()`` is not
  None);
* every *bare* ``flight(...)``/``emit_span(...)`` call that lives
  inside a ``for``/``while`` loop is treated as hot and held to the
  same rule — unless it is on an exceptional path (inside an
  ``except`` handler), which is the cold-site idiom (faults,
  quarantines, retries fire rarely and keep the plain call).

``close_span``/``adopt``/``ctx_of`` are exempt: they take an
already-built handle (None when off) and build no kwargs — guarding
them would only duplicate the open-site guard.
"""

from __future__ import annotations

import ast

from .astutil import PKG, Finding, RepoTree, ancestors, enclosing_function

PASS = "recorder-guard"

EXCLUDE = tuple(PKG + p for p in (
    "obs/recorder.py", "obs/trace.py", "obs/digest.py", "obs/alerts.py",
    "obs/profiler.py"))

#: call names held to the guarded-hot-site rule (the kwargs-building
#: emit surfaces of the flight recorder, the causal tracer, the
#: latency digests, the alert engine, and the sampling profiler's
#: stage/wait markers)
HOT_NAMES = ("flight", "emit_span", "open_span", "observe",
             "emit_alert", "stage_begin", "wait_begin")

#: event KINDS (the first positional arg) that ride per-request /
#: per-range hot paths no matter where the call sits — the round-18
#: remote-store emulation fires on a modulo of EVERY request, the
#: disk-cache poison check runs per cache hit, and prefetch spans are
#: emitted once per prefetched range.  These must be guarded even
#: outside loops and even on exceptional paths (the kwargs build
#: happens before the raise).
HOT_KINDS = ("emu_fault", "cache_poison", "prefetch_span")


def _is_guard_test(test: ast.AST) -> bool:
    """Does this if-test (or any part of it) check the recorder gate?"""
    for node in ast.walk(test):
        if isinstance(node, ast.Attribute) and node.attr == "_active":
            return True
        if isinstance(node, ast.Name) and node.id == "_active":
            return True
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) \
                else f.id if isinstance(f, ast.Name) else None
            if name in ("recorder", "tracer", "digests", "engine",
                        "profiler"):
                return True
    return False


def _context(node, fn):
    """(guarded, in_loop, in_except) from the ancestor chain, scoped
    to the enclosing function."""
    guarded = in_loop = in_except = False
    prev = node
    for a in ancestors(node):
        if a is fn:
            break
        if isinstance(a, ast.If) and prev in a.body \
                and _is_guard_test(a.test):
            guarded = True
        # the expression form of the same idiom:
        #   h = _trace.open_span(...) if _trace._active is not None \
        #       else None
        if isinstance(a, ast.IfExp) and prev is a.body \
                and _is_guard_test(a.test):
            guarded = True
        if isinstance(a, (ast.For, ast.While)):
            in_loop = True
        if isinstance(a, ast.ExceptHandler):
            in_except = True
        prev = a
    return guarded, in_loop, in_except


def run(tree: RepoTree) -> list[Finding]:
    findings: list[Finding] = []
    for path, mod in tree.modules(PKG):
        if path in EXCLUDE:
            continue
        for node in ast.walk(mod):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            qualified = isinstance(f, ast.Attribute) and \
                f.attr in HOT_NAMES
            bare = isinstance(f, ast.Name) and f.id in HOT_NAMES
            if not (qualified or bare):
                continue
            fn = enclosing_function(node)
            guarded, in_loop, in_except = _context(node, fn)
            if guarded:
                continue
            fname = fn.name if fn is not None else "<module>"
            called = f.attr if qualified else f.id
            kind = ""
            if node.args and isinstance(node.args[0], ast.Constant):
                kind = str(node.args[0].value)
            key = f"{fname}:{kind}" if kind else fname
            if kind in HOT_KINDS:
                findings.append(Finding(
                    PASS, path, node.lineno, "unguarded-hot-kind",
                    key,
                    f"{called}({kind!r}, ...) in {fname}() without "
                    f"the `_active is not None` guard — {kind} events "
                    f"fire on per-request/per-range paths, so the "
                    f"kwargs build must be skipped when the recorder "
                    f"is off, wherever the call sits"))
                continue
            if qualified:
                findings.append(Finding(
                    PASS, path, node.lineno, "unguarded-hot-flight",
                    key,
                    f"module-qualified {called}() call in {fname}() "
                    f"without the `_active is not None` guard — the "
                    f"qualified form exists exactly so hot sites can "
                    f"skip kwargs construction when the "
                    f"recorder/tracer is off"))
            elif in_loop and not in_except:
                findings.append(Finding(
                    PASS, path, node.lineno, "unguarded-hot-flight",
                    key,
                    f"{called}() call inside a loop in {fname}() "
                    f"constructs kwargs even with the recorder/tracer "
                    f"disabled — guard with `_active is not None` "
                    f"(hot) or move to an exceptional path (cold)"))
    return findings
