"""Fault-site pass: injection sites, registry, docs and tests agree.

The fault-injection harness (the package's ``faults.py``) matches rules
to sites by *string equality* — a drifted site name doesn't error, it
just never fires, and the test that armed it silently tests nothing.
This pass pins four corners together:

* every ``fault_point("...")`` / ``filter_bytes("...", ...)``
  instrumentation site in the library is registered in
  ``faults.SITES``;
* every registered site is actually instrumented somewhere (no dead
  registry rows);
* every site a test arms (``inj.inject("site", "kind")``) exists, and
  the kind is one the site supports;
* the human table in the ``faults.py`` docstring lists exactly the
  registered sites (docs can't drift from the registry).
"""

from __future__ import annotations

import ast
import re

from .astutil import PKG, TESTS, Finding, RepoTree, call_name, const_str

PASS = "fault-sites"

FAULTS_PATH = PKG + "faults.py"

#: the instrumentation hooks whose first argument is a site name
_HOOKS = ("fault_point", "filter_bytes")

#: docstring table rows: a line opening with ``site.name`` (sites are
#: always dotted, which keeps kind words like ``hang`` out)
_DOC_SITE = re.compile(
    r"^``([a-z0-9_]+(?:\.[a-z0-9_]+)+)``", re.MULTILINE)


def read_sites(tree: RepoTree) -> dict[str, tuple] | None:
    """The ``SITES`` registry literal from faults.py, or None."""
    mod = tree.module(FAULTS_PATH) if FAULTS_PATH in tree.files else None
    if mod is None:
        return None
    for node in ast.walk(mod):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Name) and tgt.id == "SITES" \
                        and isinstance(node.value, ast.Dict):
                    out = {}
                    for k, v in zip(node.value.keys, node.value.values):
                        site = const_str(k)
                        if site is None:
                            return None
                        kinds = []
                        if isinstance(v, (ast.Tuple, ast.List, ast.Set)):
                            kinds = [const_str(e) for e in v.elts]
                        out[site] = tuple(x for x in kinds if x)
                    return out
    return None


def instrumented_sites(tree: RepoTree) -> dict[str, tuple[str, int]]:
    """site -> (file, line) of one instrumentation hook naming it."""
    out: dict[str, tuple[str, int]] = {}
    for path, mod in tree.modules(PKG):
        if path == FAULTS_PATH:
            continue  # the hooks' own definitions/docs
        for node in ast.walk(mod):
            if isinstance(node, ast.Call) and \
                    call_name(node) in _HOOKS and node.args:
                site = const_str(node.args[0])
                if site is not None:
                    out.setdefault(site, (path, node.lineno))
    return out


def injected_sites(tree: RepoTree) -> list[tuple[str, str, str, int]]:
    """Every test-armed rule: (site, kind, file, line)."""
    out = []
    for path, mod in tree.modules(TESTS):
        for node in ast.walk(mod):
            if isinstance(node, ast.Call) and \
                    call_name(node) == "inject" and node.args:
                site = const_str(node.args[0])
                kind = const_str(node.args[1]) \
                    if len(node.args) > 1 else None
                if site is not None:
                    out.append((site, kind or "", path, node.lineno))
    return out


def docstring_sites(tree: RepoTree) -> set[str]:
    mod = tree.module(FAULTS_PATH) if FAULTS_PATH in tree.files else None
    if mod is None:
        return set()
    doc = ast.get_docstring(mod) or ""
    return set(_DOC_SITE.findall(doc))


def run(tree: RepoTree) -> list[Finding]:
    findings: list[Finding] = []
    sites = read_sites(tree)
    if sites is None:
        findings.append(Finding(
            PASS, FAULTS_PATH, 1, "registry-unreadable", "SITES",
            "no SITES = {...} literal in faults.py — the fault-site "
            "registry the harness and tests are checked against"))
        return findings

    hooked = instrumented_sites(tree)
    for site, (path, line) in sorted(hooked.items()):
        if site not in sites:
            findings.append(Finding(
                PASS, path, line, "unregistered-site", site,
                f"instrumentation names site {site!r} which "
                f"faults.SITES does not register — rules armed against "
                f"the registry can never fire here"))
    for site in sorted(set(sites) - set(hooked)):
        findings.append(Finding(
            PASS, FAULTS_PATH, 1, "dead-site", site,
            f"faults.SITES registers {site!r} but no fault_point/"
            f"filter_bytes hook in {PKG} names it — a rule armed "
            f"there waits forever"))

    for site, kind, path, line in injected_sites(tree):
        if site not in sites:
            findings.append(Finding(
                PASS, path, line, "unknown-test-site", site,
                f"test arms fault site {site!r} which is not in "
                f"faults.SITES — the rule never fires and the test "
                f"exercises nothing"))
        elif kind and kind not in sites[site]:
            findings.append(Finding(
                PASS, path, line, "kind-mismatch", f"{site}:{kind}",
                f"test arms kind {kind!r} at {site!r} but the site "
                f"supports only {sorted(sites[site])}"))

    doc = docstring_sites(tree)
    if doc:  # fixtures without a docstring table skip the doc check
        for site in sorted(set(sites) - doc):
            findings.append(Finding(
                PASS, FAULTS_PATH, 1, "docstring-drift", site,
                f"site {site!r} is registered but missing from the "
                f"faults.py docstring table"))
        for site in sorted(doc - set(sites)):
            findings.append(Finding(
                PASS, FAULTS_PATH, 1, "docstring-drift", site,
                f"the faults.py docstring table lists {site!r} which "
                f"is not registered in SITES"))
    return findings
