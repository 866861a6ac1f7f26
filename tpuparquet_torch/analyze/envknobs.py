"""Env-knob pass: the ``TPQ_*`` catalog and the code cannot drift.

AST-level successor of the old source grep in
``tests/test_env_docs.py`` (which matched quoted literals and so
missed reads where the knob name arrives through a helper
parameter).  Evidence for "the source uses this knob", strongest
first:

* **direct reads/writes** — ``os.environ.get("TPQ_X")``,
  ``os.environ["TPQ_X"]``, ``os.getenv("TPQ_X")``, membership tests,
  ``setdefault``/``pop``/assignment;
* **indirect reads** — a call ``helper("TPQ_X", ...)`` where
  ``helper`` is any function in the tree whose matching *parameter*
  flows into an environ read in its body (``_env_budget``,
  ``_env_float``, ``_env_int``, and anything added later — detected
  structurally, not by name);
* **env-dict construction** — ``TPQ_X=...`` keyword arguments and
  ``{"TPQ_X": ...}`` dict keys (subprocess environments, as the card script
  builds them);
* **bare literal** — any other ``"TPQ_X"`` string constant (the old
  grep's whole evidence class, kept as a fallback so nothing the
  grep caught goes dark).

The pass then proves catalog parity both ways against the README
"## Env knobs" section: every knob used in source is documented, and
every documented knob is still used.  The section's closing paragraph of
tool-only knobs names the reference's bench scripts, which are not
part of the port, and is left out of the catalog.
"""

from __future__ import annotations

import ast
import re

from .astutil import PKG, Finding, RepoTree, const_str

PASS = "env-knobs"

_KNOB = re.compile(r"^TPQ_[A-Z0-9_]+$")
_DOCUMENTED = re.compile(r"`(TPQ_[A-Z0-9_]+)`")

#: roots whose knob usage the README must catalog: the package and the
#: card's smoke script (tests arm knobs ad hoc and are exempt).  The analyzer's own sources are
#: excluded — its fixtures and pass logic *name* knobs as data.
ROOTS = (PKG, "chip_smoke.py")
EXCLUDE = (PKG + "analyze/",)

#: the catalog's paragraph of the reference's bench-script knobs
_TOOL_ONLY = "\nTool-only knobs"


def _is_environ(node) -> bool:
    """Does this expression denote ``os.environ``?"""
    return (isinstance(node, ast.Attribute) and node.attr == "environ") \
        or (isinstance(node, ast.Name) and node.id == "environ")


def _env_read_params(fn) -> set[int]:
    """Indices of ``fn`` parameters that flow into an environ read in
    its body (one level of indirection)."""
    params = [a.arg for a in fn.args.args]
    hits: set[int] = set()
    for node in ast.walk(fn):
        name = None
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and _is_environ(f.value) \
                    and f.attr in ("get", "setdefault", "pop"):
                name = node.args[0] if node.args else None
            elif isinstance(f, ast.Attribute) and f.attr == "getenv":
                name = node.args[0] if node.args else None
            elif isinstance(f, ast.Name) and f.id == "getenv":
                name = node.args[0] if node.args else None
        elif isinstance(node, ast.Subscript) and _is_environ(node.value):
            name = node.slice
        if isinstance(name, ast.Name) and name.id in params:
            hits.add(params.index(name.id))
    return hits


def source_knobs(tree: RepoTree) -> dict[str, dict]:
    """knob -> {"evidence": kind, "file": path, "line": n} for every
    TPQ_ knob the configured roots use, with the strongest evidence
    kind retained (direct > indirect > envdict > literal)."""
    rank = {"direct": 0, "indirect": 1, "envdict": 2, "literal": 3}
    out: dict[str, dict] = {}

    def record(knob, kind, path, line):
        if knob is None or not _KNOB.match(knob):
            return
        prev = out.get(knob)
        if prev is None or rank[kind] < rank[prev["evidence"]]:
            out[knob] = {"evidence": kind, "file": path, "line": line}

    paths = [p for p in tree.files
             if any(p == r or p.startswith(r) for r in ROOTS)
             and not any(p.startswith(x) for x in EXCLUDE)]

    # pass 1: find helper functions with env-reading parameters
    helpers: dict[str, set[int]] = {}
    for path in sorted(paths):
        mod = tree.module(path)
        if mod is None:
            continue
        for node in ast.walk(mod):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                idx = _env_read_params(node)
                if idx:
                    helpers.setdefault(node.name, set()).update(idx)

    # pass 2: collect evidence
    for path in sorted(paths):
        mod = tree.module(path)
        if mod is None:
            continue
        for node in ast.walk(mod):
            if isinstance(node, ast.Call):
                f = node.func
                fname = f.attr if isinstance(f, ast.Attribute) \
                    else f.id if isinstance(f, ast.Name) else None
                if isinstance(f, ast.Attribute) \
                        and _is_environ(f.value) \
                        and f.attr in ("get", "setdefault", "pop") \
                        and node.args:
                    record(const_str(node.args[0]), "direct",
                           path, node.lineno)
                elif fname == "getenv" and node.args:
                    record(const_str(node.args[0]), "direct",
                           path, node.lineno)
                elif fname in helpers:
                    for i in helpers[fname]:
                        if i < len(node.args):
                            record(const_str(node.args[i]), "indirect",
                                   path, node.lineno)
                for kw in node.keywords:
                    if kw.arg and _KNOB.match(kw.arg):
                        record(kw.arg, "envdict", path, node.lineno)
            elif isinstance(node, ast.Subscript) \
                    and _is_environ(node.value):
                record(const_str(node.slice), "direct",
                       path, node.lineno)
            elif isinstance(node, ast.Compare) \
                    and any(_is_environ(c) for c in node.comparators):
                record(const_str(node.left), "direct",
                       path, node.lineno)
            elif isinstance(node, ast.Dict):
                for k in node.keys:
                    record(const_str(k), "envdict", path, node.lineno)
            else:
                s = const_str(node)
                if s is not None:
                    record(s, "literal", path, node.lineno)
    return out


def readme_knobs(tree: RepoTree) -> set[str]:
    """Knobs documented in the README "## Env knobs" section, up to its
    paragraph of the reference's tool-only knobs (bench and at-scale
    scripts outside the package, which no root here reads)."""
    text = tree.readme or ""
    start = text.find("## Env knobs")
    if start < 0:
        return set()
    end = text.find("\n## ", start + 3)
    if end < 0:
        end = len(text)
    tools = text.find(_TOOL_ONLY, start, end)
    if tools >= 0:
        end = tools
    return set(_DOCUMENTED.findall(text[start:end]))


def run(tree: RepoTree) -> list[Finding]:
    findings: list[Finding] = []
    if tree.readme is None or "## Env knobs" not in tree.readme:
        findings.append(Finding(
            PASS, "README.md", 1, "catalog-missing", "Env knobs",
            "no '## Env knobs' section in the README — the knob "
            "catalog the source is checked against"))
        return findings
    src = source_knobs(tree)
    doc = readme_knobs(tree)
    for knob in sorted(set(src) - doc):
        ev = src[knob]
        findings.append(Finding(
            PASS, ev["file"], ev["line"], "undocumented-knob", knob,
            f"{knob} is used by the source ({ev['evidence']} evidence) "
            f"but has no row in the README 'Env knobs' catalog"))
    for knob in sorted(doc - set(src)):
        findings.append(Finding(
            PASS, "README.md", 1, "stale-doc-knob", knob,
            f"the README documents {knob} but no source under "
            f"{ROOTS} uses it anymore — drop the stale row"))
    return findings
