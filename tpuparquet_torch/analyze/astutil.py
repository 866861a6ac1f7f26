"""Shared AST plumbing for the tpq-analyze passes.

The port of ``tools/analyze/astutil.py``.  Every pass consumes a
:class:`RepoTree`: a parsed snapshot of the source files a pass may
reason about (the package, its tests, ``chip_smoke.py``, the README).
Trees come from disk for the real gate (:meth:`RepoTree.from_disk`) or
from in-memory ``{relpath: source}`` dicts for seeded-bug fixtures —
passes never touch the filesystem themselves, so a fixture IS a repo as
far as a pass can tell.

:data:`PKG` is the one place that names the package the passes check;
every pass selects its files through it.

Parsed modules carry parent links (:func:`attach_parents`) because
most invariants here are about *context* — "is this call inside a
loop", "is this store under a ``with`` on a module lock" — which bare
``ast`` nodes cannot answer.
"""

from __future__ import annotations

import ast
import dataclasses
import os

__all__ = ["Finding", "RepoTree", "attach_parents", "ancestors",
           "enclosing_function", "call_name", "const_str", "PKG", "TESTS"]

#: the package the passes check, as a repo-relative path prefix
PKG = "tpuparquet_torch/"

#: the test files whose fault injections the fault-site pass checks
TESTS = "tests/test_torch_"


@dataclasses.dataclass
class Finding:
    """One analyzer verdict: where, which pass, which rule, and why.

    ``key`` is the *stable identity* used for allowlist matching —
    a symbol/site/knob name, never a line number (lines drift with
    every edit; a justified exception should survive reformatting)."""

    pass_name: str
    file: str
    line: int
    code: str
    key: str
    why: str

    def as_dict(self) -> dict:
        return {
            "pass": self.pass_name,
            "file": self.file,
            "line": self.line,
            "code": self.code,
            "key": self.key,
            "why": self.why,
        }

    def __str__(self) -> str:
        return (f"{self.file}:{self.line}: [{self.pass_name}/"
                f"{self.code}] {self.key}: {self.why}")


class RepoTree:
    """Parsed view of the repo for the passes.

    ``files`` maps repo-relative posix paths to source text; parsed
    ASTs (with parent links) are cached per path.  Files that fail to
    parse surface as a ``parse-error`` finding from every pass that
    asks for them rather than crashing the gate."""

    #: source roots the real gate loads, relative to the repo root,
    #: and the prefixes a loaded file must have
    PY_ROOTS = (PKG.rstrip("/"), "tests")
    PY_PREFIXES = (PKG, TESTS)
    PY_TOP = ("chip_smoke.py",)

    def __init__(self, files: dict[str, str],
                 readme: str | None = None):
        self.files = dict(files)
        self.readme = readme
        self._asts: dict[str, ast.AST | None] = {}
        self.parse_errors: list[tuple[str, str]] = []
        #: cross-pass scratch cache keyed by pass-chosen names (the
        #: thread-safety pass parks its whole-program lock graph here
        #: so ``static_graph``/``--lock-graph`` don't recompute it);
        #: scoped to THIS tree, so fixtures never see stale facts
        self.memo: dict = {}

    @classmethod
    def from_disk(cls, root: str) -> "RepoTree":
        files: dict[str, str] = {}
        for top in cls.PY_ROOTS:
            base = os.path.join(root, top)
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"]
                for fn in sorted(filenames):
                    if not fn.endswith(".py"):
                        continue
                    path = os.path.join(dirpath, fn)
                    rel = os.path.relpath(path, root).replace(os.sep, "/")
                    if not rel.startswith(cls.PY_PREFIXES):
                        continue
                    with open(path, encoding="utf-8") as f:
                        files[rel] = f.read()
        for fn in cls.PY_TOP:
            path = os.path.join(root, fn)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    files[fn] = f.read()
        readme = None
        rp = os.path.join(root, "README.md")
        if os.path.exists(rp):
            with open(rp, encoding="utf-8") as f:
                readme = f.read()
        return cls(files, readme)

    # -- selection -------------------------------------------------------

    def paths(self, prefix: str = "") -> list[str]:
        return sorted(p for p in self.files if p.startswith(prefix))

    def module(self, path: str) -> ast.AST | None:
        """Parsed AST (with parent links) or None on syntax error."""
        if path not in self._asts:
            try:
                tree = ast.parse(self.files[path], filename=path)
            except SyntaxError as e:
                self._asts[path] = None
                self.parse_errors.append((path, str(e)))
            else:
                attach_parents(tree)
                self._asts[path] = tree
        return self._asts[path]

    def modules(self, prefix: str = ""):
        """Yield ``(path, ast)`` for every parseable file under
        ``prefix``."""
        for p in self.paths(prefix):
            t = self.module(p)
            if t is not None:
                yield p, t


def attach_parents(tree: ast.AST) -> ast.AST:
    """Set ``node._tpq_parent`` on every node (None at the root)."""
    tree._tpq_parent = None  # type: ignore[attr-defined]
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._tpq_parent = node  # type: ignore[attr-defined]
    return tree


def ancestors(node: ast.AST):
    """Yield parents from the immediate one up to the module."""
    cur = getattr(node, "_tpq_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_tpq_parent", None)


def enclosing_function(node: ast.AST):
    """The nearest enclosing FunctionDef/AsyncFunctionDef, or None."""
    for a in ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return a
    return None


def call_name(call: ast.Call) -> str | None:
    """The bare callee name: ``f(...)`` -> "f", ``a.b.f(...)`` -> "f"."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def const_str(node) -> str | None:
    """The literal string value of a Constant node, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
