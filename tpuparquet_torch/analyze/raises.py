"""Exception-taxonomy pass: raises speak the repo's error language.

The package's ``errors.py`` defines the structured taxonomy — ScanError
coordinates (file / row group / column / page), corrupt-vs-transient
classification, quarantine membership — and the repo's discipline is
"inner layers raise what they know; outer layers annotate":

* decode/validation internals raise the PLAIN vocabulary
  (``ValueError``/``EOFError``/``TypeError``…, which
  ``QUARANTINE_ERRORS`` classifies) or a taxonomy error;
* I/O and dispatch layers raise taxonomy errors CARRYING coordinates,
  so a quarantine report can name the exact page without re-reading;
* nothing raises the classes that defeat classification —
  bare ``Exception``, ``RuntimeError``, raw ``OSError`` and friends —
  because ``is_transient``/``QUARANTINE_ERRORS``/``on_error`` policy
  cannot route what they cannot type.

This pass walks every ``raise`` in the package and requires:

* ``non-taxonomy-raise`` — the raised class is not a taxonomy error,
  not part of the plain quarantine/API vocabulary, and not a builtin
  with defined routing: justify it in the allowlist or retype it;
* ``taxonomy-no-coords`` — a ``ScanError``-family constructor call
  outside an ``except`` handler (the annotate path) that passes NO
  coordinate kwargs: the error will surface with nothing for the
  quarantine report to pinpoint;
* ``unknown-exception-class`` — a raise of a name the analyzer can
  see neither in builtins, the taxonomy, nor the repo.
"""

from __future__ import annotations

import ast
import builtins

from .astutil import PKG, Finding, RepoTree, ancestors, call_name, \
    enclosing_function

PASS = "exception-taxonomy"

_ERRORS_PATH = PKG + "errors.py"
#: kwargs that count as coordinates (``offset`` is the footer
#: taxonomy's byte coordinate, same pinpointing role)
_COORD_KWARGS = ("file", "row_group", "column", "page", "offset")

#: the plain inner-layer vocabulary: QUARANTINE_ERRORS members plus
#: the API-misuse classes calling code is expected to let propagate
_ALLOWED_BUILTINS = frozenset({
    "ValueError", "TypeError", "KeyError", "IndexError", "EOFError",
    "NotImplementedError", "AssertionError", "StopIteration",
    "StopAsyncIteration", "AttributeError", "OverflowError",
    "ZeroDivisionError", "ArithmeticError", "LookupError",
    "UnicodeDecodeError", "UnicodeEncodeError", "MemoryError",
    "FileNotFoundError", "FileExistsError", "PermissionError",
    "IsADirectoryError", "NotADirectoryError", "ImportError",
    "ModuleNotFoundError", "KeyboardInterrupt", "SystemExit",
})

#: classes that defeat transient/quarantine classification
_FLAGGED = frozenset({
    "Exception", "BaseException", "RuntimeError", "SystemError",
    "OSError", "IOError", "EnvironmentError", "ConnectionError",
    "ConnectionResetError", "ConnectionAbortedError",
    "ConnectionRefusedError", "BrokenPipeError", "TimeoutError",
    "InterruptedError", "BlockingIOError",
})


def _taxonomy(tree: RepoTree):
    """(all taxonomy class names, the ScanError-family subset) from
    parsing errors.py — never from importing it."""
    mod = tree.module(_ERRORS_PATH) if _ERRORS_PATH in tree.files \
        else None
    if mod is None:
        return frozenset(), frozenset()
    bases: dict[str, list[str]] = {}
    for node in mod.body:
        if isinstance(node, ast.ClassDef):
            bases[node.name] = [b.id for b in node.bases
                                if isinstance(b, ast.Name)]

    def in_family(name: str, _seen=frozenset()) -> bool:
        if name == "ScanError":
            return True
        if name in _seen or name not in bases:
            return False
        return any(in_family(b, _seen | {name})
                   for b in bases[name])

    names = frozenset(n for n in bases if not n.startswith("_"))
    family = frozenset(n for n in names if in_family(n))
    return names, family


def _repo_bases(tree: RepoTree) -> dict:
    """name -> base names for every class defined in the package."""
    out: dict[str, list[str]] = {}
    for path, mod in tree.modules(PKG):
        for node in ast.walk(mod):
            if isinstance(node, ast.ClassDef):
                names = []
                for b in node.bases:
                    if isinstance(b, ast.Name):
                        names.append(b.id)
                    elif isinstance(b, ast.Attribute):
                        names.append(b.attr)
                out[node.name] = names
    return out


def _reaches(name: str, targets, bases: dict,
             _seen: frozenset = frozenset()) -> bool:
    """Does ``name``'s base closure reach any of ``targets``?"""
    if name in targets:
        return True
    if name in _seen or name not in bases:
        return False
    return any(_reaches(b, targets, bases, _seen | {name})
               for b in bases[name])


def _module_aliases(mod, known) -> dict:
    """Module-level ``NewName = KnownError`` re-exports (the
    footer.py ``FormatError = CorruptFooterError`` pattern)."""
    out: dict[str, str] = {}
    for node in mod.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in known:
            out[node.targets[0].id] = node.value.id
    return out


def _raised_name(exc) -> str | None:
    if isinstance(exc, ast.Call):
        return call_name(exc)
    if isinstance(exc, ast.Name):
        return exc.id
    if isinstance(exc, ast.Attribute):
        return exc.attr
    return None


def _has_coords(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg is None or kw.arg in _COORD_KWARGS:
            return True
    return False


def _in_except(node) -> bool:
    return any(isinstance(a, ast.ExceptHandler)
               for a in ancestors(node))


def _handler_names(handler: ast.ExceptHandler):
    t = handler.type
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in elts:
        if isinstance(e, ast.Name):
            yield e.id
        elif isinstance(e, ast.Attribute):
            yield e.attr


def _annotated_on_exit(node, family) -> bool:
    """Is this raise inside a ``try`` whose handler catches the
    family (or a base wide enough to) and annotates on the way out?
    That is the chunk-reader discipline: inner raises are bare, the
    enclosing handler stamps column/page once for all of them."""
    catchers = set(family) | {"ScanError", "ValueError", "Exception"}
    for a in ancestors(node):
        if isinstance(a, ast.Try):
            for h in a.handlers:
                if h.type is not None and \
                        catchers.intersection(_handler_names(h)):
                    return True
    return False


def run(tree: RepoTree) -> list[Finding]:
    taxonomy, scan_family = _taxonomy(tree)
    repo_bases = _repo_bases(tree)
    known = taxonomy | frozenset(repo_bases)
    findings: list[Finding] = []
    # aliases declared in errors.py itself are taxonomy re-exports —
    # visible to every raising module, not just errors.py
    err_aliases: dict[str, str] = {}
    if _ERRORS_PATH in tree.files:
        err_aliases = _module_aliases(tree.module(_ERRORS_PATH), known)
    for path, mod in tree.modules(PKG):
        aliases = dict(err_aliases)
        aliases.update(_module_aliases(mod, known))
        for node in ast.walk(mod):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            name = _raised_name(node.exc)
            if name is None:
                continue
            # lowercase name: a re-raise of a caught/boxed exception
            # object (``raise err``, ``raise errors.get(0)``) or an
            # exception-factory call (``raise error(...)``,
            # ``raise annotate(e, ...)``) — the class was typed where
            # the factory/box was filled, not here
            if not name[:1].isupper():
                continue
            name = aliases.get(name, name)
            fn = enclosing_function(node)
            fname = fn.name if fn is not None else "<module>"
            key = f"{fname}:{name}"
            in_family = name in scan_family or (
                name not in taxonomy
                and _reaches(name, ("ScanError",), repo_bases))
            if name in taxonomy or in_family:
                if in_family and \
                        isinstance(node.exc, ast.Call) and \
                        path != _ERRORS_PATH and \
                        not _in_except(node) and \
                        not _has_coords(node.exc) and \
                        not _annotated_on_exit(node, scan_family):
                    findings.append(Finding(
                        PASS, path, node.lineno, "taxonomy-no-coords",
                        key,
                        f"{name} raised in {fname}() with no "
                        f"coordinate kwargs (file/row_group/column/"
                        f"page/offset), outside an annotate path — "
                        f"the quarantine report will have nothing to "
                        f"pinpoint; pass what this layer knows"))
                continue
            if name in _FLAGGED or (
                    name in repo_bases
                    and _reaches(name, _FLAGGED, repo_bases)):
                findings.append(Finding(
                    PASS, path, node.lineno, "non-taxonomy-raise",
                    key,
                    f"raise {name} in {fname}() — is_transient/"
                    f"QUARANTINE_ERRORS/on_error policy cannot "
                    f"classify it; raise a taxonomy error from "
                    f"errors.py (or allowlist with the reason this "
                    f"path is outside scan/error routing)"))
                continue
            if name in _ALLOWED_BUILTINS:
                continue
            bi = getattr(builtins, name, None)
            if isinstance(bi, type) and \
                    issubclass(bi, BaseException):
                continue  # an un-flagged builtin: defined routing
            if name in repo_bases:
                # a repo class whose base closure reaches the plain
                # vocabulary (CompressionError(ValueError), ThriftError
                # (ValueError), …) IS classifiable — QUARANTINE_ERRORS
                # catches it by its builtin base
                if _reaches(name, _ALLOWED_BUILTINS, repo_bases):
                    continue
                findings.append(Finding(
                    PASS, path, node.lineno, "non-taxonomy-raise",
                    key,
                    f"raise {name} in {fname}() — a repo class "
                    f"outside the errors.py taxonomy with no "
                    f"classifiable builtin base; scan error routing "
                    f"cannot type it (move it into the taxonomy or "
                    f"allowlist with the reason)"))
                continue
            findings.append(Finding(
                PASS, path, node.lineno, "unknown-exception-class",
                key,
                f"raise {name} in {fname}() — a class the analyzer "
                f"finds neither in builtins, errors.py, nor the "
                f"repo; likely an unimported or misspelled name"))
    return findings
