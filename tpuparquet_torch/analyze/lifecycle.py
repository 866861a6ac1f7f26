"""Resource-lifecycle pass: what is acquired must be released.

The round-8 ``FileReader`` fd leak and the round-18 torn-tmp sweep
are one bug class: a resource acquired (file descriptor, arena lease,
disk-cache tmp, ring segment) with a raise-able path between the
acquire and the release — or no release at all.  This pass finds the
acquire sites structurally and requires each to be one of:

* managed — ``with open(...)`` / ``with closing(v)`` / ``with v:``;
* released on ALL paths — the release call sits in a ``finally`` or
  an ``except`` handler (release-on-error exists), or nothing that
  can raise runs between the acquire and the release;
* ownership-transferred — the handle is returned/yielded, stored on
  ``self``/a container, or passed into a call that takes it over;
* or allowlisted with a reason (the arena pool's documented
  drop-lease-on-error escape hatch is the intended tenant).

Constructors get their own rule (``ctor-leak-on-error``): a resource
bound to ``self`` in ``__init__`` followed by top-level statements
that can raise OUTSIDE a try that closes it leaks the handle on a
failed construction — ``__init__`` raising means nobody ever holds
the instance to close it.

Handle *registries* get a third rule (``container-leak``): an acquire
stored into a container attribute — ``self._handles[key] = open(...)``,
the ``DatasetWriter`` shape — transfers ownership to the OBJECT, not
to the enclosing function, so the function-local rules above cannot
see it.  The transfer is legitimate only when some *other* method of
the owning class drains the registry (references the container attr
and performs a release call — a ``_release()``/``close()`` that
iterates the dict closing each handle).  A class that fills such a
registry and never drains it leaks every entry.

Acquire vocabulary: ``open``, ``os.open``, ``os.fdopen``,
``tempfile.mkstemp``, ``lease_arena``, ``.lease()``.  Release
vocabulary: ``.close()``, ``.release()``, ``os.close``,
``return_arena``, ``give_back``.
"""

from __future__ import annotations

import ast

from .astutil import PKG, Finding, RepoTree, ancestors

PASS = "resource-lifecycle"

_ACQ_NAMES = ("open", "lease_arena", "mkstemp", "lease")
_ACQ_ATTRS = {("os", "open"), ("os", "fdopen"),
              ("tempfile", "mkstemp")}
_REL_METHODS = ("close", "release")
_REL_FUNCS = ("return_arena", "give_back")
_REL_ATTRS = {("os", "close")}


def _is_acquire(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id in _ACQ_NAMES
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) and \
                (f.value.id, f.attr) in _ACQ_ATTRS:
            return True
        return f.attr == "lease"
    return False


def _uses(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(node))


def _is_release_of(node: ast.AST, name: str) -> bool:
    """Does this subtree release local ``name``?"""
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if isinstance(f, ast.Attribute) and f.attr in _REL_METHODS \
                and _uses(f.value, name):
            return True
        if isinstance(f, ast.Name) and f.id in _REL_FUNCS and \
                any(_uses(a, name) for a in n.args):
            return True
        if isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) and \
                (f.value.id, f.attr) in _REL_ATTRS and \
                any(_uses(a, name) for a in n.args):
            return True
    return False


def _escapes(fn, name: str, after_line: int) -> bool:
    """Ownership leaves the function: returned/yielded, stored on an
    attribute/container, or handed to a non-release call."""
    for n in ast.walk(fn):
        if getattr(n, "lineno", 0) < after_line:
            continue
        if isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom)) and \
                n.value is not None and _uses(n.value, name):
            return True
        if isinstance(n, ast.Assign) and _uses(n.value, name):
            for t in n.targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    return True
        if isinstance(n, ast.Call):
            f = n.func
            is_rel = (isinstance(f, ast.Attribute)
                      and f.attr in _REL_METHODS) or \
                (isinstance(f, ast.Name) and f.id in _REL_FUNCS)
            if is_rel:
                continue
            args = list(n.args) + [kw.value for kw in n.keywords]
            if any(_uses(a, name) for a in args):
                return True
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                any(_uses(s, name) for s in n.body):
            return True  # captured by a closure: lifetime is its own
    return False


def _with_managed(fn, name: str) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.With):
            for item in n.items:
                if _uses(item.context_expr, name):
                    return True
    return False


def _protected_release(fn, name: str) -> bool:
    """A release of ``name`` exists on an error path: in a
    ``finally`` block or an ``except`` handler."""
    for n in ast.walk(fn):
        if isinstance(n, ast.Try):
            if any(_is_release_of(s, name) for s in n.finalbody):
                return True
            for h in n.handlers:
                if any(_is_release_of(s, name) for s in h.body):
                    return True
    return False


def _risky(stmt: ast.stmt) -> bool:
    """Can this statement raise for a reason the analyzer should care
    about?  Any call or explicit raise counts; plain attribute/const
    assignments do not."""
    for n in ast.walk(stmt):
        if isinstance(n, (ast.Call, ast.Raise, ast.Assert)):
            return True
    return False


def _body_of(stmt: ast.stmt):
    """The statement list that directly contains ``stmt``."""
    parent = getattr(stmt, "_tpq_parent", None)
    if parent is None:
        return None
    for field in ("body", "orelse", "finalbody"):
        seq = getattr(parent, field, None)
        if isinstance(seq, list) and stmt in seq:
            return seq
    if isinstance(parent, ast.ExceptHandler) and stmt in parent.body:
        return parent.body
    return None


def _stmt_of(node: ast.AST) -> ast.stmt | None:
    cur = node
    for a in ancestors(node):
        if isinstance(cur, ast.stmt) and _body_of(cur) is not None:
            return cur
        cur = a
    return cur if isinstance(cur, ast.stmt) else None


def _check_local(fn, fname, path, stmt, name, findings) -> None:
    line = stmt.lineno
    if _with_managed(fn, name):
        return
    released = any(
        _is_release_of(n, name) for n in ast.walk(fn)
        if isinstance(n, ast.stmt) and getattr(n, "lineno", 0) >= line
        and n is not stmt)
    if not released:
        if _escapes(fn, name, line):
            return
        findings.append(Finding(
            PASS, path, line, "unreleased-acquire",
            f"{fname}:{name}",
            f"{name} acquired in {fname}() is never released, "
            f"returned, stored, or handed off — the handle leaks on "
            f"every path"))
        return
    if _protected_release(fn, name):
        return
    # released, but only on the straight-line path: any raise-able
    # statement between acquire and release leaks it
    siblings = _body_of(stmt)
    risky_between = False
    if siblings is not None:
        started = False
        for s in siblings:
            if s is stmt:
                started = True
                continue
            if not started:
                continue
            if _is_release_of(s, name):
                break
            if _risky(s):
                risky_between = True
                break
    if risky_between:
        findings.append(Finding(
            PASS, path, line, "leak-on-error", f"{fname}:{name}",
            f"{name} acquired in {fname}() is released only on the "
            f"no-error path — a raise between the acquire and the "
            f"release leaks the handle; move the release to a "
            f"finally (or use a with-block)"))


def _check_ctor(cls_name, init, path, stmt, attr, findings) -> None:
    """``self.attr = open(...)`` in __init__: later top-level risky
    statements must live inside a try that closes it on error."""
    line = stmt.lineno

    def releases_attr(node) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute):
                # self.attr.close() or self.close()
                f = n.func
                if f.attr in _REL_METHODS:
                    v = f.value
                    if isinstance(v, ast.Attribute) and \
                            v.attr == attr:
                        return True
                    if isinstance(v, ast.Name) and v.id == "self":
                        return True
                if f.attr.startswith("close") and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == "self":
                    return True
        return False

    def protected(try_node: ast.Try) -> bool:
        if any(releases_attr(s) for s in try_node.finalbody):
            return True
        return any(releases_attr(s) for h in try_node.handlers
                   for s in h.body)

    started = False
    for s in init.body:
        if s is stmt or (getattr(s, "lineno", 0) == line
                         and not started):
            started = True
            if s is stmt:
                continue
        if not started:
            continue
        if isinstance(s, ast.Try) and protected(s):
            return  # everything past here is guarded
        if s is not stmt and _risky(s):
            findings.append(Finding(
                PASS, path, s.lineno, "ctor-leak-on-error",
                f"{cls_name}.__init__:{attr}",
                f"self.{attr} holds a live handle but this statement "
                f"can raise before any try/close guard — a failed "
                f"{cls_name}() leaks the handle, since no caller "
                f"ever receives the instance to close it"))
            return


def _check_container(cls_node, cls_name, acq_fn, path, stmt, attr,
                     findings) -> None:
    """``self.attr[key] = open(...)``: directory-scoped ownership
    transfer.  Legitimate only when another method of the class
    drains the registry — references ``self.attr`` and performs a
    release call in the same body."""
    for m in cls_node.body:
        if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or m is acq_fn:
            continue
        refs_container = any(
            isinstance(n, ast.Attribute) and n.attr == attr
            and isinstance(n.value, ast.Name) and n.value.id == "self"
            for n in ast.walk(m))
        if not refs_container:
            continue
        releases = any(
            isinstance(n, ast.Call)
            and ((isinstance(n.func, ast.Attribute)
                  and n.func.attr in _REL_METHODS)
                 or (isinstance(n.func, ast.Name)
                     and n.func.id in _REL_FUNCS)
                 or (isinstance(n.func, ast.Attribute)
                     and isinstance(n.func.value, ast.Name)
                     and (n.func.value.id, n.func.attr) in _REL_ATTRS))
            for n in ast.walk(m))
        if releases:
            return
    findings.append(Finding(
        PASS, path, stmt.lineno, "container-leak",
        f"{cls_name}:{attr}",
        f"handles stored into registry self.{attr} in "
        f"{acq_fn.name}() are never drained — no other method of "
        f"{cls_name} references the container and releases; every "
        f"entry leaks when the instance is dropped"))


def run(tree: RepoTree) -> list[Finding]:
    findings: list[Finding] = []
    for path, mod in tree.modules(PKG):
        for fn in ast.walk(mod):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            cls = None
            parent = getattr(fn, "_tpq_parent", None)
            if isinstance(parent, ast.ClassDef):
                cls = parent.name
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)
                        and _is_acquire(node.value)
                        and len(node.targets) == 1):
                    continue
                stmt = _stmt_of(node)
                if stmt is None:
                    continue
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    # skip when assigned inside a with-item scope of
                    # the same statement handled structurally
                    _check_local(fn, fn.name, path, stmt, t.id,
                                 findings)
                elif isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self" and \
                        fn.name == "__init__" and cls is not None:
                    _check_ctor(cls, fn, path, stmt, t.attr, findings)
                elif isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Attribute) and \
                        isinstance(t.value.value, ast.Name) and \
                        t.value.value.id == "self" and \
                        cls is not None:
                    _check_container(parent, cls, fn, path, stmt,
                                     t.value.attr, findings)
    return findings
