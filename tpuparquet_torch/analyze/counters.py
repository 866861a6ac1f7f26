"""Counter-registry pass: every stats counter is declared, merged,
and alive.

The exactness story of the package's ``stats.py`` rests on three sets
staying equal by hand: the ``DecodeStats`` dataclass fields, the
``_MERGE_FIELDS`` tuple the worker/allgather fold iterates (a literal,
or the dataclass fields less a literal set of special names, which the
pass evaluates), and the
``st.<counter> += n`` bump sites scattered through the tree.  A
counter missing from ``_MERGE_FIELDS`` silently drops every count a
worker thread or remote host contributes; a bump on an undeclared
name raises only on the rare path that reaches it; a declared counter
nobody bumps is dead weight that ``as_dict``/Prometheus report as
forever-zero.  This pass proves the three-way equality statically.

Bump-site detection: any ``<name>.<field> += n`` where ``<field>`` is
a declared DecodeStats field counts (the repo's collector variables
are consistently st-like: ``st``/``_st``/``_cs``/``ws``); typo
protection additionally tracks variables assigned from
``current_stats()``/``worker_stats()``/``adopt_stats()`` and flags
AugAssigns on those receivers whose attribute is NOT a declared
field.  Dynamic bumps (``setattr(st, counter, ...)``) are credited by
the counter-name string literal, so ``retry_transient``'s
``counter="io_retries"`` contract keeps those counters alive.
"""

from __future__ import annotations

import ast

from .astutil import PKG, Finding, RepoTree, const_str, enclosing_function

PASS = "counters"

#: DecodeStats fields owned by the scope itself or merged specially —
#: everything else must ride _MERGE_FIELDS to survive the fold
SPECIAL_FIELDS = frozenset({"wall_s", "_t0", "hists", "events"})

#: names a collector variable is assigned from
_ST_FACTORIES = frozenset({"current_stats", "worker_stats",
                           "adopt_stats", "collect_stats"})

STATS_PATH = PKG + "stats.py"


def _tuple_of_strs(node) -> list[str] | None:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            s = const_str(e)
            if s is None:
                return None
            out.append(s)
        return out
    return None


def _fields_less(node) -> list[str] | None:
    """The excluded names of ``tuple(f.name for f in
    fields(DecodeStats) if f.name not in (<names>))``, the form that
    derives the merge tuple from the dataclass, else None."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "tuple" and len(node.args) == 1
            and isinstance(node.args[0], ast.GeneratorExp)):
        return None
    gen = node.args[0]
    if len(gen.generators) != 1:
        return None
    comp = gen.generators[0]
    it = comp.iter
    if not (isinstance(comp.target, ast.Name)
            and isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
            and it.func.id == "fields" and len(it.args) == 1
            and isinstance(it.args[0], ast.Name)
            and it.args[0].id == "DecodeStats"):
        return None
    var = comp.target.id

    def is_name_of_var(e) -> bool:
        return (isinstance(e, ast.Attribute) and e.attr == "name"
                and isinstance(e.value, ast.Name) and e.value.id == var)

    if not is_name_of_var(gen.elt) or len(comp.ifs) != 1:
        return None
    cond = comp.ifs[0]
    if not (isinstance(cond, ast.Compare) and len(cond.ops) == 1
            and isinstance(cond.ops[0], ast.NotIn)
            and is_name_of_var(cond.left)):
        return None
    return _tuple_of_strs(cond.comparators[0])


def read_registry(tree: RepoTree) -> dict | None:
    """Extract the declared/merged/fault-field sets from stats.py.
    ``_MERGE_FIELDS`` is a literal tuple (in ``DecodeStats`` or at
    module level) or the dataclass fields less a literal set of names.
    Returns None (with a finding emitted by :func:`run`) when the
    module shape is unrecognizable."""
    mod = tree.module(STATS_PATH) if STATS_PATH in tree.files else None
    if mod is None:
        return None
    decl: dict[str, int] = {}
    merge: list[str] = []
    merge_line = 0
    excluded = None
    fault: list[str] = []
    fault_line = 0
    for node in ast.walk(mod):
        if isinstance(node, ast.ClassDef) and node.name == "DecodeStats":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name):
                    decl[stmt.target.id] = stmt.lineno
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if not isinstance(tgt, ast.Name):
                    continue
                if tgt.id == "_MERGE_FIELDS":
                    merge = _tuple_of_strs(node.value) or []
                    excluded = _fields_less(node.value)
                    merge_line = node.lineno
                elif tgt.id == "_FAULT_OBSERVABILITY_FIELDS":
                    fault = _tuple_of_strs(node.value) or []
                    fault_line = node.lineno
    if excluded is not None:
        merge = [n for n in decl if n not in excluded]
    if not decl or not merge:
        return None
    return {"declared": decl, "merge": merge, "merge_line": merge_line,
            "fault": fault, "fault_line": fault_line}


def _st_like_vars(fn) -> set[str]:
    """Variable names in ``fn`` bound from a collector factory:
    ``st = current_stats()``, ``with worker_stats() as ws``."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call):
            callee = node.value.func
            name = callee.attr if isinstance(callee, ast.Attribute) \
                else callee.id if isinstance(callee, ast.Name) else None
            if name in _ST_FACTORIES:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
        elif isinstance(node, ast.With):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call):
                    name = (ctx.func.attr
                            if isinstance(ctx.func, ast.Attribute)
                            else ctx.func.id
                            if isinstance(ctx.func, ast.Name) else None)
                    if name in _ST_FACTORIES and \
                            isinstance(item.optional_vars, ast.Name):
                        out.add(item.optional_vars.id)
    return out


def run(tree: RepoTree) -> list[Finding]:
    findings: list[Finding] = []
    reg = read_registry(tree)
    if reg is None:
        findings.append(Finding(
            PASS, STATS_PATH, 1, "registry-unreadable", "DecodeStats",
            "could not extract DecodeStats fields / _MERGE_FIELDS "
            "from stats.py — the pass has nothing to check against"))
        return findings
    declared = reg["declared"]
    counters = set(declared) - SPECIAL_FIELDS
    merge = reg["merge"]
    merge_set = set(merge)

    # 1) declared <-> merged equality
    for name in sorted(counters - merge_set):
        findings.append(Finding(
            PASS, STATS_PATH, declared[name], "unmerged-counter", name,
            f"DecodeStats.{name} is declared but missing from "
            f"_MERGE_FIELDS — worker-thread and cross-host folds "
            f"silently drop it"))
    for name in sorted(merge_set - set(declared)):
        findings.append(Finding(
            PASS, STATS_PATH, reg["merge_line"], "merge-of-undeclared",
            name,
            f"_MERGE_FIELDS names {name!r} which DecodeStats does not "
            f"declare — merge_from would raise AttributeError"))
    dupes = {n for n in merge if merge.count(n) > 1}
    for name in sorted(dupes):
        findings.append(Finding(
            PASS, STATS_PATH, reg["merge_line"], "merge-duplicate",
            name,
            f"_MERGE_FIELDS lists {name!r} more than once — the fold "
            f"would double-count it"))

    # 2) fault-observability fields must survive the merge fold
    for name in sorted(set(reg["fault"]) - merge_set):
        findings.append(Finding(
            PASS, STATS_PATH, reg["fault_line"], "fault-field-unmerged",
            name,
            f"_FAULT_OBSERVABILITY_FIELDS names {name!r} which is not "
            f"in _MERGE_FIELDS — failed-attempt folds would diverge "
            f"from successful ones"))

    # 3) bump sites across the library
    bumped: set[str] = set()
    literals: set[str] = set()
    for path, mod in tree.modules(PKG):
        st_vars_cache: dict[int, set[str]] = {}
        for node in ast.walk(mod):
            if path != STATS_PATH:
                s = const_str(node)
                if s is not None and s in counters:
                    literals.add(s)
            if not isinstance(node, ast.AugAssign):
                continue
            tgt = node.target
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id not in ("self", "cls")):
                continue
            attr = tgt.attr
            if attr in counters:
                bumped.add(attr)
                continue
            if attr in SPECIAL_FIELDS:
                findings.append(Finding(
                    PASS, path, node.lineno, "bump-of-special", attr,
                    f"augmented assignment to DecodeStats.{attr} — "
                    f"this field is owned by the scope/merge machinery "
                    f"and must never be bumped at a site"))
                continue
            # typo guard: only when the receiver provably came from a
            # collector factory in this function
            fn = enclosing_function(node)
            if fn is None:
                continue
            key = id(fn)
            if key not in st_vars_cache:
                st_vars_cache[key] = _st_like_vars(fn)
            if tgt.value.id in st_vars_cache[key]:
                findings.append(Finding(
                    PASS, path, node.lineno, "undeclared-counter-bump",
                    attr,
                    f"{tgt.value.id}.{attr} += ... bumps a field "
                    f"DecodeStats does not declare — a typo'd counter "
                    f"that only fails on the path that reaches it"))

    # 4) liveness: every merged counter has a bump site or a dynamic
    #    (string-literal) reference
    for name in sorted(merge_set & counters):
        if name not in bumped and name not in literals:
            findings.append(Finding(
                PASS, STATS_PATH, declared.get(name, reg["merge_line"]),
                "dead-counter", name,
                f"DecodeStats.{name} is declared and merged but no "
                f"site in {PKG} ever bumps or names it — dead "
                f"weight reported as forever-zero"))
    return findings
