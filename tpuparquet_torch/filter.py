"""Predicate pushdown: filter expressions, pruning, late materialization.

The port of ``tpuparquet/filter.py``.  A small expression layer (column
comparisons, ``IN``, null tests, ``&``/``|``) is evaluated at three
escalating costs:

1. **Chunk statistics** (:func:`may_match_stats`): the footer's per-chunk
   min/max/null_count prove many row groups hold no matching row; those
   are dropped before scan units form.  Bloom filters
   (``format/bloom.py``) refute ``==`` and ``IN`` probes at the same
   level.
2. **Page index** (:func:`candidate_mask`): the ``ColumnIndex``/
   ``OffsetIndex`` written after the row groups narrow the candidate rows
   to the pages whose bounds admit a match.  Conservative by
   construction: a page or a chunk is skipped only when no row of it can
   match.
3. **Exact evaluation** (:func:`evaluate_exact`): the filter's columns
   decode first on the host (late materialization), the predicate runs
   exactly on their values, and only the surviving rows of the other
   columns are gathered (:func:`gather_chunk_rows`), so a filtered read
   equals a full decode followed by a post-filter, bit for bit.

Semantics are SQL's: comparisons and ``IN`` match only non-null values;
``is_null``/``not_null`` test validity; NaN compares as IEEE does (never
equal, never ordered, so ``!=`` is never pruned from float statistics:
NaN rows match it invisibly to min/max).

Usage::

    from tpuparquet_torch.filter import col
    f = (col("price") > 100.0) & col("vendor").isin(["A", "B"])
    ShardedScan(paths, "price", "vendor", "ts", filter=f)

Every pruning decision counts in ``DecodeStats``: ``row_groups_pruned``,
``pages_pruned``, ``rows_pruned``, ``bloom_hits``, ``filter_rows_in``
and ``filter_rows_out``.  ``TPQ_PRUNE=0`` turns every metadata skip off
(:func:`prune_enabled`).
"""

from __future__ import annotations

import os

import numpy as np

from .cpu.plain import ByteArrayColumn
from .format.metadata import Type
from .io.chunk import ChunkData, read_chunk
from .io.values import handler_for
from .stats import current_stats

__all__ = [
    "col", "Col", "Filter", "Cmp", "In", "IsNull", "And", "Or",
    "bind_filter", "prune_enabled", "parse_filter",
    "may_match_stats", "candidate_mask", "evaluate_exact",
    "chunk_stats_tuple", "row_group_stats", "prune_row_group_stats",
    "gather_chunk_rows", "PruneVerdict", "read_row_group_filtered",
]


def parse_filter(expr: str) -> "Filter":
    """Parse a small textual predicate:
    comparisons ``name OP literal`` (OP in ``== != <= >= < >``),
    ``name in (a, b, c)``, ``name is null`` / ``name is not null``,
    joined by ``&`` / ``|`` with parentheses.  Literals: ints, floats,
    single/double-quoted strings.  Example::

        parse_filter("price > 100 & vendor in ('A','B')")
    """
    import re

    tokens = re.findall(
        r"\(|\)|&|\||==|!=|<=|>=|<|>|,|'[^']*'|\"[^\"]*\""
        r"|[A-Za-z_][\w.]*|-?\d+\.\d*(?:[eE][-+]?\d+)?|-?\.\d+"
        r"|-?\d+(?:[eE][-+]?\d+)?|\S", expr)
    pos = [0]

    def peek():
        return tokens[pos[0]] if pos[0] < len(tokens) else None

    def take(expect=None):
        t = peek()
        if t is None or (expect is not None and t != expect):
            raise ValueError(
                f"filter syntax error at token {pos[0]} "
                f"({t!r}, expected {expect!r}) in {expr!r}")
        pos[0] += 1
        return t

    def literal(t):
        if t and t[0] in "'\"":
            return t[1:-1]
        try:
            return int(t)
        except ValueError:
            return float(t)

    def atom():
        if peek() == "(":
            take("(")
            node = disjunction()
            take(")")
            return node
        name = take()
        if not re.fullmatch(r"[A-Za-z_][\w.]*", name):
            raise ValueError(f"expected a column name, got {name!r}")
        t = take()
        if t == "is":
            if peek() == "not":
                take("not")
                take("null")
                return IsNull(name, True)
            take("null")
            return IsNull(name, False)
        if t == "in":
            take("(")
            vals = [literal(take())]
            while peek() == ",":
                take(",")
                vals.append(literal(take()))
            take(")")
            return In(name, vals)
        if t not in _CMP_OPS:
            raise ValueError(f"unknown operator {t!r} in {expr!r}")
        return Cmp(name, t, literal(take()))

    def conjunction():
        node = atom()
        while peek() == "&":
            take("&")
            node = node & atom()
        return node

    def disjunction():
        node = conjunction()
        while peek() == "|":
            take("|")
            node = node | conjunction()
        return node

    node = disjunction()
    if pos[0] != len(tokens):
        raise ValueError(
            f"trailing tokens {tokens[pos[0]:]!r} in filter {expr!r}")
    return node


def prune_enabled() -> bool:
    """Read-side static pruning gate (``TPQ_PRUNE``, default on).
    ``TPQ_PRUNE=0`` disables every metadata-driven skip: filters then
    apply by exact evaluation over a full decode (the results are the
    same either way)."""
    return os.environ.get("TPQ_PRUNE", "1") != "0"

_CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")


class Filter:
    """Base predicate node.  Compose with ``&`` (and) / ``|`` (or)."""

    def __and__(self, other):
        return And([self, other])

    def __or__(self, other):
        return Or([self, other])

    def columns(self) -> set:
        raise NotImplementedError

    def __repr__(self):
        return self.describe()

    def describe(self) -> str:
        raise NotImplementedError


class Col:
    """A column reference; comparison operators build predicates."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __eq__(self, v):  # noqa: A003 - predicate builder, not identity
        return Cmp(self.name, "==", v)

    def __ne__(self, v):
        return Cmp(self.name, "!=", v)

    def __lt__(self, v):
        return Cmp(self.name, "<", v)

    def __le__(self, v):
        return Cmp(self.name, "<=", v)

    def __gt__(self, v):
        return Cmp(self.name, ">", v)

    def __ge__(self, v):
        return Cmp(self.name, ">=", v)

    def isin(self, values):
        return In(self.name, list(values))

    def is_null(self):
        return IsNull(self.name, False)

    def not_null(self):
        return IsNull(self.name, True)

    def __hash__(self):  # __eq__ is a builder; keep Col hashable
        return hash(self.name)


def col(name: str) -> Col:
    """Entry point: ``col("x") > 5``, ``col("s").isin([...])`` ..."""
    return Col(name)


class _Leaf(Filter):
    __slots__ = ("column", "_h")

    def columns(self) -> set:
        return {self.column}


class Cmp(_Leaf):
    # _stored/_logical are filled by bind_filter
    __slots__ = ("op", "value", "_stored", "_logical")

    def __init__(self, column: str, op: str, value):
        if op not in _CMP_OPS:
            raise ValueError(f"unknown comparison {op!r}")
        if value is None:
            raise ValueError(
                "comparisons never match NULL; use col().is_null() / "
                "not_null() to test validity")
        self.column = column
        self.op = op
        self.value = value
        self._h = None

    def describe(self) -> str:
        return f"({self.column} {self.op} {self.value!r})"


class In(_Leaf):
    # _stored/_logical are filled by bind_filter
    __slots__ = ("values", "_stored", "_logical")

    def __init__(self, column: str, values):
        vals = list(values)
        if not vals:
            raise ValueError("IN () matches nothing; build it explicitly"
                             " if you mean that")
        if any(v is None for v in vals):
            raise ValueError("IN never matches NULL; use is_null()")
        self.column = column
        self.values = vals
        self._h = None

    def describe(self) -> str:
        return f"({self.column} in {self.values!r})"


class IsNull(_Leaf):
    __slots__ = ("invert",)

    def __init__(self, column: str, invert: bool):
        self.column = column
        self.invert = invert  # True = NOT NULL
        self._h = None

    def describe(self) -> str:
        return f"({self.column} is {'not ' if self.invert else ''}null)"


class _Junction(Filter):
    __slots__ = ("parts",)

    def __init__(self, parts):
        flat = []
        for p in parts:
            if not isinstance(p, Filter):
                raise TypeError(
                    f"filter parts must be Filter nodes, not "
                    f"{type(p).__name__}")
            if type(p) is type(self):
                flat.extend(p.parts)
            else:
                flat.append(p)
        if not flat:
            raise ValueError("empty filter junction")
        self.parts = flat

    def columns(self) -> set:
        out = set()
        for p in self.parts:
            out |= p.columns()
        return out


class And(_Junction):
    def describe(self) -> str:
        return "(" + " & ".join(p.describe() for p in self.parts) + ")"


class Or(_Junction):
    def describe(self) -> str:
        return "(" + " | ".join(p.describe() for p in self.parts) + ")"


# ----------------------------------------------------------------------
# Binding: resolve columns against a schema, coerce predicate values
# ----------------------------------------------------------------------

def _coerce_leaf_value(handler, v):
    """Coerce one predicate constant to the column's comparison domain:
    the STORAGE value for bloom/array compares plus the LOGICAL value
    for statistics compares.  Returns (storage, logical)."""
    stored = handler.coerce_one(v)
    logical = stored
    if handler.unsigned and handler.ptype in (Type.INT32, Type.INT64):
        width = 32 if handler.ptype == Type.INT32 else 64
        logical = stored + (1 << width) if stored < 0 else stored
    if handler.ptype in (Type.FLOAT, Type.DOUBLE):
        # compare in the column's own precision: a float32 column's
        # values round-trip through float32, so the constant must too
        # (0.1 != float32(0.1) in float64)
        logical = float(np.float32(stored)) \
            if handler.ptype == Type.FLOAT else float(stored)
        stored = logical
    return stored, logical


def bind_filter(f: Filter, schema) -> Filter:
    """Validate a filter against a file's schema (in place, idempotent):
    every referenced column must be a NON-REPEATED leaf (filters
    evaluate row-wise; list semantics are out of scope), and leaf
    constants are coerced to the column's type once.  Returns ``f``.

    Raises ``ValueError`` for unknown/repeated columns, ``TypeError``
    for constants the column cannot hold — at bind time, before any
    decode work."""
    for leaf, _ in _walk_leaves(f):
        node = schema.leaf(leaf.column)
        if node is None:
            raise ValueError(
                f"filter references unknown column {leaf.column!r}")
        if node.max_rep_level:
            raise ValueError(
                f"filter column {leaf.column!r} is repeated; filters "
                "evaluate row-wise on non-repeated columns")
        h = handler_for(node.element)
        if h.ptype == Type.INT96 and not isinstance(leaf, IsNull):
            raise ValueError(
                f"filter column {leaf.column!r} is INT96, whose "
                "ordering the spec leaves undefined")
        leaf._h = h
        if isinstance(leaf, Cmp):
            leaf._stored, leaf._logical = _coerce_leaf_value(h, leaf.value)
        elif isinstance(leaf, In):
            pairs = [_coerce_leaf_value(h, v) for v in leaf.values]
            leaf._stored = [p[0] for p in pairs]
            leaf._logical = [p[1] for p in pairs]
    return f


def _walk_leaves(f: Filter):
    """Yield ``(leaf, negated_context)`` pairs — context unused today
    (no NOT node) but keeps the walk shape future-proof."""
    if isinstance(f, _Junction):
        for p in f.parts:
            yield from _walk_leaves(p)
    else:
        yield f, False


# ----------------------------------------------------------------------
# Level 1: chunk statistics (and bloom) — may this row group match?
# ----------------------------------------------------------------------

def _range_may_match(leaf, mn, mx, null_count, num_values) -> bool:
    """Conservative leaf verdict from a min/max/null_count summary.
    ``mn``/``mx`` are decoded LOGICAL values (None = unknown);
    ``null_count`` None = unknown.  True = cannot rule a match out."""
    if num_values is not None and num_values == 0:
        return False  # nothing there matches anything
    if isinstance(leaf, IsNull):
        if leaf.invert:  # NOT NULL: any non-null value?
            if null_count is not None and num_values is not None:
                return num_values - null_count > 0
            return True
        if null_count is not None:
            return null_count > 0
        return True
    # Cmp / In match only non-null values
    if null_count is not None and num_values is not None \
            and null_count == num_values:
        return False  # all null
    if mn is None or mx is None:
        return True  # no usable bounds
    if isinstance(leaf, In):
        return any(mn <= v <= mx for v in leaf._logical)
    v = leaf._logical
    op = leaf.op
    if op == "==":
        return mn <= v <= mx
    if op == "!=":
        # floats: NaN rows match != but are invisible to min/max —
        # never prune.  Other types: all non-null equal v => no match.
        if leaf._h is not None and leaf._h.ptype in (Type.FLOAT,
                                                     Type.DOUBLE):
            return True
        return not (mn == mx == v)
    if op == "<":
        return mn < v
    if op == "<=":
        return mn <= v
    if op == ">":
        return mx > v
    if op == ">=":
        return mx >= v
    raise AssertionError(op)


def chunk_stats_tuple(cm, handler):
    """Decode one chunk's ``Statistics`` into the logical summary
    ``(mn, mx, null_count, num_values)`` the leaf verdicts consume.
    Prefers min_value/max_value (v2 fields, typed order) and falls
    back to the deprecated signed min/max only where those are sound
    (signed numeric columns)."""
    st = cm.statistics
    num = cm.num_values
    if st is None:
        return None, None, None, num
    if not handler.stats_bytewise_comparable():
        # DECIMAL byte columns: stats sort numerically, predicates
        # compare bytewise — bounds are unusable, null_count is not
        return None, None, st.null_count, num
    mn_b, mx_b = st.min_value, st.max_value
    if mn_b is None and mx_b is None and not handler.unsigned \
            and handler.ptype not in (Type.BYTE_ARRAY,
                                      Type.FIXED_LEN_BYTE_ARRAY):
        mn_b, mx_b = st.min, st.max
    mn = handler.decode_stat_logical(mn_b) if mn_b is not None else None
    mx = handler.decode_stat_logical(mx_b) if mx_b is not None else None
    return mn, mx, st.null_count, num


def may_match_stats(f: Filter, stats_by_col: dict,
                    bloom_probe=None) -> bool:
    """May any row of a row group match ``f``?  ``stats_by_col`` maps
    column name -> ``(mn, mx, null_count, num_values)`` (absent column
    = no information).  ``bloom_probe(column, stored_values) -> bool``
    optionally refutes equality leaves: False = every probed value is
    definitely absent (the caller counts ``bloom_hits``)."""
    if isinstance(f, And):
        return all(may_match_stats(p, stats_by_col, bloom_probe)
                   for p in f.parts)
    if isinstance(f, Or):
        return any(may_match_stats(p, stats_by_col, bloom_probe)
                   for p in f.parts)
    summary = stats_by_col.get(f.column)
    if summary is not None:
        if not _range_may_match(f, *summary):
            return False
    if bloom_probe is not None and isinstance(f, (Cmp, In)):
        if isinstance(f, Cmp) and f.op == "==":
            probes = [f._stored]
        elif isinstance(f, In):
            probes = f._stored
        else:
            probes = None
        if probes is not None and bloom_probe(f.column, probes) is False:
            return False
    return True


def row_group_stats(rg, schema, wanted) -> dict:
    """``{column: (mn, mx, null_count, num_values)}`` for the
    ``wanted`` columns of one row group — the shared stats-gathering
    loop behind :func:`prune_row_group_stats` and
    ``FileReader.prune_row_group``."""
    stats = {}
    for cc in rg.columns:
        cm = cc.meta_data
        path = ".".join(cm.path_in_schema)
        if path not in wanted:
            continue
        node = schema.leaf(path)
        if node is None:
            continue
        stats[path] = chunk_stats_tuple(cm, handler_for(node.element))
    return stats


def prune_row_group_stats(f: Filter, rg, schema) -> bool:
    """True when chunk ``Statistics`` prove NO row of ``rg`` matches —
    the metadata-only verdict for callers without a reader (no bloom /
    page-index access).  ``f`` must be bound (:func:`bind_filter`)."""
    return not may_match_stats(f, row_group_stats(rg, schema,
                                                  f.columns()))


# ----------------------------------------------------------------------
# Level 2: page index — which rows may match?
# ----------------------------------------------------------------------

def candidate_mask(f: Filter, pages_by_col: dict,
                   num_rows: int) -> np.ndarray:
    """Boolean mask over the row group's rows: True where the page
    index cannot rule a match out.  ``pages_by_col`` maps column name
    -> list of ``(row_start, row_end, mn, mx, null_count, null_page)``
    per data page (absent column / None = no index = all rows may
    match).  Page summaries use the same conservative leaf verdicts as
    the chunk level, so the mask is a superset of the true matches."""
    if isinstance(f, And):
        m = candidate_mask(f.parts[0], pages_by_col, num_rows)
        for p in f.parts[1:]:
            m &= candidate_mask(p, pages_by_col, num_rows)
        return m
    if isinstance(f, Or):
        m = candidate_mask(f.parts[0], pages_by_col, num_rows)
        for p in f.parts[1:]:
            m |= candidate_mask(p, pages_by_col, num_rows)
        return m
    pages = pages_by_col.get(f.column)
    if pages is None:
        return np.ones(num_rows, dtype=bool)
    m = np.zeros(num_rows, dtype=bool)
    for r0, r1, mn, mx, nulls, null_page in pages:
        if null_page:
            may = isinstance(f, IsNull) and not f.invert
        else:
            may = _range_may_match(f, mn, mx, nulls, r1 - r0)
        if may:
            m[max(r0, 0):min(r1, num_rows)] = True
    return m


# ----------------------------------------------------------------------
# Level 3: exact evaluation on decoded filter columns
# ----------------------------------------------------------------------

def _cmp_array(handler, arr, op, stored):
    """Elementwise compare of a packed fixed-width value array."""
    if handler.unsigned and handler.ptype in (Type.INT32, Type.INT64):
        arr = arr.view(np.uint32 if handler.ptype == Type.INT32
                       else np.uint64)
        stored = stored & ((1 << (32 if handler.ptype == Type.INT32
                                  else 64)) - 1)
    if handler.ptype == Type.FIXED_LEN_BYTE_ARRAY:
        return _bytes_rows_cmp(arr, op, stored)
    if op == "==":
        return arr == stored
    if op == "!=":
        return arr != stored
    if op == "<":
        return arr < stored
    if op == "<=":
        return arr <= stored
    if op == ">":
        return arr > stored
    if op == ">=":
        return arr >= stored
    raise AssertionError(op)


def _bytes_rows_cmp(rows: np.ndarray, op: str, v: bytes):
    """Compare (N, L) fixed byte rows against a constant, bytewise
    unsigned (the FLBA sort order)."""
    vals = [bytes(r) for r in rows]
    return _py_cmp_list(vals, op, v)


def _py_cmp_list(vals, op, v):
    import operator as _op

    fn = {"==": _op.eq, "!=": _op.ne, "<": _op.lt, "<=": _op.le,
          ">": _op.gt, ">=": _op.ge}[op]
    return np.fromiter((fn(x, v) for x in vals), dtype=bool,
                       count=len(vals))


def _ba_eq_mask(col: ByteArrayColumn, v: bytes) -> np.ndarray:
    """Vectorized equality of a ByteArrayColumn against one constant."""
    offs = np.asarray(col.offsets, dtype=np.int64)
    data = np.asarray(col.data)
    lens = offs[1:] - offs[:-1]
    out = lens == len(v)
    if len(v) and out.any():
        starts = offs[:-1][out]
        rows = data[starts[:, None] + np.arange(len(v), dtype=np.int64)]
        out[out.copy()] = (rows == np.frombuffer(v, np.uint8)).all(axis=1)
    return out


def _ba_cmp(colv: ByteArrayColumn, op: str, v: bytes) -> np.ndarray:
    if op == "==":
        return _ba_eq_mask(colv, v)
    if op == "!=":
        return ~_ba_eq_mask(colv, v)
    # ordering: bytewise lexicographic; per-value Python compare (the
    # ordered-predicate-on-strings case is rare and test-sized)
    return _py_cmp_list(colv.to_list(), op, v)


def _leaf_exact(leaf, packed, valid) -> np.ndarray:
    """Row-domain bool mask for one leaf: ``packed`` holds the valid
    rows' values in row order, ``valid`` the row-aligned validity."""
    n = valid.shape[0]
    if isinstance(leaf, IsNull):
        return valid.copy() if leaf.invert else ~valid
    out = np.zeros(n, dtype=bool)
    if packed is None or (hasattr(packed, "__len__")
                          and len(packed) == 0):
        return out
    h = leaf._h
    if isinstance(packed, ByteArrayColumn):
        if isinstance(leaf, In):
            sub = np.zeros(len(packed), dtype=bool)
            for v in leaf._stored:
                sub |= _ba_eq_mask(packed, v)
        else:
            sub = _ba_cmp(packed, leaf.op, leaf._stored)
    else:
        arr = np.asarray(packed)
        if isinstance(leaf, In):
            sub = np.zeros(arr.shape[0], dtype=bool)
            for v in leaf._stored:
                sub |= np.asarray(_cmp_array(h, arr, "==", v))
        else:
            sub = np.asarray(_cmp_array(h, arr, leaf.op, leaf._stored))
    out[valid] = sub
    return out


def evaluate_exact(f: Filter, cols: dict, num_rows: int) -> np.ndarray:
    """Exact row mask over a shared row domain.  ``cols`` maps column
    name -> ``(packed_values, valid)`` where ``valid`` is a bool array
    of ``num_rows`` and ``packed_values`` holds the values of the
    valid rows in row order (ndarray, (N, L) byte rows, or
    :class:`ByteArrayColumn`)."""
    if isinstance(f, And):
        m = evaluate_exact(f.parts[0], cols, num_rows)
        for p in f.parts[1:]:
            if not m.any():
                break
            m &= evaluate_exact(p, cols, num_rows)
        return m
    if isinstance(f, Or):
        m = evaluate_exact(f.parts[0], cols, num_rows)
        for p in f.parts[1:]:
            if m.all():
                break
            m |= evaluate_exact(p, cols, num_rows)
        return m
    packed, valid = cols[f.column]
    return _leaf_exact(f, packed, valid)


# ----------------------------------------------------------------------
# Late materialization: gather surviving rows out of decoded chunks
# ----------------------------------------------------------------------

def _gather_bytes(colv: ByteArrayColumn, vidx: np.ndarray):
    offs = np.asarray(colv.offsets, dtype=np.int64)
    data = np.asarray(colv.data)
    lens = (offs[1:] - offs[:-1])[vidx]
    starts = offs[:-1][vidx]
    new_offs = np.zeros(vidx.size + 1, dtype=np.int64)
    np.cumsum(lens, out=new_offs[1:])
    total = int(new_offs[-1])
    if total == 0:
        return ByteArrayColumn(new_offs, np.zeros(0, dtype=np.uint8))
    # vectorized variable-length gather: absolute source index per
    # output byte = repeat(starts) + (arange - repeat(dest starts))
    rep_starts = np.repeat(starts, lens)
    rep_dest = np.repeat(new_offs[:-1], lens)
    idx = rep_starts + (np.arange(total, dtype=np.int64) - rep_dest)
    return ByteArrayColumn(new_offs, data[idx])


def gather_chunk_rows(cd, node, sel: np.ndarray):
    """Gather selected ROWS (records) out of a decoded chunk.

    ``cd`` is an :class:`~tpuparquet_torch.io.chunk.ChunkData`; ``sel`` the
    sorted local row indices to keep.  Handles flat columns (one slot
    per row) and repeated columns (records bounded by rep==0 slots).
    Returns a new ChunkData holding exactly the selected records,
    bit-identical to post-filtering a full decode."""
    sel = np.asarray(sel, dtype=np.int64)
    dl = cd.def_levels
    rep = cd.rep_levels
    max_def = node.max_def_level
    if node.max_rep_level and rep.size:
        starts = np.flatnonzero(rep == 0)
        bounds = np.concatenate([starts, [dl.size]])
        slot_lens = (bounds[1:] - bounds[:-1])[sel]
        slot_starts = bounds[:-1][sel]
        total = int(slot_lens.sum())
        rep_starts = np.repeat(slot_starts, slot_lens)
        rep_dest = np.repeat(np.cumsum(slot_lens) - slot_lens, slot_lens)
        slots = rep_starts + (np.arange(total, dtype=np.int64) - rep_dest)
    else:
        slots = sel
    new_dl = dl[slots] if dl.size else dl[:0]
    new_rep = rep[slots] if rep.size else rep[:0]
    if max_def:
        valid = dl == max_def
        pidx = np.cumsum(valid) - 1
        vsel = valid[slots]
        vidx = pidx[slots][vsel].astype(np.int64)
    else:
        vidx = slots
    vals = cd.values
    if isinstance(vals, ByteArrayColumn):
        new_vals = _gather_bytes(vals, vidx)
    else:
        new_vals = np.asarray(vals)[vidx]
    null_count = int((new_dl != max_def).sum()) if max_def else 0
    return ChunkData(new_vals, new_rep, new_dl, null_count)


class PruneVerdict:
    """One row group's pruning outcome: ``skip`` (no row can match),
    the static ``candidate`` row mask (page-index level, None = all),
    and the counters the decision earned.  ``reason`` names the layer
    that proved the skip ("stats" / "bloom" / "pages" / "exact")."""

    __slots__ = ("skip", "reason", "candidate", "pages_by_col",
                 "bloom_hits")

    def __init__(self, skip=False, reason=None, candidate=None,
                 pages_by_col=None, bloom_hits=0):
        self.skip = skip
        self.reason = reason
        self.candidate = candidate
        self.pages_by_col = pages_by_col or {}
        self.bloom_hits = bloom_hits


# ----------------------------------------------------------------------
# The filtered row-group decode (late materialization)
# ----------------------------------------------------------------------

def _empty_chunks(reader, rg):
    """Schema-shaped zero-row output for a fully pruned row group."""
    out = {}
    for path, node, _cm in reader.selected_chunks(rg):
        out[path] = ChunkData(
            handler_for(node.element).finalize([]),
            np.empty(0, dtype=np.int32), np.empty(0, dtype=np.int32), 0)
    return out


def read_row_group_filtered(reader, rg_index: int, f: Filter,
                            verdict: PruneVerdict | None = None):
    """Decode one row group under a filter, late-materialized.

    Three escalating stages, every one conservative until the last:

    1. the static verdict (chunk stats → bloom → page index) may prove
       the whole row group empty — nothing is read;
    2. the FILTER columns decode first, skipping pages outside the
       candidate row set (``read_chunk(keep_rows=)``), and the
       predicate evaluates exactly on candidate rows;
    3. only then do the remaining projected columns decode — pages
       holding no surviving row are skipped — and every column gathers
       exactly the surviving rows.

    Returns ``(chunks, surviving_rows)``: ``chunks`` maps each SELECTED
    column to a :class:`~tpuparquet_torch.io.chunk.ChunkData` holding exactly
    the surviving rows (bit-identical to a full decode followed by a
    post-filter), ``surviving_rows`` the sorted local row indices.
    Counters: ``row_groups_pruned``/``rows_pruned``/``pages_pruned``/
    ``filter_rows_in``/``filter_rows_out`` on the active collector."""
    from .io.reader import _rebase

    bind_filter(f, reader.schema)
    rg = reader.meta.row_groups[rg_index]
    num_rows = rg.num_rows
    st = current_stats()
    if verdict is None:
        verdict = reader.prune_row_group(f, rg_index)
        if st is not None and verdict.bloom_hits:
            st.bloom_hits += verdict.bloom_hits
    if verdict.skip:
        if st is not None:
            st.row_groups_pruned += 1
            st.rows_pruned += num_rows
        return _empty_chunks(reader, rg), np.empty(0, dtype=np.int64)

    cand = verdict.candidate  # bool mask over rows, or None = all
    cand_rows = (np.flatnonzero(cand) if cand is not None
                 else np.arange(num_rows, dtype=np.int64))
    if st is not None and cand is not None:
        st.rows_pruned += num_rows - cand_rows.size

    cms = {".".join(cc.meta_data.path_in_schema): cc.meta_data
           for cc in rg.columns}
    verify_crc = reader.verify_crc

    def _decode(path, keep):
        cm = cms[path]
        node = reader.schema.leaf(path)
        blob, start = reader.chunk_blob(cm, path)
        cmr = _rebase(cm, start)
        if keep is not None and not node.max_rep_level:
            cd, kept = read_chunk(memoryview(blob), cmr, node,
                                  verify_crc=verify_crc, keep_rows=keep)
        else:
            cd = read_chunk(memoryview(blob), cmr, node,
                            verify_crc=verify_crc)
            kept = np.arange(num_rows, dtype=np.int64)
        return node, cd, kept

    # stage 2: filter columns decode first, predicate runs exactly on
    # the candidate rows (kept is a page-granular superset of cand).  A
    # byte-range source fetches the chunks each stage reads first,
    # coalesced: the filter columns here, the other columns below
    fcols = sorted(f.columns())
    reader.prefetch_ranges([
        (reader._chunk_start(cms[p]), cms[p].total_compressed_size, p)
        for p in fcols if p in cms])
    decoded = {}
    for path in fcols:
        if path not in cms:
            raise ValueError(
                f"filter references column {path!r} absent from row "
                f"group {rg_index}")
        decoded[path] = _decode(path, cand)
    cols_eval = {}
    for path, (node, cd, kept) in decoded.items():
        loc = np.searchsorted(kept, cand_rows)
        sub = (cd if cand_rows.size == num_rows
               and kept.size == num_rows
               else gather_chunk_rows(cd, node, loc))
        valid = (sub.def_levels == node.max_def_level
                 if node.max_def_level
                 else np.ones(cand_rows.size, dtype=bool))
        cols_eval[path] = (sub.values, valid)
    mask = evaluate_exact(f, cols_eval, cand_rows.size)
    surviving = cand_rows[mask]
    if st is not None:
        st.filter_rows_in += cand_rows.size
        st.filter_rows_out += int(surviving.size)

    # stage 3: gather survivors; undecoded columns skip pages that
    # hold none of them
    keep2 = None
    if surviving.size < num_rows:
        keep2 = np.zeros(num_rows, dtype=bool)
        keep2[surviving] = True
    out = {}
    sel = reader.selected_chunks(rg)
    reader.prefetch_ranges([
        (reader._chunk_start(cm), cm.total_compressed_size, p)
        for p, _n, cm in sel if p not in decoded])
    for path, node, _cm in sel:
        if path in decoded:
            node, cd, kept = decoded[path]
        else:
            node, cd, kept = _decode(path, keep2)
        if surviving.size == num_rows and kept.size == num_rows:
            out[path] = cd  # everything survived: the decode IS the answer
            continue
        loc = np.searchsorted(kept, surviving)
        out[path] = gather_chunk_rows(cd, node, loc)
    return out, surviving
