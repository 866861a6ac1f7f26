"""Repetition and definition levels of a LIST column from offsets, and
the host decoders and encoders of level streams: the hybrid RLE stream
of a V1 page (4-byte length prefix) or of a V2 page (no prefix), and the
deprecated BIT_PACKED encoding.

The columnar form of one repeated level (the standard 3-level ``optional
group f (LIST) { repeated group list { element } }``, or a bare repeated
leaf): ``offsets`` (``n_rows + 1`` slot ranges), an optional row mask
(null rows, whose ranges must be empty) and an optional element mask
(null elements).  Each row takes ``max(count, 1)`` level slots: an empty
row keeps one placeholder slot at the repeated node's ``max_def - 1``, a
null row at ``max_def - 2``; a null element sits one below the leaf's
``max_def``.  A LIST of structs whose element group is optional also
takes a group-null mask: a null element group sits one definition
level below a present element with null fields.  The JAX package's
writer derives its levels by the same rules
(``FileWriter._prepare_repeated``).
"""

from __future__ import annotations

import numpy as np

from .bitpack import unpack_msb
from .hybrid import (as_uint32, decode_hybrid, decode_hybrid_prefixed,
                     encode_hybrid, encode_hybrid_prefixed)

__all__ = ["bit_width", "decode_levels_bitpacked", "decode_levels_raw",
           "decode_levels_v1", "encode_levels_v1", "encode_levels_v2",
           "list_levels", "null_mask"]


def bit_width(max_level: int) -> int:
    """Bits needed for levels ``0..max_level``."""
    return int(max_level).bit_length()


def _checked(levels: np.ndarray, max_level: int) -> np.ndarray:
    out = levels.astype(np.int32)
    if out.size and out.max() > max_level:
        raise ValueError(f"level value {int(out.max())} exceeds max level "
                         f"{max_level}")
    return out


def decode_levels_v1(data, count: int, max_level: int, pos: int = 0):
    """A V1 page's length-prefixed hybrid level stream at ``pos``:
    ``(int32 levels, end position)``; ``max_level == 0`` has no stream.
    Raises ValueError on a level above ``max_level``."""
    if max_level == 0:
        return np.zeros(count, dtype=np.int32), pos
    vals, end = decode_hybrid_prefixed(data, count,
                                       int(max_level).bit_length(), pos)
    return _checked(vals, max_level), end


def decode_levels_raw(data, count: int, max_level: int) -> np.ndarray:
    """A V2 page's hybrid level stream (no prefix: ``data`` is exactly
    the stream) as int32."""
    if max_level == 0:
        return np.zeros(count, dtype=np.int32)
    return _checked(decode_hybrid(data, count, int(max_level).bit_length()),
                    max_level)


def encode_levels_v1(levels, max_level: int) -> bytes:
    """A V1 page's level stream: hybrid, with its 4-byte length prefix
    (empty when ``max_level == 0``)."""
    if max_level == 0:
        return b""
    return encode_hybrid_prefixed(as_uint32(levels), bit_width(max_level))


def encode_levels_v2(levels, max_level: int) -> bytes:
    """A V2 page's level stream: hybrid, no prefix."""
    if max_level == 0:
        return b""
    return encode_hybrid(as_uint32(levels), bit_width(max_level))


def null_mask(def_levels: np.ndarray, max_def: int) -> np.ndarray:
    """True where a value is present (non-null) at this leaf."""
    if max_def == 0:
        return np.ones(len(def_levels), dtype=bool)
    return np.asarray(def_levels) == max_def


def decode_levels_bitpacked(data, count: int, max_level: int) -> np.ndarray:
    """Deprecated BIT_PACKED (MSB-first) levels at the width of
    ``max_level``, as int32; raises ValueError on a level above
    ``max_level`` or a short stream."""
    if max_level == 0:
        return np.zeros(count, dtype=np.int32)
    return _checked(unpack_msb(data, count, int(max_level).bit_length()),
                    max_level)


def _repeated_ancestor(leaf):
    """The repeated node on the leaf's path, and the optional group
    strictly between it and the leaf (None when there is none)."""
    node, rep_node, elem_opt = leaf, None, None
    while node is not None:
        if node.is_repeated:
            rep_node = node
        elif (node is not leaf and rep_node is None
              and not node.is_required and node.parent is not None):
            elem_opt = node
        node = node.parent
    return rep_node, elem_opt


def list_levels(leaf, offsets, row_mask=None, elem_mask=None,
                group_null=None):
    """``(rep, def, n_rows, n_values)`` of one LIST leaf: int32 level
    arrays over every slot, the row count and the count of non-null
    elements the column's values must hold.  ``group_null`` (one bool a
    element, True where the element group is null) needs an optional
    group between the repeated node and the leaf.  Raises ValueError on
    inconsistent input, as the JAX writer does."""
    rep_node, elem_opt = _repeated_ancestor(leaf)
    if leaf.max_rep_level != 1 or rep_node is None:
        raise ValueError(
            f"column {leaf.flat_name!r}: write_columns supports one "
            "repeated level; use add_data for deeper nesting")
    offs = np.asarray(offsets).astype(np.int64, copy=False)
    if offs.ndim != 1 or offs.size == 0 or (np.diff(offs) < 0).any() \
            or offs[0] != 0:
        raise ValueError("offsets must be monotone and start at 0")
    counts = np.diff(offs)
    n_rows = counts.size
    if row_mask is not None:
        row_mask = np.asarray(row_mask, dtype=bool)
        if row_mask.size != n_rows:
            raise ValueError("row mask length != offsets rows")
        if rep_node.max_def_level < 2:
            raise ValueError(
                f"column {leaf.path[0]!r} has no optional ancestor; a row "
                "mask is not allowed")
        if (counts[~row_mask] != 0).any():
            raise ValueError("null rows must have empty offset ranges")
    slots = np.maximum(counts, 1)
    first = np.cumsum(slots) - slots
    total = int(slots.sum())
    rep = np.full(total, leaf.max_rep_level, dtype=np.int32)
    rep[first] = 0
    dl = np.full(total, leaf.max_def_level, dtype=np.int32)
    placeholder = first[counts == 0]
    dl[placeholder] = rep_node.max_def_level - 1
    if row_mask is not None:
        dl[first[~row_mask]] = rep_node.max_def_level - 2
    n_elems = int(offs[-1])
    if group_null is not None:
        if elem_opt is None:
            raise ValueError(
                f"column {leaf.flat_name!r}: no optional element group on "
                "the path; a group-null mask is not allowed")
        group_null = np.asarray(group_null, dtype=bool)
        if group_null.size != n_elems:
            raise ValueError("group-null mask length != total elements")
    if elem_mask is None and group_null is None:
        return rep, dl, n_rows, n_elems
    valid = np.ones(n_elems, dtype=bool)
    dl_elems = np.full(n_elems, leaf.max_def_level, dtype=np.int32)
    if elem_mask is not None:
        elem_mask = np.asarray(elem_mask, dtype=bool)
        if elem_mask.size != n_elems:
            raise ValueError("element mask length != total elements")
        # the leaf must be optional: its def sits one above the innermost
        # optional ancestor, or a mask would write a schema-violating file
        floor_def = (elem_opt.max_def_level if elem_opt is not None
                     else rep_node.max_def_level)
        if leaf.max_def_level == floor_def:
            raise ValueError(f"column {leaf.flat_name!r}: element is "
                             "required; an element mask is not allowed")
        dl_elems[~elem_mask] = leaf.max_def_level - 1
        valid &= elem_mask
    if group_null is not None:
        # a null element group sits below any field-level null
        dl_elems[group_null] = elem_opt.max_def_level - 1
        valid &= ~group_null
    elem_slots = np.ones(total, dtype=bool)
    elem_slots[placeholder] = False
    dl[elem_slots] = dl_elems
    return rep, dl, n_rows, int(valid.sum())
