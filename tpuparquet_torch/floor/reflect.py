"""Dataclass <-> row-dict reflection against a Parquet schema tree.

The object mapper walks dataclass fields with their ``typing`` hints
(``Optional[T]``, ``T | None``, ``list[T]``, ``dict[K, V]``, nested
dataclasses); the schema element's logical or converted type drives
each value's conversion (strings, DATE, TIME, TIMESTAMP, INT96, UUID,
the LIST and MAP conventions), so objects round-trip through the row
shape the file layer takes.  :func:`objects_to_columns` and
:func:`objects_from_columns` do the same for whole row groups through
the columnar writer and the host decode.

``schema_of`` derives a schema definition from a dataclass; explicit
schemas work as well.
"""

from __future__ import annotations

import dataclasses
import datetime
import types
import typing
import uuid

from ..format.dsl import _unit_name
from ..format.metadata import ConvertedType, Type
from ..format.schema import SchemaNode
from ..int96_time import datetime_to_int96, int96_to_datetime
from .time import (
    Time,
    time_from_microseconds,
    time_from_milliseconds,
    time_from_nanoseconds,
)

__all__ = ["field_name", "schema_of", "to_row", "from_row",
           "objects_to_columns", "objects_from_columns"]


def field_name(f: dataclasses.Field) -> str:
    """Parquet column name for a dataclass field: ``metadata['parquet']``
    else the lowercased field name."""
    return f.metadata.get("parquet", f.name.lower())


# ----------------------------------------------------------------------
# Schema introspection helpers
# ----------------------------------------------------------------------

_CONVERTED_TO_LOGICAL = {
    ConvertedType.UTF8: ("STRING", None),
    ConvertedType.DATE: ("DATE", None),
    ConvertedType.MAP: ("MAP", None),
    ConvertedType.LIST: ("LIST", None),
    ConvertedType.ENUM: ("ENUM", None),
    ConvertedType.JSON: ("JSON", None),
    ConvertedType.BSON: ("BSON", None),
    ConvertedType.TIME_MILLIS: ("TIME", "MILLIS"),
    ConvertedType.TIME_MICROS: ("TIME", "MICROS"),
    ConvertedType.TIMESTAMP_MILLIS: ("TIMESTAMP", "MILLIS"),
    ConvertedType.TIMESTAMP_MICROS: ("TIMESTAMP", "MICROS"),
}


def _logical(node: SchemaNode) -> tuple[str | None, str | None]:
    """(logical type name, time unit name) for a schema node, merging the
    new-style logical type and the legacy converted type.  Cached on the
    node — schema trees are immutable for the life of a file."""
    cached = getattr(node, "_floor_logical", None)
    if cached is not None:
        return cached
    out = _logical_uncached(node)
    try:
        node._floor_logical = out
    except AttributeError:
        pass  # slotted node: just recompute
    return out


def _logical_uncached(node: SchemaNode) -> tuple[str | None, str | None]:
    el = node.element
    lt = getattr(el, "logicalType", None)
    if lt is not None:
        name, val = lt.set_member()
        if name in ("TIME", "TIMESTAMP") and val is not None:
            return name, _unit_name(val.unit)
        if name is not None:
            return name, None
    ct = getattr(el, "converted_type", None)
    if ct is not None:
        return _CONVERTED_TO_LOGICAL.get(ConvertedType(ct), (None, None))
    return None, None


def _is_list_group(node: SchemaNode) -> bool:
    return (not node.is_leaf and _logical(node)[0] == "LIST"
            and len(node.children) == 1 and node.children[0].is_repeated
            and not node.is_repeated)


def _is_map_group(node: SchemaNode) -> bool:
    return (not node.is_leaf and _logical(node)[0] == "MAP"
            and len(node.children) == 1 and node.children[0].is_repeated
            and len(node.children[0].children) == 2
            and not node.is_repeated)


# ----------------------------------------------------------------------
# Schema derivation from a dataclass
# ----------------------------------------------------------------------

_LEAF_DSL = {
    bool: "boolean {name}",
    int: "int64 {name}",
    float: "double {name}",
    bytes: "binary {name}",
    str: "binary {name} (STRING)",
    datetime.date: "int32 {name} (DATE)",
    datetime.datetime: "int64 {name} (TIMESTAMP(MICROS, true))",
    datetime.time: "int64 {name} (TIME(MICROS, true))",
    Time: "int64 {name} (TIME(MICROS, true))",
    uuid.UUID: "fixed_len_byte_array(16) {name} (UUID)",
}


def _unwrap_optional(hint):
    """(inner_type, is_optional) for Optional[...] / ``T | None`` hints."""
    origin = typing.get_origin(hint)
    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1 and len(typing.get_args(hint)) == 2:
            return args[0], True
    return hint, False


def _field_dsl(name: str, hint, required: bool, indent: str) -> str:
    hint, opt = _unwrap_optional(hint)
    rep = "required" if required and not opt else "optional"
    origin = typing.get_origin(hint)
    if origin in (list, tuple):
        (elem,) = typing.get_args(hint)[:1]
        inner = _field_dsl("element", elem, False, indent + "    ")
        return (f"{indent}{rep} group {name} (LIST) {{\n"
                f"{indent}  repeated group list {{\n"
                f"{indent}    {inner.strip()}\n"
                f"{indent}  }}\n{indent}}}")
    if origin is dict:
        k, v = typing.get_args(hint)
        kd = _field_dsl("key", k, True, indent + "    ")
        vd = _field_dsl("value", v, False, indent + "    ")
        return (f"{indent}{rep} group {name} (MAP) {{\n"
                f"{indent}  repeated group key_value {{\n"
                f"{indent}    {kd.strip()}\n"
                f"{indent}    {vd.strip()}\n"
                f"{indent}  }}\n{indent}}}")
    if dataclasses.is_dataclass(hint):
        body = "".join(
            _field_dsl(field_name(f), h, True, indent + "  ") + "\n"
            for f, h in _dc_fields(hint)
        )
        return f"{indent}{rep} group {name} {{\n{body}{indent}}}"
    for t, tmpl in _LEAF_DSL.items():
        if hint is t:
            return indent + rep + " " + tmpl.format(name=name) + ";"
    raise TypeError(f"cannot derive a Parquet type for field "
                    f"{name!r} with hint {hint!r}")


def _dc_fields(cls):
    hints = typing.get_type_hints(cls)
    return [(f, hints[f.name]) for f in dataclasses.fields(cls)]


def schema_of(cls, name: str = "msg") -> str:
    """Derive a schema-definition DSL string from a dataclass."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a dataclass")
    body = "".join(
        _field_dsl(field_name(f), h, True, "  ") + "\n"
        for f, h in _dc_fields(cls)
    )
    return f"message {name} {{\n{body}}}"


# ----------------------------------------------------------------------
# Object -> row (marshalling)
# ----------------------------------------------------------------------

def to_row(obj, schema) -> dict:
    """Marshal a dataclass instance (or mapping) into the low-level
    nested-dict row shape for ``FileWriter.add_data``."""
    return {
        child.name: _encode(_get_member(obj, child.name), child)
        for child in schema.root.children
        if _has_member(obj, child.name)
    }


def _bulk_list_leaf(schema, leaf) -> "SchemaNode | None":
    """If ``leaf`` sits under a top-level column the bulk columnar paths
    can handle as a Python list — a bare repeated leaf, a 2-level legacy
    list, or the canonical 3-level LIST of a primitive/string — return
    the top-level node; None for shapes the row path must handle
    (multi-leaf groups, maps, deeper nesting)."""
    if leaf.max_rep_level != 1:
        return None
    top = _child_named(schema.root, leaf.path[0])
    if top is None:
        return None
    if top is leaf:  # bare repeated leaf
        return top
    if _is_list_group(top):
        mid = top.children[0]
        if mid is leaf:  # 2-level legacy: repeated leaf is the element
            return top
        if len(mid.children) == 1 and mid.children[0] is leaf:
            return top  # canonical 3-level
    return None


def _bulk_struct_list(schema, top_name: str):
    """If the top-level column ``top_name`` is a list of structs the
    bulk paths can marshal — element leaves are direct, non-repeated
    children of the element group — return ``(top, rep_node, elem_node,
    leaves)``; None otherwise.

    Covered shapes: canonical 3-level LIST whose element is a group,
    and a bare ``repeated group`` element (2-level legacy).  An
    optional element group ships a group-null mask (one def level below
    null fields)."""
    top = _child_named(schema.root, top_name)
    if top is None or top.is_leaf:
        return None
    if _is_list_group(top):
        mid = top.children[0]
        if mid.is_leaf or len(mid.children) != 1:
            return None
        elem = mid.children[0]
        if elem.is_leaf:
            return None
        rep_node = mid
    elif top.is_repeated:  # bare repeated group: the element itself
        elem = top
        rep_node = top
    else:
        return None
    if not elem.children or any(not c.is_leaf for c in elem.children):
        return None
    if any(c.max_rep_level != 1 for c in elem.children):
        return None
    return top, rep_node, elem, list(elem.children)


def objects_to_columns(objs, schema):
    """Bulk columnar extraction: dataclasses/mappings ->
    ``(columns, masks, offsets, element_masks)`` for
    ``FileWriter.write_columns``.

    Skips the per-row dict building + shredding machinery while
    applying the SAME leaf conversions as :func:`to_row`
    (strings, date/time/timestamp units, UUID) — decoded contents are
    identical to the row path; the columnar call writes one row group.
    Flat leaves, STRUCT columns (nested dataclasses/mappings over
    non-repeated groups, emitted as dotted leaf columns + per-group
    masks), MAP columns (dict fields -> (keys, values) per-leaf arrays
    sharing slot offsets), and LIST-of-primitive columns (bare repeated
    leaves, 2-level legacy, canonical 3-level, the shapes the row
    path shreds) are
    supported, as are LIST-of-struct columns (``list[dataclass]``
    fields over a single-repeated-level element group, including
    optional elements via a group-null mask)."""
    leaves = schema.leaves
    list_tops = {}
    struct_leaves = set()
    map_tops = {}  # map top node -> (key leaf, value leaf)
    struct_list_tops = {}  # name -> (top, rep_node, elem, leaves)
    for leaf in leaves:
        if len(leaf.path) == 1 and not leaf.max_rep_level:
            continue
        if not leaf.max_rep_level:
            struct_leaves.add(leaf)  # nested non-repeated groups
            continue
        top = _child_named(schema.root, leaf.path[0])
        if (top is not None and _is_map_group(top)
                and leaf.max_rep_level == 1
                and top.children[0].children[0].is_leaf
                and top.children[0].children[1].is_leaf
                # key must be required: _maps_from_chunks pairs one key
                # per slot; an optional key leaf would misalign streams
                and top.children[0].children[0].is_required):
            kv = top.children[0]
            map_tops[top] = (kv.children[0], kv.children[1])
            continue
        top = _bulk_list_leaf(schema, leaf)
        if top is None:
            sl = _bulk_struct_list(schema, leaf.path[0])
            if sl is not None:
                struct_list_tops[sl[0].name] = sl
                continue
            raise ValueError(
                f"objects_to_columns supports flat schemas, STRUCT, "
                f"MAP, LIST-of-primitive, and LIST-of-struct columns; "
                f"{leaf.flat_name!r} is nested (use write/write_many)")
        list_tops[leaf] = top
    objs = list(objs)
    # per-class parquet-name -> attribute map, computed once (the row
    # path's per-access field scan would cost O(fields) per value here)
    attr_maps: dict = {}

    def getter(o, name):
        if isinstance(o, dict):
            return o.get(name)
        cls = type(o)
        m = attr_maps.get(cls)
        if m is None:
            if not dataclasses.is_dataclass(o):
                raise TypeError(
                    f"cannot marshal {cls.__name__}: expected a "
                    "dataclass or mapping")
            m = {field_name(f): f.name for f in dataclasses.fields(o)}
            attr_maps[cls] = m
        attr = m.get(name)
        return getattr(o, attr) if attr is not None else None

    import numpy as _np

    columns: dict = {}
    masks: dict = {}
    offsets: dict = {}
    element_masks: dict = {}
    # resolved sub-objects per group prefix, shared across the group's
    # leaves so sibling columns see one traversal (and one mask)
    prefix_objs: dict = {}

    def resolve(parts):
        key = ".".join(parts)
        cached = prefix_objs.get(key)
        if cached is not None:
            return cached
        if len(parts) == 1:
            vals = [getter(o, parts[0]) for o in objs]
        else:
            parent = resolve(parts[:-1])
            name = parts[-1]
            vals = [None if p is None else getter(p, name)
                    for p in parent]
        prefix_objs[key] = vals
        return vals

    map_top_by_name = {t.name: t for t in map_tops}
    done_maps: set = set()
    for leaf in leaves:
        sl = (struct_list_tops.get(leaf.path[0])
              if leaf.max_rep_level else None)
        if sl is not None:
            if leaf.path[0] in done_maps:
                continue  # all element leaves marshal together
            done_maps.add(leaf.path[0])
            top, rep_node, elem, elem_leaves = sl
            name = top.name
            elem_optional = elem is not rep_node and not elem.is_required
            pl_vals = {lf.name: [] for lf in elem_leaves}
            pl_mask = {lf.name: [] for lf in elem_leaves}
            enull: list = []  # True = the element group itself is null
            offs = _np.zeros(len(objs) + 1, dtype=_np.int64)
            mask = None
            for i, o in enumerate(objs):
                v = getter(o, name)
                if v is None:
                    # a bare repeated group has no null state: absent
                    # means empty, matching the row path
                    if top is not rep_node and not top.is_required:
                        if mask is None:
                            mask = _np.ones(len(objs), dtype=bool)
                        mask[i] = False
                    elif top is not rep_node:
                        raise ValueError(
                            f"column {name!r} is required but object "
                            f"{i} has no value")
                    offs[i + 1] = offs[i]
                    continue
                offs[i + 1] = offs[i] + len(v)
                for e in v:
                    if e is None:
                        if not elem_optional:
                            raise ValueError(
                                f"column {name!r} element is required "
                                f"but object {i} contains None")
                        enull.append(True)
                        for lf in elem_leaves:
                            # True keeps required-leaf masks all-true
                            # (never emitted); the group-null mask
                            # excludes the slot either way
                            pl_mask[lf.name].append(lf.is_required)
                        continue
                    enull.append(False)
                    for lf in elem_leaves:
                        fv = getter(e, lf.name)
                        if fv is None:
                            if lf.is_required:
                                raise ValueError(
                                    f"{lf.flat_name!r} is required but "
                                    f"an element of object {i} has no "
                                    "value")
                            pl_mask[lf.name].append(False)
                        else:
                            pl_mask[lf.name].append(True)
                            pl_vals[lf.name].append(
                                _encode_leaf(fv, lf))
            columns[name] = tuple(pl_vals[lf.name] for lf in elem_leaves)
            offsets[name] = offs
            if mask is not None:
                masks[name] = mask
            emd = {lf.flat_name: _np.asarray(pl_mask[lf.name],
                                             dtype=bool)
                   for lf in elem_leaves if not all(pl_mask[lf.name])}
            if any(enull):
                emd[elem.flat_name] = _np.asarray(enull, dtype=bool)
            if emd:
                element_masks[name] = emd
            continue
        mtop = (map_top_by_name.get(leaf.path[0])
                if leaf.max_rep_level else None)
        if mtop is not None:
            if mtop.name in done_maps:
                continue  # key and value leaves marshal together
            done_maps.add(mtop.name)
            key_leaf, val_leaf = map_tops[mtop]
            name = mtop.name
            val_optional = not val_leaf.is_required
            keys: list = []
            vals_v: list = []
            vmask: list = []
            offs = _np.zeros(len(objs) + 1, dtype=_np.int64)
            mask = None
            for i, o in enumerate(objs):
                v = getter(o, name)
                if v is None:
                    if not mtop.is_required:
                        if mask is None:
                            mask = _np.ones(len(objs), dtype=bool)
                        mask[i] = False
                    else:
                        raise ValueError(
                            f"column {name!r} is required but object "
                            f"{i} has no value")
                    offs[i + 1] = offs[i]
                    continue
                offs[i + 1] = offs[i] + len(v)
                for k, val in v.items():
                    keys.append(_encode_leaf(k, key_leaf))
                    if val is None:
                        if not val_optional:
                            raise ValueError(
                                f"column {name!r} value is required "
                                f"but object {i} contains None")
                        vmask.append(False)
                    else:
                        vmask.append(True)
                        vals_v.append(_encode_leaf(val, val_leaf))
            columns[name] = (keys, vals_v)
            offsets[name] = offs
            if mask is not None:
                masks[name] = mask
            if not all(vmask):
                element_masks[name] = {
                    val_leaf.flat_name: _np.asarray(vmask, dtype=bool)}
            continue
        top = list_tops.get(leaf)
        if top is not None:
            name = top.name
            elem_optional = not leaf.is_required and not leaf.is_repeated
            vals = []
            offs = _np.zeros(len(objs) + 1, dtype=_np.int64)
            mask = None
            emask = []
            for i, o in enumerate(objs):
                v = getter(o, name)
                if v is None:
                    # a bare repeated leaf has no null state — an absent
                    # value is an empty list, matching the row path
                    if top is not leaf and not top.is_required:
                        if mask is None:
                            mask = _np.ones(len(objs), dtype=bool)
                        mask[i] = False
                    elif top is not leaf:
                        raise ValueError(
                            f"column {name!r} is required but object "
                            f"{i} has no value")
                    offs[i + 1] = offs[i]
                    continue
                offs[i + 1] = offs[i] + len(v)
                for e in v:
                    if e is None:
                        if not elem_optional:
                            raise ValueError(
                                f"column {name!r} element is required "
                                f"but object {i} contains None")
                        emask.append(False)
                    else:
                        emask.append(True)
                        vals.append(_encode_leaf(e, leaf))
            columns[name] = vals
            offsets[name] = offs
            if mask is not None:
                masks[name] = mask
            if not all(emask):
                element_masks[name] = _np.asarray(emask, dtype=bool)
            continue
        if leaf in struct_leaves:
            chain = []
            node = leaf
            while node is not None and node.parent is not None:
                chain.append(node)
                node = node.parent
            chain.reverse()
            # group prefix masks (optional groups only — a required
            # group that is None under a present parent is an error,
            # matching the row-path shredder)
            for depth in range(1, len(chain)):
                gnode = chain[depth - 1]
                parts = [n.name for n in chain[:depth]]
                key = ".".join(parts)
                vals_g = resolve(parts)
                parent_vals = resolve(parts[:-1]) if depth > 1 else None
                if gnode.is_required:
                    for i, v in enumerate(vals_g):
                        if v is None and (parent_vals is None
                                          or parent_vals[i] is not None):
                            raise ValueError(
                                f"group {key!r} is required but object "
                                f"{i} has no value")
                elif key not in masks:
                    masks[key] = _np.fromiter(
                        (v is not None for v in vals_g), dtype=bool,
                        count=len(vals_g))
            parent_vals = resolve([n.name for n in chain[:-1]])
            vals = []
            lmask = _np.ones(len(objs), dtype=bool)
            for i, p in enumerate(parent_vals):
                v = None if p is None else getter(p, leaf.name)
                if v is None:
                    if p is not None and leaf.is_required:
                        raise ValueError(
                            f"column {leaf.flat_name!r} is required but "
                            f"object {i} has no value")
                    lmask[i] = False
                else:
                    vals.append(_encode_leaf(v, leaf))
            columns[leaf.flat_name] = vals
            if not leaf.is_required:
                masks[leaf.flat_name] = lmask
            continue
        name = leaf.name
        vals = []
        mask = None
        for i, o in enumerate(objs):
            v = getter(o, name)
            if v is None:
                if not leaf.max_def_level:
                    raise ValueError(
                        f"column {name!r} is required but object {i} "
                        "has no value")
                if mask is None:
                    mask = _np.ones(len(objs), dtype=bool)
                mask[i] = False
            else:
                vals.append(_encode_leaf(v, leaf))
        columns[name] = vals
        if mask is not None:
            masks[name] = mask
    return columns, masks, offsets, element_masks


def objects_from_columns(columns, cls, schema, n_rows=None) -> list:
    """Bulk inverse of :func:`objects_to_columns`: the
    ``{name: ChunkData}`` output of ``FileReader.read_row_group_arrays``
    -> ``list[cls]``, with the same leaf conversions as
    :func:`from_row` (strings, date/time/timestamp units, UUID) —
    but no per-row record assembly.  Flat, STRUCT (nested dataclass
    fields), MAP (dict fields), LIST-of-primitive, and LIST-of-struct
    columns are supported.  ``n_rows``
    is required when no dataclass field matches a file column (there
    is then no column to infer the row count from)."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a dataclass")
    list_leaves = {}
    struct_tops = set()
    map_tops = {}
    struct_list_tops = {}
    for leaf in schema.leaves:
        if len(leaf.path) == 1 and not leaf.max_rep_level:
            continue
        if not leaf.max_rep_level:
            struct_tops.add(leaf.path[0])
            continue
        top = _child_named(schema.root, leaf.path[0])
        if (top is not None and _is_map_group(top)
                and leaf.max_rep_level == 1
                and top.children[0].children[0].is_leaf
                and top.children[0].children[1].is_leaf
                # key must be required: _maps_from_chunks pairs one key
                # per slot; an optional key leaf would misalign streams
                and top.children[0].children[0].is_required):
            kv = top.children[0]
            map_tops[top.name] = (top, kv.children[0], kv.children[1])
            continue
        top = _bulk_list_leaf(schema, leaf)
        if top is None:
            sl = _bulk_struct_list(schema, leaf.path[0])
            if sl is not None:
                struct_list_tops[sl[0].name] = sl
                continue
            raise ValueError(
                f"objects_from_columns supports flat schemas, STRUCT, "
                f"MAP, LIST-of-primitive, and LIST-of-struct columns; "
                f"{leaf.flat_name!r} is nested (use iteration/scan)")
        list_leaves[top.name] = leaf
    field_cols: list = []
    for f, hint in _dc_fields(cls):
        name = field_name(f)
        node = _child_named(schema.root, name)
        if node is not None and name in struct_list_tops:
            top, rep_node, elem, elem_leaves = struct_list_tops[name]
            cds = {lf.name: columns.get(lf.flat_name)
                   for lf in elem_leaves}
            if all(cd is None for cd in cds.values()):
                field_cols.append((f.name, None))
                continue
            hint_u = _unwrap_optional(hint)[0] if hint is not None \
                else None
            args = typing.get_args(hint_u) if hint_u else ()
            ehint = _unwrap_optional(args[0])[0] if args else None
            out = _struct_lists_from_chunks(
                cds, top, rep_node, elem, elem_leaves, ehint)
            if n_rows is None:
                n_rows = len(out)
            elif n_rows != len(out):
                raise ValueError(
                    f"column {name!r} has {len(out)} rows, "
                    f"expected {n_rows}")
            field_cols.append((f.name, out))
            continue
        if node is not None and name in map_tops:
            top, key_leaf, val_leaf = map_tops[name]
            cd_k = columns.get(key_leaf.flat_name)
            cd_v = columns.get(val_leaf.flat_name)
            if cd_k is None or cd_v is None:
                field_cols.append((f.name, None))
                continue
            hint_u = _unwrap_optional(hint)[0] if hint is not None \
                else None
            args = typing.get_args(hint_u) if hint_u else ()
            kh = _unwrap_optional(args[0])[0] if args else None
            vh = (_unwrap_optional(args[1])[0]
                  if len(args) > 1 else None)
            out = _maps_from_chunks(cd_k, cd_v, top, key_leaf,
                                    val_leaf, kh, vh)
            if n_rows is None:
                n_rows = len(out)
            elif n_rows != len(out):
                raise ValueError(
                    f"column {name!r} has {len(out)} rows, "
                    f"expected {n_rows}")
            field_cols.append((f.name, out))
            continue
        if node is not None and name in struct_tops:
            hint_u = _unwrap_optional(hint)[0] if hint is not None else None
            out = _structs_from_chunks(columns, node, hint_u)
            if out is None:
                field_cols.append((f.name, None))
                continue
            if n_rows is None:
                n_rows = len(out)
            elif n_rows != len(out):
                raise ValueError(
                    f"column {name!r} has {len(out)} rows, "
                    f"expected {n_rows}")
            field_cols.append((f.name, out))
            continue
        if node is not None and name in list_leaves:
            leaf = list_leaves[name]
            cd = columns.get(leaf.flat_name)
            if cd is None:
                field_cols.append((f.name, None))
                continue
            hint_u = _unwrap_optional(hint)[0] if hint is not None else None
            ehint = (typing.get_args(hint_u)[0]
                     if hint_u and typing.get_args(hint_u) else None)
            # list[Optional[T]]: the row path decodes against T
            ehint = _unwrap_optional(ehint)[0] if ehint is not None else None
            out = _lists_from_chunk(cd, node, leaf, ehint)
            if n_rows is None:
                n_rows = len(out)
            elif n_rows != len(out):
                raise ValueError(
                    f"column {name!r} has {len(out)} rows, "
                    f"expected {n_rows}")
            field_cols.append((f.name, out))
            continue
        if node is None or name not in columns:
            field_cols.append((f.name, None))
            continue
        cd = columns[name]
        hint_u = _unwrap_optional(hint)[0] if hint is not None else None
        # the row path's materialization (io/store.py): unsigned
        # re-views, FLBA/INT96 -> bytes, np scalars -> Python values
        out = _leaf_col_from_chunk(cd, node, hint_u)
        if n_rows is None:
            n_rows = len(out)
        elif n_rows != len(out):
            raise ValueError(
                f"column {name!r} has {len(out)} rows, expected {n_rows}")
        field_cols.append((f.name, out))
    n_rows = n_rows or 0
    return [
        cls(**{attr: (col[i] if col is not None else None)
               for attr, col in field_cols})
        for i in range(n_rows)
    ]


def _leaf_col_from_chunk(cd, node: SchemaNode, hint) -> list:
    """Per-row Python values (None for nulls) from one non-repeated
    leaf's ChunkData, with the row path's leaf conversions."""
    from ..io.values import handler_for

    vals = handler_for(node.element).to_pylist(cd.values)
    # one C-level conversion: iterating the np array would box an
    # np.int32 per row in this bulk path
    dl = cd.def_levels.tolist()
    md = node.max_def_level
    out = []
    k = 0
    for lvl in dl:
        if md and lvl != md:
            out.append(None)
        else:
            out.append(_decode_leaf(vals[k], node, hint))
            k += 1
    return out


def _structs_from_chunks(columns, node: SchemaNode, hint):
    """Reconstruct per-row nested objects for one STRUCT subtree from
    leaf ChunkData — presence at each group level comes from the def
    levels the row path would walk one record at a time.  Returns
    ``list[instance | None]``, or None when projection dropped every
    leaf of the subtree."""
    if hint is None or not dataclasses.is_dataclass(hint):
        raise ValueError(
            f"STRUCT column {node.name!r} needs a dataclass field type "
            "in the bulk path (use iteration/scan for dict rows)")
    import numpy as _np

    cd0 = None
    stack = [node]
    while stack and cd0 is None:
        c = stack.pop()
        if c.is_leaf:
            cd0 = columns.get(c.flat_name)
        else:
            stack.extend(c.children)
    if cd0 is None:
        return None
    gd = node.max_def_level
    dl0 = _np.asarray(cd0.def_levels)
    n = len(dl0)
    present = (dl0 >= gd) if gd else _np.ones(n, dtype=bool)
    child_cols: list = []
    for f, h in _dc_fields(hint):
        child = _child_named(node, field_name(f))
        if child is None:
            child_cols.append((f.name, None))
            continue
        h_u = _unwrap_optional(h)[0] if h is not None else None
        if child.is_leaf and not child.is_repeated:
            cd = columns.get(child.flat_name)
            child_cols.append(
                (f.name,
                 None if cd is None
                 else _leaf_col_from_chunk(cd, child, h_u)))
        elif (not child.is_leaf and not child.is_repeated
              and not _is_list_group(child) and not _is_map_group(child)):
            child_cols.append(
                (f.name, _structs_from_chunks(columns, child, h_u)))
        else:
            raise ValueError(
                f"{child.flat_name!r}: lists/maps inside STRUCT columns "
                "are not supported by the bulk path (use iteration/scan)")
    return [
        hint(**{attr: (col[i] if col is not None else None)
                for attr, col in child_cols})
        if present[i] else None
        for i in range(n)
    ]


def _struct_lists_from_chunks(cds, top: SchemaNode, rep_node: SchemaNode,
                              elem: SchemaNode, elem_leaves, ehint):
    """Reconstruct per-row ``list[dataclass]`` values from the element
    leaves' ChunkData — all leaf streams share rep levels and slot
    structure; the first available stream drives the walk and each
    leaf's own def levels say whether its field is set per slot."""
    if ehint is None or not dataclasses.is_dataclass(ehint):
        raise ValueError(
            f"LIST-of-struct column {top.name!r} needs a list[dataclass] "
            "field type in the bulk path (use iteration/scan)")
    from ..io.values import handler_for

    drive_name, drive = next(
        (n, cd) for n, cd in cds.items() if cd is not None)
    rep = drive.rep_levels.tolist()
    streams = {}
    for lf in elem_leaves:
        cd = cds[lf.name]
        if cd is None:
            continue
        streams[lf.name] = (
            handler_for(lf.element).to_pylist(cd.values),
            cd.def_levels.tolist(), lf, [0])
    drive_dl = streams[drive_name][1]
    # dataclass attr per leaf name
    attr_of = {field_name(f): f.name for f in dataclasses.fields(ehint)}
    hints = {field_name(f): _unwrap_optional(h)[0] if h is not None
             else None for f, h in _dc_fields(ehint)}
    # projection dropped these leaves: their attrs fill with None,
    # matching the flat path's behavior for unmatched columns
    absent = [attr_of[lf.name] for lf in elem_leaves
              if lf.name not in streams and lf.name in attr_of]
    slot_def = rep_node.max_def_level  # list holds an entry at >= this
    elem_def = elem.max_def_level      # ... a non-null element at >= this
    row_nullable = top is not rep_node and not top.is_required
    def_t = top.max_def_level
    out = []
    _no_row = object()
    row = _no_row
    for slot, (r, d) in enumerate(zip(rep, drive_dl)):
        if r == 0:
            if row is not _no_row:
                out.append(row)
            row = []
        if d >= slot_def:
            if d < elem_def:
                row.append(None)  # null element (optional elem group)
            else:
                kwargs = {attr: None for attr in absent}
                for lname, (vals, dl, lf, k) in streams.items():
                    attr = attr_of.get(lname)
                    if dl[slot] == lf.max_def_level:
                        v = _decode_leaf(vals[k[0]], lf,
                                         hints.get(lname))
                        k[0] += 1
                        if attr is not None:
                            kwargs[attr] = v
                    elif attr is not None:
                        kwargs[attr] = None
                row.append(ehint(**kwargs))
        elif row_nullable and d < def_t:
            row = None
    if row is not _no_row:
        out.append(row)
    return out


def _maps_from_chunks(cd_k, cd_v, top: SchemaNode, key_leaf: SchemaNode,
                      val_leaf: SchemaNode, khint, vhint):
    """Reconstruct per-row Python dicts from a MAP column's key and
    value ChunkData — the two leaf streams share rep levels and slot
    structure (Dremel with one repeated level), so one walk over the
    key stream drives both."""
    from ..io.values import handler_for

    keys = handler_for(key_leaf.element).to_pylist(cd_k.values)
    vals = handler_for(val_leaf.element).to_pylist(cd_v.values)
    rep = cd_k.rep_levels.tolist()
    dl = cd_k.def_levels.tolist()
    vdl = cd_v.def_levels.tolist()
    kv = top.children[0]
    def_m = kv.max_def_level       # slot holds an entry at def >= this
    def_v = val_leaf.max_def_level  # ... with a non-null value at this
    row_nullable = not top.is_required
    def_t = top.max_def_level
    out = []
    _no_row = object()
    row = _no_row
    ki = vi = 0
    for slot, (r, d) in enumerate(zip(rep, dl)):
        if r == 0:
            if row is not _no_row:
                out.append(row)
            row = {}
        if d >= def_m:
            k = _decode_leaf(keys[ki], key_leaf, khint)
            ki += 1
            if vdl[slot] == def_v:
                row[k] = _decode_leaf(vals[vi], val_leaf, vhint)
                vi += 1
            else:
                row[k] = None
        elif row_nullable and d < def_t:
            row = None
    if row is not _no_row:
        out.append(row)
    return out


def _lists_from_chunk(cd, top: SchemaNode, leaf: SchemaNode, ehint):
    """Reconstruct per-row Python lists from one repeated leaf's
    ChunkData — the bulk inverse of the single-level list shredding
    (Dremel with one repeated level: ``rep==0`` starts a row; ``def``
    distinguishes null row / empty list / null element / element)."""
    from ..io.values import handler_for

    vals = handler_for(leaf.element).to_pylist(cd.values)
    rep = cd.rep_levels.tolist()
    dl = cd.def_levels.tolist()
    # the repeated node on the path (the leaf itself for bare/2-level)
    mid = top if top is leaf else top.children[0]
    def_m = mid.max_def_level      # slot holds an element at def >= this
    def_l = leaf.max_def_level     # ... a non-null element at exactly this
    row_nullable = top is not leaf and not top.is_required
    def_t = top.max_def_level      # row defined (possibly empty) at >= this
    out = []
    _no_row = object()
    row = _no_row
    k = 0
    for r, d in zip(rep, dl):
        if r == 0:
            if row is not _no_row:
                out.append(row)
            row = []
        if d >= def_m:
            if d == def_l:
                row.append(_decode_leaf(vals[k], leaf, ehint))
                k += 1
            else:
                row.append(None)
        elif row_nullable and d < def_t:
            row = None
    if row is not _no_row:
        out.append(row)
    return out


def _get_member(obj, name: str):
    if isinstance(obj, dict):
        return obj.get(name)
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if field_name(f) == name:
                return getattr(obj, f.name)
        return None
    raise TypeError(f"cannot marshal {type(obj).__name__}: expected a "
                    "dataclass or mapping")


def _has_member(obj, name: str) -> bool:
    if isinstance(obj, dict):
        return name in obj
    return any(field_name(f) == name for f in dataclasses.fields(obj))


def _encode(v, node: SchemaNode):
    if v is None:
        return None
    if not node.is_leaf:
        if _is_list_group(node):
            # Use the schema's actual names — 3-level compliant files say
            # list/element, legacy layouts (bag/item, 2-level) vary.
            mid = node.children[0]
            if mid.is_leaf:  # 2-level legacy: repeated leaf IS the element
                return {mid.name: [_encode_leaf(e, mid) for e in v]}
            if len(mid.children) == 1:
                elem = mid.children[0]
                return {mid.name: [
                    {} if e is None else {elem.name: _encode(e, elem)}
                    for e in v
                ]}
            # 2-level legacy: repeated group is itself the element struct
            return {mid.name: [_group_dict(e, mid) for e in v]}
        if _is_map_group(node):
            kv = node.children[0]
            knode = kv.children[0]
            vnode = kv.children[1]
            return {kv.name: [
                {knode.name: _encode(k, knode),
                 vnode.name: _encode(val, vnode)}
                for k, val in v.items()
            ]}
        if node.is_repeated:
            return [_group_dict(e, node) for e in v]
        return _group_dict(v, node)
    if node.is_repeated:
        return [_encode_leaf(e, node) for e in v]
    return _encode_leaf(v, node)


def _group_dict(v, node: SchemaNode) -> dict:
    return {
        child.name: _encode(_get_member(v, child.name), child)
        for child in node.children
        if _has_member(v, child.name)
    }


def _encode_leaf(v, node: SchemaNode):
    el = node.element
    logical, unit = _logical(node)
    if el.type == Type.INT96:
        if isinstance(v, datetime.datetime):
            return datetime_to_int96(v)
        return v
    if isinstance(v, str):
        return v.encode("utf-8")
    if isinstance(v, uuid.UUID):
        if el.type_length not in (None, 16):
            raise ValueError("UUID requires fixed_len_byte_array(16)")
        return v.bytes
    if isinstance(v, Time) or isinstance(v, datetime.time):
        if isinstance(v, datetime.time):
            v = Time.from_datetime_time(v)
        if logical != "TIME":
            raise TypeError(f"{node.flat_name!r}: Time value on a "
                            "non-TIME column")
        if unit == "MILLIS":
            return v.milliseconds()
        if unit == "MICROS":
            return v.microseconds()
        return v.nanoseconds()
    if isinstance(v, datetime.datetime):  # before date: datetime is a date
        if logical == "TIMESTAMP":
            if v.tzinfo is not None:
                v = v.astimezone(datetime.timezone.utc).replace(tzinfo=None)
            delta = v - datetime.datetime(1970, 1, 1)
            us = (delta.days * 86_400_000_000
                  + delta.seconds * 1_000_000 + delta.microseconds)
            if unit == "MILLIS":
                return us // 1000
            if unit == "MICROS":
                return us
            return us * 1000
        raise TypeError(f"{node.flat_name!r}: datetime value on a "
                        "non-TIMESTAMP column")
    if isinstance(v, datetime.date):
        if logical != "DATE":
            raise TypeError(f"{node.flat_name!r}: date value on a "
                            "non-DATE column")
        return (v - datetime.date(1970, 1, 1)).days
    return v


# ----------------------------------------------------------------------
# Row -> object (unmarshalling)
# ----------------------------------------------------------------------

def from_row(row: dict, cls, schema):
    """Build ``cls`` (a dataclass) from a low-level assembled row."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a dataclass")
    kwargs = {}
    for f, hint in _dc_fields(cls):
        name = field_name(f)
        node = _child_named(schema.root, name)
        raw = row.get(name)
        if node is None:
            kwargs[f.name] = raw
            continue
        kwargs[f.name] = _decode(raw, node, hint)
    return cls(**kwargs)


def decode_row(row: dict, schema) -> dict:
    """Logical-type-aware plain-dict view of a row (str/date/datetime/
    Time/UUID restored, list/map conventions flattened)."""
    return {
        child.name: _decode(row.get(child.name), child, None)
        for child in schema.root.children
        if child.name in row
    }


def _child_named(node: SchemaNode, name: str) -> SchemaNode | None:
    for c in node.children:
        if c.name == name:
            return c
    return None


def _decode(raw, node: SchemaNode, hint):
    if raw is None:
        return None
    hint, _ = _unwrap_optional(hint) if hint is not None else (None, False)
    if not node.is_leaf:
        if _is_list_group(node):
            mid = node.children[0]
            inner = (typing.get_args(hint)[0]
                     if hint and typing.get_args(hint) else None)
            entries = raw.get(mid.name, [])
            if mid.is_leaf:  # 2-level legacy: repeated leaf
                return [_decode_leaf(e, mid, inner) for e in entries]
            if len(mid.children) == 1:
                elem = mid.children[0]
                return [
                    _decode(e.get(elem.name), elem, inner)
                    for e in entries
                ]
            return [_decode_group(e, mid, inner) for e in entries]
        if _is_map_group(node):
            kv = node.children[0]
            knode, vnode = kv.children[0], kv.children[1]
            args = typing.get_args(hint) if hint else ()
            kh = args[0] if args else None
            vh = args[1] if len(args) > 1 else None
            return {
                _decode(e.get(knode.name), knode, kh):
                    _decode(e.get(vnode.name), vnode, vh)
                for e in raw.get(kv.name, [])
            }
        if node.is_repeated:
            inner = (typing.get_args(hint)[0]
                     if hint and typing.get_args(hint) else None)
            return [_decode_group(e, node, inner) for e in raw]
        return _decode_group(raw, node, hint)
    if node.is_repeated:
        inner = (typing.get_args(hint)[0]
                 if hint and typing.get_args(hint) else None)
        return [_decode_leaf(e, node, inner) for e in raw]
    return _decode_leaf(raw, node, hint)


def _decode_group(raw: dict, node: SchemaNode, hint):
    if hint is not None and dataclasses.is_dataclass(hint):
        kwargs = {}
        for f, h in _dc_fields(hint):
            child = _child_named(node, field_name(f))
            if child is None:
                kwargs[f.name] = raw.get(field_name(f))
            else:
                kwargs[f.name] = _decode(raw.get(child.name), child, h)
        return hint(**kwargs)
    return {
        c.name: _decode(raw.get(c.name), c, None)
        for c in node.children if c.name in raw
    }


def _decode_leaf(raw, node: SchemaNode, hint):
    el = node.element
    logical, unit = _logical(node)
    if el.type == Type.INT96 and (hint is datetime.datetime or hint is None):
        return int96_to_datetime(raw)
    if logical in ("STRING", "ENUM", "JSON") and (hint is not bytes):
        return raw.decode("utf-8") if isinstance(raw, bytes) else raw
    if logical == "DATE" and hint is not int:
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=raw)
    if logical == "TIMESTAMP" and hint is not int:
        scale = {"MILLIS": 1000, "MICROS": 1, None: 1}.get(unit)
        if scale is None:  # NANOS
            us, rem = divmod(raw, 1000)
        else:
            us, rem = raw * scale, 0
        del rem
        return (datetime.datetime(1970, 1, 1)
                + datetime.timedelta(microseconds=us))
    if logical == "TIME" and hint is not int:
        t = {"MILLIS": time_from_milliseconds,
             "MICROS": time_from_microseconds}.get(unit,
                                                   time_from_nanoseconds)(raw)
        return t.to_datetime_time() if hint is datetime.time else t
    if logical == "UUID" and hint is not bytes:
        return uuid.UUID(bytes=raw)
    if hint is str and isinstance(raw, bytes):
        return raw.decode("utf-8")
    return raw
