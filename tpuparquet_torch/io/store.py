"""Dremel record shredding and assembly: the row API's host side.

Write side: :func:`shred_record` walks the schema tree with one record
(a dict of the top-level fields, groups as nested dicts, repeated fields
as lists) and appends a ``(value, rep, def)`` triple, or a null's levels,
to each leaf's :class:`ColumnStore`.

Read side: :func:`assemble_record` rebuilds one record from the leaves'
cursors over a decoded row group.

The levels are Dremel's:

* ``def`` counts the non-REQUIRED ancestors (the leaf included) that are
  present; a null below ``max_def_level`` says which ancestor is absent;
* ``rep`` is 0 at a record's first value, else the repetition level of
  the repeated ancestor at which the value starts a new element.
"""

from __future__ import annotations

import numpy as np

from ..format.schema import Schema, SchemaNode
from .values import ValueHandler, handler_for

__all__ = ["ColumnStore", "shred_record", "assemble_record", "attach_stores"]


class ColumnStore:
    """A leaf's write buffer and read cursor.

    Writing, ``values`` is a list the records append to; reading, it is
    the decoded column, with its Python values materialized for the
    assembly."""

    __slots__ = (
        "node", "handler", "values", "rep_levels", "def_levels",
        "null_count", "_read_values", "_read_pos", "_val_pos", "skipped",
    )

    def __init__(self, node: SchemaNode):
        self.node = node
        self.handler: ValueHandler = handler_for(node.element)
        self.reset()

    def reset(self) -> None:
        self.values = []
        self.rep_levels: list[int] = []
        self.def_levels: list[int] = []
        self.null_count = 0
        self._read_values = None
        self._read_pos = 0
        self._val_pos = 0
        self.skipped = False

    # -- writing (shredding) ----------------------------------------------

    def add(self, v, def_level: int, max_rep: int, rep_level: int) -> None:
        """Append ``v`` (None: a null at ``def_level``) of a record slot
        whose repeated ancestors reach ``max_rep``."""
        if self.node.is_repeated:
            max_rep += 1
        rep_level = min(rep_level, max_rep)

        if v is None:
            self.rep_levels.append(rep_level)
            self.def_levels.append(def_level)
            self.null_count += 1
            return
        vals = self.handler.get_values(v, repeated=self.node.is_repeated)
        if not vals:  # an empty repeated list is a null at this def level
            self.add(None, def_level, max_rep, rep_level)
            return
        d = def_level + (0 if self.node.is_required else 1)
        for i, item in enumerate(vals):
            self.values.append(item)
            self.rep_levels.append(rep_level if i == 0 else max_rep)
            self.def_levels.append(d)

    def num_records_levels(self) -> tuple[np.ndarray, np.ndarray]:
        return (
            np.asarray(self.rep_levels, dtype=np.int32),
            np.asarray(self.def_levels, dtype=np.int32),
        )

    # -- reading (assembly) -----------------------------------------------

    def load_decoded(self, column, rep_levels, def_levels) -> None:
        """Install a decoded chunk for the assembly."""
        self.values = column
        self.rep_levels = np.asarray(rep_levels, dtype=np.int32)
        self.def_levels = np.asarray(def_levels, dtype=np.int32)
        self._read_values = (self.handler.to_pylist(column)
                             if column is not None else [])
        self._read_pos = 0
        self._val_pos = 0
        self.skipped = False

    def mark_skipped(self) -> None:
        self.skipped = True
        self.values = None
        self.rep_levels = np.empty(0, dtype=np.int32)
        self.def_levels = np.empty(0, dtype=np.int32)
        self._read_values = []
        self._read_pos = 0
        self._val_pos = 0

    def rd_level_at(self, pos: int | None = None):
        """``(rep, def, exhausted)`` at ``pos`` (default: the cursor)."""
        if pos is None:
            pos = self._read_pos
        if pos >= len(self.rep_levels):
            return 0, 0, True
        return int(self.rep_levels[pos]), int(self.def_levels[pos]), False

    def get(self, max_def: int, max_rep: int):
        """The next value (or repeated run of values) of one record slot:
        ``(value, def_level)``."""
        if self.skipped:
            return None, 0
        _, dl, last = self.rd_level_at()
        if last:
            # the row group's row count promises more records than the
            # level streams hold: corruption, not the end of the data
            # (which the reader knows from the row-group metadata)
            raise ValueError(
                f"column store {self.node.flat_name!r} exhausted mid-record"
            )
        if dl < max_def:
            self._read_pos += 1
            return None, dl
        v = self._read_values[self._val_pos]
        self._val_pos += 1
        if not self.node.is_repeated:
            self._read_pos += 1
            return v, max_def
        ret = [v]
        while True:
            self._read_pos += 1
            rl, _, last = self.rd_level_at()
            if last or rl < max_rep:
                return ret, max_def
            ret.append(self._read_values[self._val_pos])
            self._val_pos += 1

    @property
    def exhausted(self) -> bool:
        return self._read_pos >= len(self.rep_levels)


def attach_stores(schema: Schema) -> None:
    for leaf in schema.leaves:
        if leaf.store is None:
            leaf.store = ColumnStore(leaf)


# -- shredding ---------------------------------------------------------------

def shred_record(schema: Schema, record: dict) -> None:
    """Append one record to every leaf's store."""
    _shred_children(schema.root.children, record, 0, 0, 0)


def _shred_nil(children, def_level, max_rep, rep_level):
    for node in children:
        if node.is_leaf:
            if node.is_required and def_level == node.max_def_level:
                raise ValueError(f"value {node.flat_name!r} is required")
            node.store.add(None, def_level, max_rep, rep_level)
        else:
            _shred_nil(node.children, def_level, max_rep, rep_level)


def _shred_children(children, data, def_level, max_rep, rep_level):
    if not isinstance(data, dict):
        raise TypeError(f"record data must be a dict, got {type(data).__name__}")
    for node in children:
        d = data.get(node.name)
        if node.is_leaf:
            if d is None and node.is_required and def_level == node.max_def_level:
                raise ValueError(f"value {node.flat_name!r} is required")
            node.store.add(d, def_level, max_rep, rep_level)
            continue
        lvl = def_level
        if not node.is_required and d is not None:
            lvl += 1
        if d is None:
            _shred_nil(node.children, lvl, max_rep, rep_level)
        elif isinstance(d, dict):
            if node.is_repeated:
                raise TypeError(
                    f"{node.flat_name!r} is repeated and needs a list"
                )
            _shred_children(node.children, d, lvl, max_rep, rep_level)
        elif isinstance(d, (list, tuple)):
            if not node.is_repeated:
                raise TypeError(
                    f"{node.flat_name!r} is not repeated but got a list"
                )
            m = max_rep + 1
            if len(d) == 0:
                # an empty repeated group adds no def level of its own:
                # presence counts an element at a time
                _shred_nil(node.children, def_level, m, rep_level)
            else:
                rl = rep_level
                for i, item in enumerate(d):
                    if i > 0:
                        rl = m
                    _shred_children(node.children, item, lvl, m, rl)
        else:
            raise TypeError(
                f"{node.flat_name!r}: group value must be dict or list, got "
                f"{type(d).__name__}"
            )


# -- assembly ----------------------------------------------------------------

def _first_rd_level(node: SchemaNode):
    """The first ``(rep, def)`` under this subtree at the cursors."""
    if node.is_leaf:
        if node.store is None or node.store.skipped:
            return -1, -1, False
        return node.store.rd_level_at()
    for child in node.children:
        rl, dl, last = _first_rd_level(child)
        if last:
            return rl, dl, last
        if rl >= 0 or dl >= 0:
            return rl, dl, last
    return -1, -1, False


def _get_group_data(node: SchemaNode):
    """One instance of a group from its children's cursors."""
    ret = {}
    not_nil = 0
    max_dl = 0  # the deepest def level seen: which ancestor was present
    # when everything below it is absent
    for child in node.children:
        data, dl = _get_node_data(child)
        max_dl = max(max_dl, dl)
        if data is not None:
            ret[child.name] = data
            not_nil += 1
        diff = 0 if child.is_required else 1
        if dl == child.max_def_level - diff:
            not_nil += 1
    if not_nil == 0:
        return None, max_dl
    return ret, node.max_def_level


def _get_node_data(node: SchemaNode):
    """``(value, def_level)`` of the node's next record slot."""
    if node.is_leaf:
        if node.store is None or node.store.skipped:
            return None, 0
        return node.store.get(node.max_def_level, node.max_rep_level)
    data, max_d = _get_group_data(node)
    if not node.is_repeated or data is None:
        return data, max_d
    ret = [data]
    while True:
        rl, _, last = _first_rd_level(node)
        if last or rl < node.max_rep_level or rl == 0:
            return ret, max_d
        data, _ = _get_group_data(node)
        ret.append(data)


def assemble_record(schema: Schema) -> dict:
    """The next record from the leaves' cursors."""
    data, _ = _get_group_data(schema.root)
    return data if data is not None else {}
