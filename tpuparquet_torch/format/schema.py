"""Runtime schema tree: Dremel repetition/definition levels.

A ``SchemaNode`` wraps one thrift ``SchemaElement``; levels follow the
Dremel rules:

* ``max_def_level`` = count of non-REQUIRED ancestors including self
  (root excluded),
* ``max_rep_level`` = count of REPEATED ancestors including self.
"""

from __future__ import annotations

from .dsl import ColumnDefinition, SchemaDefinition, \
    SchemaValidationError, parse_schema_definition
from .metadata import FieldRepetitionType, SchemaElement, Type

__all__ = ["SchemaNode", "Schema"]


class SchemaNode:
    """One node of the runtime schema tree."""

    __slots__ = ("element", "children", "parent", "path",
                 "max_rep_level", "max_def_level", "store")

    def __init__(self, element: SchemaElement, parent=None):
        self.element = element
        self.children: list[SchemaNode] = []
        self.parent = parent
        self.path: tuple[str, ...] = ()
        self.max_rep_level = 0
        self.max_def_level = 0
        # a leaf's row buffer and cursor (io/store.py), attached by the
        # reader and the writer; None on groups
        self.store = None

    @property
    def name(self) -> str:
        return self.element.name

    @property
    def flat_name(self) -> str:
        return ".".join(self.path)

    @property
    def type(self) -> Type | None:
        return self.element.type

    @property
    def type_length(self) -> int | None:
        """Byte length of a FIXED_LEN_BYTE_ARRAY leaf, else None."""
        return self.element.type_length

    @property
    def repetition_type(self) -> FieldRepetitionType | None:
        return self.element.repetition_type

    @property
    def is_leaf(self) -> bool:
        return self.element.type is not None

    @property
    def is_repeated(self) -> bool:
        return self.element.repetition_type == FieldRepetitionType.REPEATED

    @property
    def is_required(self) -> bool:
        return self.element.repetition_type == FieldRepetitionType.REQUIRED

    def __repr__(self):
        kind = "leaf" if self.is_leaf else "group"
        return (f"SchemaNode({self.flat_name or '<root>'}, {kind}, "
                f"maxR={self.max_rep_level}, maxD={self.max_def_level})")


def _build_node(cd, parent):
    node = SchemaNode(cd.element, parent)
    for child in cd.children:
        node.children.append(_build_node(child, node))
    return node


class Schema:
    """Schema tree; ``leaves`` lists data columns in depth-first order —
    the order column chunks appear in a row group."""

    def __init__(self, root: SchemaNode):
        self.root = root
        self.leaves: list[SchemaNode] = []
        self.selected: list[tuple[str, ...]] = []  # empty: all selected
        self._refresh()

    @classmethod
    def from_elements(cls, elems) -> "Schema":
        return cls.from_definition(SchemaDefinition.from_schema_elements(
            elems))

    @classmethod
    def from_definition(cls, sd: SchemaDefinition) -> "Schema":
        return cls(_build_node(sd.root, None))

    @classmethod
    def from_string(cls, text: str) -> "Schema":
        return cls.from_definition(parse_schema_definition(text))

    def _refresh(self) -> None:
        """Recompute paths, levels and the leaf list."""
        self.leaves = []

        def walk(node: SchemaNode, path: tuple, d: int, r: int):
            node.path = path
            node.max_def_level = d
            node.max_rep_level = r
            if node.is_leaf:
                self.leaves.append(node)
            num = len(node.children)
            node.element.num_children = num if num else None
            for child in node.children:
                walk(child, path + (child.name,),
                     d + (0 if child.is_required else 1),
                     r + (1 if child.is_repeated else 0))

        if self.root.is_leaf:
            raise SchemaValidationError("schema root cannot be a data column")
        walk(self.root, (), 0, 0)

    def leaf(self, flat_name: str) -> SchemaNode | None:
        for node in self.leaves:
            if node.flat_name == flat_name:
                return node
        return None

    def _node_at(self, flat_name: str) -> SchemaNode | None:
        node = self.root
        for part in flat_name.split("."):
            for c in node.children:
                if c.name == part:
                    node = c
                    break
            else:
                return None
        return node

    def set_selected_columns(self, *flat_names: str) -> None:
        """Restrict reading to the given dotted paths (and their
        subtrees).  No arguments: select everything."""
        sel = []
        for fn in flat_names:
            if self._node_at(fn) is None:
                raise SchemaValidationError(
                    f"column {fn!r} is not in the schema")
            sel.append(tuple(fn.split(".")))
        self.selected = sel

    def is_selected(self, node: SchemaNode) -> bool:
        """Selected when nothing is selected, or a selected path is a
        prefix of the node's path or the node's path of a selected one."""
        if not self.selected:
            return True
        path = node.path
        return any(sel[: min(len(sel), len(path))]
                   == path[: min(len(sel), len(path))]
                   for sel in self.selected)

    def to_elements(self) -> list:
        out = []

        def walk(node: SchemaNode):
            out.append(node.element)
            for c in node.children:
                walk(c)

        walk(self.root)
        return out

    def definition(self) -> SchemaDefinition:
        """The DSL view of the tree (``str()`` of it prints the text)."""
        def build(node: SchemaNode) -> ColumnDefinition:
            return ColumnDefinition(node.element,
                                    [build(c) for c in node.children])

        return SchemaDefinition(build(self.root))

    def __str__(self) -> str:
        return str(self.definition())
