"""Schema DSL, flat subset: ``message m { required|optional <type> x; }``.

The parquet-mr style text form of a schema, cut to what the flat path
needs: one message of primitive fields, each ``required`` or
``optional``, typed ``int32``, ``int64``, ``float``, ``double`` or
``binary``; a binary field may carry the ``(STRING)`` annotation (written
as the UTF8 converted type).  Groups, repeated fields, other types and
annotations raise :class:`NotImplementedError` naming what was found, so
a schema this package cannot decode is refused at the door rather than
misread.
"""

from __future__ import annotations

import re

from .metadata import ConvertedType, FieldRepetitionType, SchemaElement, \
    Type

__all__ = [
    "ColumnDefinition",
    "SchemaDefinition",
    "SchemaParseError",
    "SchemaValidationError",
    "parse_schema_definition",
]


class SchemaParseError(ValueError):
    def __init__(self, msg, line=None):
        super().__init__(f"line {line}: {msg}" if line is not None else msg)
        self.line = line


class SchemaValidationError(ValueError):
    """A structurally invalid schema tree."""


class ColumnDefinition:
    """One node of a schema definition: a SchemaElement + children."""

    __slots__ = ("element", "children")

    def __init__(self, element: SchemaElement, children=None):
        self.element = element
        self.children = children or []

    @property
    def name(self) -> str:
        return self.element.name


class SchemaDefinition:
    """A parsed schema: wraps the root ColumnDefinition."""

    __slots__ = ("root",)

    def __init__(self, root: ColumnDefinition):
        self.root = root

    @classmethod
    def from_schema_elements(cls, elems: list) -> "SchemaDefinition":
        """Build from the flat depth-first SchemaElement list of a footer."""
        if not elems:
            raise SchemaValidationError("empty schema element list")
        pos = 0

        def build() -> ColumnDefinition:
            nonlocal pos
            if pos >= len(elems):
                raise SchemaValidationError("schema element list truncated")
            se = elems[pos]
            pos += 1
            col = ColumnDefinition(se)
            for _ in range(se.num_children or 0):
                col.children.append(build())
            return col

        root = build()
        if pos != len(elems):
            raise SchemaValidationError(
                f"schema element list has {len(elems) - pos} trailing "
                "elements")
        return cls(root)


_TOKEN_RE = re.compile(
    r"(?P<ws>\s+)|(?P<ident>[A-Za-z_][A-Za-z0-9_]*)|(?P<punct>[{};()])")

_TYPES = {"int32": Type.INT32, "int64": Type.INT64, "float": Type.FLOAT,
          "double": Type.DOUBLE, "binary": Type.BYTE_ARRAY}
_REPETITIONS = {"required": FieldRepetitionType.REQUIRED,
                "optional": FieldRepetitionType.OPTIONAL}


def _tokenize(text: str) -> list:
    toks = []
    pos = 0
    line = 1
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SchemaParseError(f"unexpected character {text[pos]!r}",
                                   line)
        if m.lastgroup == "ws":
            line += m.group().count("\n")
        else:
            toks.append((m.group(), line))
        pos = m.end()
    return toks


def parse_schema_definition(text: str) -> SchemaDefinition:
    """Parse the flat DSL subset; raises SchemaParseError with a line
    number, NotImplementedError for constructs outside the subset."""
    toks = _tokenize(text)
    i = 0

    def take(what: str):
        nonlocal i
        if i >= len(toks):
            raise SchemaParseError(f"expected {what}, got end of input")
        tok = toks[i]
        i += 1
        return tok

    word, line = take("'message'")
    if word != "message":
        raise SchemaParseError(f"expected 'message', got {word!r}", line)
    name, _ = take("message name")
    root = ColumnDefinition(SchemaElement(name=name))
    if take("'{'")[0] != "{":
        raise SchemaParseError("expected '{'", line)
    while True:
        word, line = take("field or '}'")
        if word == "}":
            break
        rep = _REPETITIONS.get(word)
        if rep is None:
            if word == "repeated":
                raise NotImplementedError(
                    "repeated fields are not supported by tpuparquet_torch")
            raise SchemaParseError(f"invalid field repetition {word!r}",
                                   line)
        tname, line = take("type")
        ptype = _TYPES.get(tname)
        if ptype is None:
            raise NotImplementedError(
                f"column type {tname!r} is not supported by "
                "tpuparquet_torch (int32, int64, float, double, binary)")
        fname, line = take("field name")
        se = SchemaElement(type=ptype, repetition_type=rep, name=fname)
        end, line = take("';'")
        if end == "(" and ptype == Type.BYTE_ARRAY:
            ann, line = take("annotation")
            if ann != "STRING" or take("')'")[0] != ")":
                raise NotImplementedError(
                    f"field {fname!r}: annotation {ann!r} is not supported "
                    "by tpuparquet_torch (STRING only)")
            se.converted_type = ConvertedType.UTF8
            end, line = take("';'")
        if end != ";":
            raise NotImplementedError(
                f"field {fname!r}: annotations and field ids are not "
                "supported by tpuparquet_torch")
        root.children.append(ColumnDefinition(se))
    if i != len(toks):
        raise SchemaParseError(f"trailing content {toks[i][0]!r}",
                               toks[i][1])
    root.element.num_children = len(root.children) or None
    return SchemaDefinition(root)
