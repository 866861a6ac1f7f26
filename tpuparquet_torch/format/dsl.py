"""Schema DSL, the subset this package reads and writes.

The parquet-mr style text form of a schema: one message of fields, each
``required``, ``optional`` or ``repeated``; a field is a group (``group
name [(LIST)] { ... }``) or a primitive typed ``boolean``, ``int32``,
``int64``, ``int96``, ``float``, ``double``, ``binary`` or
``fixed_len_byte_array(N)``.  A binary field may carry ``(STRING)``
(written as the UTF8 converted type), an int64 field
``(TIMESTAMP(MILLIS|MICROS, true|false))``, which sets the TIMESTAMP
logical type and its converted type, a binary, fixed-length, int32 or
int64 field ``(DECIMAL(precision, scale))`` (the DECIMAL logical and
converted types, ``precision`` and ``scale`` on the element) and a
``fixed_len_byte_array(16)`` field ``(UUID)`` and an int32 or int64
field ``(INT(8|16|32|64, true|false))`` (the INTEGER logical type and the
``INT_n``/``UINT_n`` converted type; width 64 on int64, the others on
int32), as the JAX package's parser does.  Other types, annotations and
field ids raise :class:`NotImplementedError` naming what was found, so a
schema this package cannot decode is refused at the door rather than
misread.
"""

from __future__ import annotations

import re

from .metadata import ConvertedType, DecimalType, FieldRepetitionType, \
    IntType, LogicalType, MicroSeconds, MilliSeconds, SchemaElement, \
    TimestampType, TimeUnit, Type, UUIDType

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
    r"(?P<ws>\s+)|(?P<ident>[A-Za-z_][A-Za-z0-9_]*)|(?P<num>[0-9]+)"
    r"|(?P<punct>[{};(),])")

_TYPES = {"boolean": Type.BOOLEAN, "int32": Type.INT32, "int64": Type.INT64,
          "int96": Type.INT96, "float": Type.FLOAT, "double": Type.DOUBLE,
          "binary": Type.BYTE_ARRAY,
          "fixed_len_byte_array": Type.FIXED_LEN_BYTE_ARRAY}
_DECIMAL_TYPES = (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY, Type.INT32,
                  Type.INT64)
_REPETITIONS = {"required": FieldRepetitionType.REQUIRED,
                "optional": FieldRepetitionType.OPTIONAL,
                "repeated": FieldRepetitionType.REPEATED}
_TIME_UNITS = {"MILLIS": (ConvertedType.TIMESTAMP_MILLIS, "MILLIS",
                          MilliSeconds),
               "MICROS": (ConvertedType.TIMESTAMP_MICROS, "MICROS",
                          MicroSeconds)}


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
    """Parse the DSL subset; raises SchemaParseError with a line number,
    NotImplementedError for constructs outside the subset."""
    toks = _tokenize(text)
    i = 0

    def take(what: str):
        nonlocal i
        if i >= len(toks):
            raise SchemaParseError(f"expected {what}, got end of input")
        tok = toks[i]
        i += 1
        return tok

    def expect(word: str, line):
        got, line = take(f"{word!r}")
        if got != word:
            raise SchemaParseError(f"expected {word!r}, got {got!r}", line)
        return line

    def timestamp(fname: str, se: SchemaElement, line) -> None:
        expect("(", line)
        unit, line = take("time unit")
        if unit not in _TIME_UNITS:
            raise NotImplementedError(
                f"field {fname!r}: TIMESTAMP unit {unit!r} is not supported "
                "by tpuparquet_torch (MILLIS, MICROS)")
        sep, line = take("','")
        if sep != ",":
            raise SchemaParseError(f"expected ',', got {sep!r}", line)
        utc, line = take("boolean")
        if utc not in ("true", "false"):
            raise SchemaParseError(f"invalid boolean {utc!r} for TIMESTAMP",
                                   line)
        expect(")", line)
        ct, member, cls = _TIME_UNITS[unit]
        tu = TimeUnit()
        setattr(tu, member, cls())
        se.logicalType = LogicalType(TIMESTAMP=TimestampType(
            isAdjustedToUTC=utc == "true", unit=tu))
        se.converted_type = ct

    def number(what: str) -> int:
        tok, line = take(what)
        if not tok.isdigit():
            raise SchemaParseError(f"expected {what}, got {tok!r}", line)
        return int(tok)

    def decimal(se: SchemaElement, line) -> None:
        expect("(", line)
        precision = number("precision")
        expect(",", line)
        scale = number("scale")
        expect(")", line)
        se.logicalType = LogicalType(DECIMAL=DecimalType(scale=scale,
                                                         precision=precision))
        se.scale = scale
        se.precision = precision
        se.converted_type = ConvertedType.DECIMAL

    def integer(fname: str, ptype, se: SchemaElement, line) -> None:
        expect("(", line)
        width = number("bit width")
        if width not in (8, 16, 32, 64):
            raise SchemaParseError(f"INT: unsupported bitwidth {width}", line)
        expect(",", line)
        signed, line = take("boolean")
        if signed not in ("true", "false"):
            raise SchemaParseError(f"invalid boolean {signed!r} for INT",
                                   line)
        expect(")", line)
        want = Type.INT64 if width == 64 else Type.INT32
        if ptype != want:
            raise SchemaValidationError(
                f"field {fname} is annotated as INT({width}, ...) but "
                f"element type is {ptype}")
        se.logicalType = LogicalType(INTEGER=IntType(
            bitWidth=width, isSigned=signed == "true"))
        se.converted_type = ConvertedType[
            ("INT_" if signed == "true" else "UINT_") + str(width)]

    def annotation(fname: str, ptype, se: SchemaElement, line) -> None:
        ann, line = take("annotation")
        if ann == "STRING" and ptype == Type.BYTE_ARRAY:
            se.converted_type = ConvertedType.UTF8
        elif ann == "TIMESTAMP" and ptype == Type.INT64:
            timestamp(fname, se, line)
        elif ann == "DECIMAL" and ptype in _DECIMAL_TYPES:
            decimal(se, line)
        elif ann == "INT" and ptype in (Type.INT32, Type.INT64):
            integer(fname, ptype, se, line)
        elif (ann == "UUID" and ptype == Type.FIXED_LEN_BYTE_ARRAY
              and se.type_length == 16):
            se.logicalType = LogicalType(UUID=UUIDType())
        else:
            raise NotImplementedError(
                f"field {fname!r}: annotation {ann!r} is not supported by "
                "tpuparquet_torch (STRING on binary, TIMESTAMP on int64, "
                "DECIMAL, INT on int32/int64, UUID on "
                "fixed_len_byte_array(16))")
        expect(")", line)

    def field() -> ColumnDefinition:
        word, line = take("field or '}'")
        rep = _REPETITIONS.get(word)
        if rep is None:
            raise SchemaParseError(f"invalid field repetition {word!r}",
                                   line)
        tname, line = take("type")
        if tname == "group":
            gname, line = take("group name")
            se = SchemaElement(repetition_type=rep, name=gname)
            tok, line = take("'{'")
            if tok == "(":
                ann, line = take("converted type")
                if ann != "LIST":
                    raise NotImplementedError(
                        f"group {gname!r}: annotation {ann!r} is not "
                        "supported by tpuparquet_torch (LIST only)")
                se.converted_type = ConvertedType.LIST
                expect(")", line)
                tok, line = take("'{'")
            if tok != "{":
                raise SchemaParseError(f"expected '{{', got {tok!r}", line)
            col = ColumnDefinition(se)
            while i < len(toks) and toks[i][0] != "}":
                col.children.append(field())
            expect("}", line)
            if not col.children:
                raise SchemaValidationError(f"group {gname!r} is empty")
            se.num_children = len(col.children)
            return col
        ptype = _TYPES.get(tname)
        if ptype is None:
            raise NotImplementedError(
                f"column type {tname!r} is not supported by "
                "tpuparquet_torch")
        type_length = None
        if ptype == Type.FIXED_LEN_BYTE_ARRAY:
            expect("(", line)
            type_length = number("byte length")
            expect(")", line)
        fname, line = take("field name")
        se = SchemaElement(type=ptype, type_length=type_length,
                           repetition_type=rep, name=fname)
        end, line = take("';'")
        if end == "(":
            annotation(fname, ptype, se, line)
            end, line = take("';'")
        if end != ";":
            raise NotImplementedError(
                f"field {fname!r}: field ids are not supported by "
                "tpuparquet_torch")
        return ColumnDefinition(se)

    line = expect("message", None)
    name, _ = take("message name")
    root = ColumnDefinition(SchemaElement(name=name))
    expect("{", line)
    while i < len(toks) and toks[i][0] != "}":
        root.children.append(field())
    expect("}", line)
    if i != len(toks):
        raise SchemaParseError(f"trailing content {toks[i][0]!r}",
                               toks[i][1])
    root.element.num_children = len(root.children) or None
    return SchemaDefinition(root)
