"""Schema DSL, the subset this package reads and writes.

The parquet-mr style text form of a schema: one message of fields, each
``required``, ``optional`` or ``repeated``; a field is a group (``group
name [(LIST)|(MAP)] { ... }``) or a primitive typed ``boolean``, ``int32``,
``int64``, ``int96``, ``float``, ``double``, ``binary`` or
``fixed_len_byte_array(N)``.  A binary field may carry ``(STRING)``
(the STRING logical type and the UTF8 converted type), an int64 field
``(TIMESTAMP(MILLIS|MICROS, true|false))``, which sets the TIMESTAMP
logical type and its converted type, a binary, fixed-length, int32 or
int64 field ``(DECIMAL(precision, scale))`` (the DECIMAL logical and
converted types, ``precision`` and ``scale`` on the element) and a
``fixed_len_byte_array(16)`` field ``(UUID)`` and an int32 or int64
field ``(INT(8|16|32|64, true|false))`` (the INTEGER logical type and the
``INT_n``/``UINT_n`` converted type; width 64 on int64, the others on
int32), and a binary field ``(JSON)`` (the JSON logical and converted
types), as the JAX package's parser does.  Other types, annotations and
field ids raise :class:`NotImplementedError` naming what was found, so a
schema this package cannot decode is refused at the door rather than
misread.

``str()`` of a :class:`SchemaDefinition` prints any schema a footer holds
in this form, every logical and converted type included, as the JAX
package's printer does.
"""

from __future__ import annotations

import re

from .metadata import ConvertedType, DecimalType, FieldRepetitionType, \
    IntType, JsonType, LogicalType, MicroSeconds, MilliSeconds, \
    SchemaElement, StringType, TimestampType, TimeUnit, Type, UUIDType

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

    def __str__(self) -> str:
        if self.root is None:
            return "message empty {\n}\n"
        out = [f"message {self.root.name} {{\n"]
        _print_cols(out, self.root.children, 2)
        out.append("}\n")
        return "".join(out)


def _print_cols(out: list, cols: list, indent: int) -> None:
    for col in cols:
        se = col.element
        pad = " " * indent
        rep = FieldRepetitionType(se.repetition_type).name.lower()
        if se.type is None:
            out.append(f"{pad}{rep} group {se.name}")
            if se.converted_type is not None:
                out.append(f" ({ConvertedType(se.converted_type).name})")
            out.append(" {\n")
            _print_cols(out, col.children, indent + 2)
            out.append(f"{pad}}}\n")
        else:
            tname = _TYPE_PRINT[Type(se.type)]
            if se.type == Type.FIXED_LEN_BYTE_ARRAY:
                tname = f"fixed_len_byte_array({se.type_length})"
            out.append(f"{pad}{rep} {tname} {se.name}")
            if se.logicalType is not None:
                out.append(f" ({_print_logical(se.logicalType)})")
            elif se.converted_type is not None:
                out.append(f" ({ConvertedType(se.converted_type).name})")
            if se.field_id is not None:
                out.append(f" = {se.field_id}")
            out.append(";\n")


def _unit_name(unit: TimeUnit) -> str:
    if unit.NANOS is not None:
        return "NANOS"
    if unit.MICROS is not None:
        return "MICROS"
    return "MILLIS"


def _print_logical(lt: LogicalType) -> str:
    name, val = lt.set_member()
    if name in ("TIMESTAMP", "TIME"):
        utc = "true" if val.isAdjustedToUTC else "false"
        return f"{name}({_unit_name(val.unit)}, {utc})"
    if name == "DECIMAL":
        return f"DECIMAL({val.precision}, {val.scale})"
    if name == "INTEGER":
        signed = "true" if val.isSigned else "false"
        return f"INT({val.bitWidth}, {signed})"
    if name in ("STRING", "DATE", "UUID", "ENUM", "JSON", "BSON"):
        return name
    return name or "UNKNOWN"


_TOKEN_RE = re.compile(
    r"(?P<ws>\s+)|(?P<ident>[A-Za-z_][A-Za-z0-9_]*)|(?P<num>[0-9]+)"
    r"|(?P<punct>[{};(),])")

_TYPES = {"boolean": Type.BOOLEAN, "int32": Type.INT32, "int64": Type.INT64,
          "int96": Type.INT96, "float": Type.FLOAT, "double": Type.DOUBLE,
          "binary": Type.BYTE_ARRAY,
          "fixed_len_byte_array": Type.FIXED_LEN_BYTE_ARRAY}
_DECIMAL_TYPES = (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY, Type.INT32,
                  Type.INT64)
_TYPE_PRINT = {v: k for k, v in _TYPES.items()}
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
            se.logicalType = LogicalType(STRING=StringType())
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
        elif ann == "JSON" and ptype == Type.BYTE_ARRAY:
            se.logicalType = LogicalType(JSON=JsonType())
            se.converted_type = ConvertedType.JSON
        else:
            raise NotImplementedError(
                f"field {fname!r}: annotation {ann!r} is not supported by "
                "tpuparquet_torch (STRING on binary, TIMESTAMP on int64, "
                "DECIMAL, INT on int32/int64, UUID on "
                "fixed_len_byte_array(16), JSON on binary)")
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
                if ann not in ("LIST", "MAP"):
                    raise NotImplementedError(
                        f"group {gname!r}: annotation {ann!r} is not "
                        "supported by tpuparquet_torch (LIST and MAP "
                        "only)")
                se.converted_type = ConvertedType[ann]
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
            if se.converted_type == ConvertedType.MAP and (
                    len(col.children) != 1
                    or col.children[0].element.type is not None
                    or col.children[0].element.repetition_type
                    != FieldRepetitionType.REPEATED):
                raise NotImplementedError(
                    f"group {gname!r}: a MAP is supported by "
                    "tpuparquet_torch only as one repeated key_value group")
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
