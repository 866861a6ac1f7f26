"""Schema DSL, the subset this package reads and writes.

The parquet-mr style text form of a schema: one message of fields, each
``required``, ``optional`` or ``repeated``; a field is a group (``group
name [(LIST)|(MAP)] { ... }``) or a primitive typed ``boolean``, ``int32``,
``int64``, ``int96``, ``float``, ``double``, ``binary`` or
``fixed_len_byte_array(N)``.  A binary field may carry ``(STRING)``
(the STRING logical type and the UTF8 converted type), ``(ENUM)`` or
``(BSON)``, an int64 field ``(TIMESTAMP(MILLIS|MICROS|NANOS,
true|false))``, which sets the TIMESTAMP logical type and its converted
type (none for NANOS), an int32 field ``(DATE)`` or ``(TIME(MILLIS,
true|false))`` and an int64 field ``(TIME(MICROS|NANOS, true|false))``
(the DATE and TIME logical types, and their converted types but for
NANOS), a binary, fixed-length, int32 or
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
package's printer does; :meth:`SchemaDefinition.validate` and
:meth:`SchemaDefinition.validate_strict` check a constructed tree's
LIST and MAP shapes and each annotation's physical type with the JAX
package's rules and words.
"""

from __future__ import annotations

import re

from .metadata import BsonType, ConvertedType, DateType, DecimalType, \
    EnumType, FieldRepetitionType, IntType, JsonType, LogicalType, \
    MicroSeconds, MilliSeconds, NanoSeconds, SchemaElement, StringType, \
    TimestampType, TimeType, TimeUnit, Type, UUIDType

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

    def validate(self) -> None:
        _validate_column(self.root, is_root=True, strict=False)

    def validate_strict(self) -> None:
        """:meth:`validate` with the spec's names enforced (``list`` and
        ``element``, ``key_value`` with a required ``key`` and a
        ``value``)."""
        _validate_column(self.root, is_root=True, strict=True)

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
# a time unit's TimeUnit member class, and the converted types of a
# TIMESTAMP and of a TIME in it (NANOS has none)
_TIME_UNITS = {"MILLIS": (MilliSeconds, ConvertedType.TIMESTAMP_MILLIS,
                          ConvertedType.TIME_MILLIS),
               "MICROS": (MicroSeconds, ConvertedType.TIMESTAMP_MICROS,
                          ConvertedType.TIME_MICROS),
               "NANOS": (NanoSeconds, None, None)}
# the plain logical types: their LogicalType member class, the converted
# type they set and the physical type they annotate
_PLAIN_LOGICAL = {
    "STRING": (StringType, ConvertedType.UTF8, Type.BYTE_ARRAY),
    "ENUM": (EnumType, ConvertedType.ENUM, Type.BYTE_ARRAY),
    "JSON": (JsonType, ConvertedType.JSON, Type.BYTE_ARRAY),
    "BSON": (BsonType, ConvertedType.BSON, Type.BYTE_ARRAY),
    "DATE": (DateType, ConvertedType.DATE, Type.INT32),
}


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

    def time_type(what: str, fname: str, ptype, se: SchemaElement,
                  line) -> None:
        """``(UNIT, true|false)`` of a TIMESTAMP on int64, or of a TIME
        on int32 (MILLIS) or int64 (MICROS, NANOS)."""
        expect("(", line)
        unit, line = take("time unit")
        if unit not in _TIME_UNITS:
            raise SchemaParseError(
                f"unknown unit annotation {unit!r} for {what}", line)
        sep, line = take("','")
        if sep != ",":
            raise SchemaParseError(f"expected ',', got {sep!r}", line)
        utc, line = take("boolean")
        if utc not in ("true", "false"):
            raise SchemaParseError(f"invalid boolean {utc!r} for {what}",
                                   line)
        expect(")", line)
        cls, ts_ct, time_ct = _TIME_UNITS[unit]
        want = Type.INT32 if what == "TIME" and unit == "MILLIS" \
            else Type.INT64
        if ptype != want:
            raise NotImplementedError(
                f"field {fname!r}: {what}({unit}) is not supported by "
                f"tpuparquet_torch on {Type(ptype).name}")
        tu = TimeUnit(**{unit: cls()})
        if what == "TIME":
            se.logicalType = LogicalType(TIME=TimeType(
                isAdjustedToUTC=utc == "true", unit=tu))
            se.converted_type = time_ct
        else:
            se.logicalType = LogicalType(TIMESTAMP=TimestampType(
                isAdjustedToUTC=utc == "true", unit=tu))
            se.converted_type = ts_ct

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
        plain = _PLAIN_LOGICAL.get(ann)
        if plain is not None and ptype == plain[2]:
            cls, ct, _ = plain
            se.logicalType = LogicalType(**{ann: cls()})
            se.converted_type = ct
        elif ann in ("TIMESTAMP", "TIME") and ptype in (Type.INT32,
                                                        Type.INT64):
            time_type(ann, fname, ptype, se, line)
        elif ann == "DECIMAL" and ptype in _DECIMAL_TYPES:
            decimal(se, line)
        elif ann == "INT" and ptype in (Type.INT32, Type.INT64):
            integer(fname, ptype, se, line)
        elif ann == "UUID" and ptype == Type.FIXED_LEN_BYTE_ARRAY:
            if se.type_length != 16:
                raise SchemaValidationError(
                    f"field {fname} is annotated as UUID but is not a "
                    "fixed_len_byte_array(16)")
            se.logicalType = LogicalType(UUID=UUIDType())
        else:
            raise NotImplementedError(
                f"field {fname!r}: annotation {ann!r} is not supported by "
                "tpuparquet_torch (STRING, ENUM, JSON and BSON on binary, "
                "DATE on int32, TIME on int32/int64, TIMESTAMP on int64, "
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


# ----------------------------------------------------------------------
# Validation: the LIST and MAP shapes and each annotation's physical type
# (the JAX package's rules and words)
# ----------------------------------------------------------------------

def _lt_member(se: SchemaElement) -> str | None:
    if se.logicalType is None:
        return None
    return se.logicalType.set_member()[0]


def _validate_column(col: ColumnDefinition, is_root: bool, strict: bool) -> None:
    se = col.element
    if se is None:
        raise SchemaValidationError("column has no schema element")
    if not se.name:
        raise SchemaValidationError("column has no name")
    if not is_root and not col.children and se.type is None:
        raise SchemaValidationError(
            f"field {se.name} has neither children nor a type"
        )
    if se.type is not None and col.children:
        raise SchemaValidationError(
            f"field {se.name} has a type but also children"
        )

    lt = _lt_member(se)
    ct = se.converted_type
    ptype = se.type

    def type_check(cond: bool, msg: str):
        if not cond:
            raise SchemaValidationError(f"field {se.name} {msg}")

    if lt == "LIST" or ct == ConvertedType.LIST:
        _validate_list(col, strict)
    elif lt == "MAP" or ct in (ConvertedType.MAP, ConvertedType.MAP_KEY_VALUE):
        _validate_map(col, strict)
    elif lt == "DATE" or ct == ConvertedType.DATE:
        type_check(ptype == Type.INT32, "is annotated as DATE but is not an int32")
    elif lt == "TIMESTAMP":
        type_check(
            ptype in (Type.INT64, Type.INT96),
            "is annotated as TIMESTAMP but is not an int64/int96",
        )
    elif lt == "TIME":
        t = se.logicalType.TIME
        if t.unit.MILLIS is not None:
            type_check(ptype == Type.INT32,
                       "is annotated as TIME(MILLIS) but is not an int32")
        else:
            type_check(ptype == Type.INT64,
                       "is annotated as TIME(MICROS|NANOS) but is not an int64")
    elif lt == "UUID":
        type_check(
            ptype == Type.FIXED_LEN_BYTE_ARRAY and se.type_length == 16,
            "is annotated as UUID but is not a fixed_len_byte_array(16)",
        )
    elif lt == "ENUM":
        type_check(ptype == Type.BYTE_ARRAY,
                   "is annotated as ENUM but is not a binary")
    elif lt == "JSON":
        type_check(ptype == Type.BYTE_ARRAY,
                   "is annotated as JSON but is not a binary")
    elif lt == "BSON":
        type_check(ptype == Type.BYTE_ARRAY,
                   "is annotated as BSON but is not a binary")
    elif lt == "DECIMAL":
        _validate_decimal(col)
    elif lt == "INTEGER":
        it = se.logicalType.INTEGER
        want = Type.INT64 if it.bitWidth == 64 else Type.INT32
        type_check(
            ptype == want,
            f"is annotated as INT({it.bitWidth}, ...) but element type is "
            f"{ptype}",
        )
    elif ct == ConvertedType.UTF8:
        type_check(ptype == Type.BYTE_ARRAY,
                   "is annotated as UTF8 but is not binary")
    elif ct == ConvertedType.TIME_MILLIS:
        type_check(ptype == Type.INT32,
                   "is annotated as TIME_MILLIS but is not int32")
    elif ct == ConvertedType.TIME_MICROS:
        type_check(ptype == Type.INT64,
                   "is annotated as TIME_MICROS but is not int64")
    elif ct == ConvertedType.TIMESTAMP_MILLIS:
        type_check(ptype == Type.INT64,
                   "is annotated as TIMESTAMP_MILLIS but is not int64")
    elif ct == ConvertedType.TIMESTAMP_MICROS:
        type_check(ptype == Type.INT64,
                   "is annotated as TIMESTAMP_MICROS but is not int64")
    elif ct in (
        ConvertedType.UINT_8, ConvertedType.UINT_16, ConvertedType.UINT_32,
        ConvertedType.INT_8, ConvertedType.INT_16, ConvertedType.INT_32,
    ):
        type_check(
            ptype == Type.INT32,
            f"is annotated as {ConvertedType(ct).name} but is not int32",
        )
    elif ct in (ConvertedType.UINT_64, ConvertedType.INT_64):
        type_check(
            ptype == Type.INT64,
            f"is annotated as {ConvertedType(ct).name} but is not int64",
        )
    elif ct == ConvertedType.INTERVAL:
        type_check(
            ptype == Type.FIXED_LEN_BYTE_ARRAY and se.type_length == 12,
            "is annotated as INTERVAL but is not a fixed_len_byte_array(12)",
        )
    else:
        for c in col.children:
            _validate_column(c, is_root=False, strict=strict)


def _validate_list(col: ColumnDefinition, strict: bool) -> None:
    se = col.element
    if se.type is not None:
        raise SchemaValidationError(
            f"field {se.name} is not a group but annotated as LIST"
        )
    rep = se.repetition_type
    if rep not in (FieldRepetitionType.OPTIONAL, FieldRepetitionType.REQUIRED):
        raise SchemaValidationError(
            f"field {se.name} is a LIST but has repetition type {rep}"
        )
    if len(col.children) != 1:
        raise SchemaValidationError(
            f"field {se.name} is a LIST but has {len(col.children)} children"
        )
    child = col.children[0]
    if child.name != "list":
        if strict:
            raise SchemaValidationError(
                f'field {se.name} is a LIST but its child is not named "list"'
            )
        # Backward-compatibility forms (LogicalTypes.md rules 1-4):
        #  1. repeated primitive field     -> field type is the element type
        #  2. repeated group, >1 children  -> the group is the element type
        #  3. repeated group named "array"/"<name>_tuple"/"bag", 1 child
        #  4. otherwise, repeated group with 1 child is the element itself
        if child.element.type is None and not child.children:
            raise SchemaValidationError(
                f"field {se.name} is a LIST but the repeated group inside it "
                'is not called "list" and contains no fields'
            )
    else:
        if (child.element.type is not None
                or child.element.repetition_type != FieldRepetitionType.REPEATED):
            raise SchemaValidationError(
                f"field {se.name} is a LIST but its child is not a repeated group"
            )
        if len(child.children) != 1:
            raise SchemaValidationError(
                f"field {se.name}.list has {len(child.children)} children"
            )
        elem = child.children[0]
        if elem.name != "element":
            raise SchemaValidationError(
                f'{se.name}.list has a child but it\'s called '
                f'{elem.name!r}, not "element"'
            )
        erep = elem.element.repetition_type
        if erep not in (FieldRepetitionType.OPTIONAL, FieldRepetitionType.REQUIRED):
            raise SchemaValidationError(
                f"{se.name}.list.element has disallowed repetition type {erep}"
            )
    # Validate the repeated child itself (covers backward-compat form 1,
    # where the element is a repeated primitive and has no children of its
    # own) — annotations on it must still type-check.
    _validate_column(child, is_root=False, strict=strict)


def _validate_map(col: ColumnDefinition, strict: bool) -> None:
    se = col.element
    if strict and se.converted_type == ConvertedType.MAP_KEY_VALUE:
        raise SchemaValidationError(
            f"field {se.name} is incorrectly annotated as MAP_KEY_VALUE"
        )
    if se.type is not None:
        raise SchemaValidationError(
            f"field {se.name} is not a group but annotated as MAP"
        )
    if len(col.children) != 1:
        raise SchemaValidationError(
            f"field {se.name} is a MAP but has {len(col.children)} children"
        )
    kv = col.children[0]
    if (kv.element.type is not None
            or kv.element.repetition_type != FieldRepetitionType.REPEATED):
        raise SchemaValidationError(
            f"field {se.name} is a MAP but its child is not a repeated group"
        )
    if strict:
        if kv.name != "key_value":
            raise SchemaValidationError(
                f'field {se.name} is a MAP but its child is not named "key_value"'
            )
        found_key = found_value = False
        for c in kv.children:
            if c.name == "key":
                if c.element.repetition_type != FieldRepetitionType.REQUIRED:
                    raise SchemaValidationError(
                        f'field {se.name}.key_value.key is not of repetition '
                        'type "required"'
                    )
                found_key = True
            elif c.name == "value":
                found_value = True
            else:
                raise SchemaValidationError(
                    f"field {se.name} is a MAP so {se.name}.key_value.{c.name} "
                    "is not allowed"
                )
        if not found_key:
            raise SchemaValidationError(
                f"field {se.name} is missing {se.name}.key_value.key"
            )
        if not found_value:
            raise SchemaValidationError(
                f"field {se.name} is missing {se.name}.key_value.value"
            )
    else:
        if len(kv.children) != 2:
            raise SchemaValidationError(
                f"field {se.name} is a MAP but {se.name}.{kv.name} contains "
                f"{len(kv.children)} children (expected 2)"
            )
    for c in kv.children:
        _validate_column(c, is_root=False, strict=strict)


def _validate_decimal(col: ColumnDefinition) -> None:
    se = col.element
    dec = se.logicalType.DECIMAL
    ptype = se.type
    if ptype == Type.INT32:
        lo, hi = 1, 9
    elif ptype == Type.INT64:
        lo, hi = 1, 18
    elif ptype == Type.FIXED_LEN_BYTE_ARRAY:
        # Spec: precision <= floor(log10(2^(8n-1) - 1)); for n=16 that is 38
        # (decimal128, as pyarrow/Spark emit).  floor(log10(x)) == digits-1.
        n = se.type_length or 0
        lo, hi = 1, len(str(2 ** (8 * n - 1) - 1)) - 1 if n else 0
    elif ptype == Type.BYTE_ARRAY:
        lo, hi = 1, None
    else:
        raise SchemaValidationError(
            f"field {se.name} is annotated as DECIMAL but type {ptype} is "
            "unsupported"
        )
    if dec.precision < lo or (hi is not None and dec.precision > hi):
        raise SchemaValidationError(
            f"field {se.name} is annotated as DECIMAL but precision "
            f"{dec.precision} is out of bounds"
        )
