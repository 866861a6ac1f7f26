"""Typed schema construction in code.

The constructor counterpart of the DSL: ``ColumnDefinition`` subtrees
built without schema text, the three-level LIST and MAP group shapes
assembled for the caller.  The results feed ``SchemaDefinition`` (and
:func:`new_root` makes a whole one) and pass ``validate_strict``: the
same trees ``parse_schema_definition`` makes of the equivalent text.

Logical types are passed as a ``LogicalType`` (or through the
``logical_*`` helpers below); the matching converted type is filled in
for format-v1 readers, as the DSL parser does.
"""

from __future__ import annotations

from .dsl import ColumnDefinition, SchemaDefinition, SchemaValidationError
from .metadata import (
    BsonType,
    ConvertedType,
    DateType,
    DecimalType,
    EnumType,
    FieldRepetitionType,
    IntType,
    JsonType,
    ListType,
    LogicalType,
    MapType,
    MicroSeconds,
    MilliSeconds,
    NanoSeconds,
    SchemaElement,
    StringType,
    TimestampType,
    TimeType,
    TimeUnit,
    Type,
    UUIDType,
)

__all__ = [
    "new_data_column",
    "new_group",
    "new_list_column",
    "new_map_column",
    "new_root",
    "logical_string",
    "logical_date",
    "logical_uuid",
    "logical_enum",
    "logical_json",
    "logical_bson",
    "logical_int",
    "logical_decimal",
    "logical_time",
    "logical_timestamp",
]

REQUIRED = FieldRepetitionType.REQUIRED
OPTIONAL = FieldRepetitionType.OPTIONAL
REPEATED = FieldRepetitionType.REPEATED


# -- logical-type helpers --------------------------------------------------

def logical_string() -> LogicalType:
    return LogicalType(STRING=StringType())


def logical_date() -> LogicalType:
    return LogicalType(DATE=DateType())


def logical_uuid() -> LogicalType:
    return LogicalType(UUID=UUIDType())


def logical_enum() -> LogicalType:
    return LogicalType(ENUM=EnumType())


def logical_json() -> LogicalType:
    return LogicalType(JSON=JsonType())


def logical_bson() -> LogicalType:
    return LogicalType(BSON=BsonType())


def logical_int(bit_width: int, signed: bool = True) -> LogicalType:
    if bit_width not in (8, 16, 32, 64):
        raise SchemaValidationError(f"INT: unsupported bitwidth {bit_width}")
    return LogicalType(INTEGER=IntType(bitWidth=bit_width, isSigned=signed))


def logical_decimal(precision: int, scale: int) -> LogicalType:
    return LogicalType(DECIMAL=DecimalType(scale=scale, precision=precision))


def _time_unit(unit: str) -> TimeUnit:
    u = unit.upper()
    if u == "MILLIS":
        return TimeUnit(MILLIS=MilliSeconds())
    if u == "MICROS":
        return TimeUnit(MICROS=MicroSeconds())
    if u == "NANOS":
        return TimeUnit(NANOS=NanoSeconds())
    raise SchemaValidationError(f"unsupported time unit {unit!r}")


def logical_time(unit: str = "MILLIS", utc: bool = True) -> LogicalType:
    return LogicalType(TIME=TimeType(isAdjustedToUTC=utc,
                                     unit=_time_unit(unit)))


def logical_timestamp(unit: str = "MILLIS", utc: bool = True) -> LogicalType:
    return LogicalType(TIMESTAMP=TimestampType(isAdjustedToUTC=utc,
                                               unit=_time_unit(unit)))


def _converted_for(lt: LogicalType, se: SchemaElement) -> None:
    """Populate the legacy converted type (and DECIMAL scale/precision)
    matching a new-style logical type — the same v1 forward-compat
    mapping the DSL parser applies.  UUID and
    NANOS-unit types have no legacy equivalent and set nothing."""
    if lt.STRING is not None:
        se.converted_type = ConvertedType.UTF8
    elif lt.DATE is not None:
        se.converted_type = ConvertedType.DATE
    elif lt.ENUM is not None:
        se.converted_type = ConvertedType.ENUM
    elif lt.JSON is not None:
        se.converted_type = ConvertedType.JSON
    elif lt.BSON is not None:
        se.converted_type = ConvertedType.BSON
    elif lt.INTEGER is not None:
        it = lt.INTEGER
        se.converted_type = ConvertedType[
            ("INT_" if it.isSigned else "UINT_") + str(it.bitWidth)]
    elif lt.DECIMAL is not None:
        se.scale = lt.DECIMAL.scale
        se.precision = lt.DECIMAL.precision
        se.converted_type = ConvertedType.DECIMAL
    elif lt.TIME is not None:
        if lt.TIME.unit.MILLIS is not None:
            se.converted_type = ConvertedType.TIME_MILLIS
        elif lt.TIME.unit.MICROS is not None:
            se.converted_type = ConvertedType.TIME_MICROS
    elif lt.TIMESTAMP is not None:
        if lt.TIMESTAMP.unit.MILLIS is not None:
            se.converted_type = ConvertedType.TIMESTAMP_MILLIS
        elif lt.TIMESTAMP.unit.MICROS is not None:
            se.converted_type = ConvertedType.TIMESTAMP_MICROS
    elif lt.LIST is not None:
        se.converted_type = ConvertedType.LIST
    elif lt.MAP is not None:
        se.converted_type = ConvertedType.MAP


# -- constructors ----------------------------------------------------------

def new_data_column(
    name: str,
    ptype: Type,
    repetition: FieldRepetitionType = REQUIRED,
    *,
    logical_type: LogicalType | None = None,
    converted_type: ConvertedType | None = None,
    type_length: int | None = None,
    field_id: int | None = None,
) -> ColumnDefinition:
    """A leaf data column.

    ``logical_type`` auto-fills the matching converted type (and
    DECIMAL scale/precision); pass ``converted_type`` alone for a
    legacy-only annotation."""
    ptype = Type(ptype)
    if ptype == Type.FIXED_LEN_BYTE_ARRAY and not type_length:
        raise SchemaValidationError(
            f"column {name!r}: FIXED_LEN_BYTE_ARRAY needs type_length")
    se = SchemaElement(
        name=name, type=ptype,
        repetition_type=FieldRepetitionType(repetition),
        type_length=type_length, field_id=field_id,
    )
    if logical_type is not None:
        se.logicalType = logical_type
        _converted_for(logical_type, se)
    if converted_type is not None:
        se.converted_type = ConvertedType(converted_type)
    return ColumnDefinition(se)


def new_group(
    name: str,
    repetition: FieldRepetitionType = REQUIRED,
    children: list[ColumnDefinition] | tuple = (),
    *,
    field_id: int | None = None,
) -> ColumnDefinition:
    """A plain (unannotated) group node; its children here or appended
    later."""
    se = SchemaElement(name=name,
                       repetition_type=FieldRepetitionType(repetition),
                       field_id=field_id)
    return ColumnDefinition(se, list(children))


def new_list_column(
    name: str,
    element: ColumnDefinition,
    repetition: FieldRepetitionType = OPTIONAL,
) -> ColumnDefinition:
    """The canonical three-level LIST shape::

        <repetition> group <name> (LIST) {
          repeated group list {
            <element renamed "element">;
          }
        }

    The element keeps its own repetition (required/optional) and may
    itself be a group, another list, or a map."""
    repetition = FieldRepetitionType(repetition)
    if repetition == REPEATED:
        raise SchemaValidationError(
            f"LIST column {name!r} cannot itself be repeated")
    if element.element.repetition_type == REPEATED:
        raise SchemaValidationError(
            f"LIST element of {name!r} cannot be repeated "
            "(the repeated level is the generated 'list' group)")
    element.element.name = "element"
    se = SchemaElement(name=name, repetition_type=repetition,
                       logicalType=LogicalType(LIST=ListType()),
                       converted_type=ConvertedType.LIST)
    inner = SchemaElement(name="list", repetition_type=REPEATED)
    return ColumnDefinition(se, [ColumnDefinition(inner, [element])])


def new_map_column(
    name: str,
    key: ColumnDefinition,
    value: ColumnDefinition,
    repetition: FieldRepetitionType = OPTIONAL,
) -> ColumnDefinition:
    """The canonical MAP shape::

        <repetition> group <name> (MAP) {
          repeated group key_value (MAP_KEY_VALUE) {
            required <key renamed "key">;
            <value renamed "value">;
          }
        }

    The key must be REQUIRED (a rule of the spec); the value may be
    optional, a group, a list, or a map."""
    repetition = FieldRepetitionType(repetition)
    if repetition == REPEATED:
        raise SchemaValidationError(
            f"MAP column {name!r} cannot itself be repeated")
    if key.element.repetition_type != REQUIRED:
        raise SchemaValidationError(
            "the key repetition type should be REQUIRED")
    if value.element.repetition_type == REPEATED:
        raise SchemaValidationError(
            f"MAP value of {name!r} cannot be repeated")
    key.element.name = "key"
    value.element.name = "value"
    se = SchemaElement(name=name, repetition_type=repetition,
                       logicalType=LogicalType(MAP=MapType()),
                       converted_type=ConvertedType.MAP)
    kv = SchemaElement(name="key_value", repetition_type=REPEATED,
                       converted_type=ConvertedType.MAP_KEY_VALUE)
    return ColumnDefinition(se, [ColumnDefinition(kv, [key, value])])


def new_root(name: str = "msg",
             children: list[ColumnDefinition] | tuple = ()
             ) -> SchemaDefinition:
    """Assemble a whole ``SchemaDefinition`` from constructed columns —
    ``FileWriter(..., schema=new_root("m", [...]))`` without DSL text."""
    root = SchemaElement(name=name)
    return SchemaDefinition(ColumnDefinition(root, list(children)))
