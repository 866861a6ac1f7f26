"""floor: the object mapper.

Write dataclasses (or anything with ``marshal_parquet``) straight to
Parquet, row by row or a row group at a time, and read rows back into
typed objects.
"""

from .reader import Reader, new_file_reader  # noqa: F401
from .reflect import field_name, from_row, schema_of, to_row  # noqa: F401
from .time import (  # noqa: F401
    Time,
    time_from_microseconds,
    time_from_milliseconds,
    time_from_nanoseconds,
)
from .writer import Writer, new_file_writer  # noqa: F401
