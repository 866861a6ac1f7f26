"""INT96 timestamps (the legacy Impala and Hive encoding): 12
little-endian bytes, the nanoseconds within the day as a uint64 and then
the Julian day number as a uint32.  A datetime before 1970 lands on an
earlier Julian day with a non-negative time of day.
"""

from __future__ import annotations

import datetime

__all__ = ["int96_to_datetime", "datetime_to_int96"]

_JULIAN_UNIX_EPOCH = 2_440_588  # Julian day of 1970-01-01
_NS_PER_DAY = 86_400 * 1_000_000_000


def int96_to_datetime(b: bytes) -> datetime.datetime:
    """12-byte INT96 -> naive UTC datetime (microsecond resolution)."""
    if len(b) != 12:
        raise ValueError(f"INT96 must be 12 bytes, got {len(b)}")
    nanos = int.from_bytes(b[:8], "little")
    jd = int.from_bytes(b[8:12], "little")
    days = jd - _JULIAN_UNIX_EPOCH
    epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    dt = epoch + datetime.timedelta(days=days, microseconds=nanos // 1000)
    return dt.replace(tzinfo=None)


def datetime_to_int96(dt: datetime.datetime) -> bytes:
    """Naive-UTC (or aware) datetime -> 12-byte INT96."""
    if dt.tzinfo is not None:
        dt = dt.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    epoch = datetime.datetime(1970, 1, 1)
    delta = dt - epoch
    jd = delta.days + _JULIAN_UNIX_EPOCH
    nanos = (delta.seconds * 1_000_000 + delta.microseconds) * 1000
    return nanos.to_bytes(8, "little") + jd.to_bytes(4, "little")
