"""A time of day for TIME logical columns: nanoseconds since midnight
and a UTC-adjusted flag, with the unit conversions the object mapper
uses for TIME(MILLIS|MICROS|NANOS).
"""

from __future__ import annotations

import datetime

__all__ = [
    "Time",
    "time_from_milliseconds",
    "time_from_microseconds",
    "time_from_nanoseconds",
]

_NS_PER_SEC = 1_000_000_000
_NS_PER_DAY = 86_400 * _NS_PER_SEC


class Time:
    """A time of day, independent of any date or timezone.

    ``Time(hours, minutes, seconds, nanoseconds)`` checks each
    component's range.
    """

    __slots__ = ("_ns", "utc")

    def __init__(self, hours: int = 0, minutes: int = 0, seconds: int = 0,
                 nanoseconds: int = 0, *, utc: bool = True):
        if not 0 <= hours < 24:
            raise ValueError(f"hours out of range: {hours}")
        if not 0 <= minutes < 60:
            raise ValueError(f"minutes out of range: {minutes}")
        if not 0 <= seconds < 60:
            raise ValueError(f"seconds out of range: {seconds}")
        if not 0 <= nanoseconds < _NS_PER_SEC:
            raise ValueError(f"nanoseconds out of range: {nanoseconds}")
        self._ns = ((hours * 3600 + minutes * 60 + seconds) * _NS_PER_SEC
                    + nanoseconds)
        self.utc = utc

    # -- accessors ---------------------------------------------------------

    @property
    def hour(self) -> int:
        return self._ns // (3600 * _NS_PER_SEC)

    @property
    def minute(self) -> int:
        return self._ns // (60 * _NS_PER_SEC) % 60

    @property
    def second(self) -> int:
        return self._ns // _NS_PER_SEC % 60

    @property
    def nanosecond(self) -> int:
        return self._ns % _NS_PER_SEC

    def milliseconds(self) -> int:
        """Since midnight — the TIME_MILLIS int32 column value."""
        return self._ns // 1_000_000

    def microseconds(self) -> int:
        """Since midnight — the TIME_MICROS int64 column value."""
        return self._ns // 1_000

    def nanoseconds(self) -> int:
        """Since midnight — the TIME(NANOS) int64 column value."""
        return self._ns

    # -- conversions -------------------------------------------------------

    def to_datetime_time(self) -> datetime.time:
        return datetime.time(self.hour, self.minute, self.second,
                             self.nanosecond // 1000)

    @classmethod
    def from_datetime_time(cls, t: datetime.time, *, utc: bool = True):
        return cls(t.hour, t.minute, t.second, t.microsecond * 1000, utc=utc)

    def utc_adjusted(self, utc: bool = True) -> "Time":
        out = Time.__new__(Time)
        out._ns = self._ns
        out.utc = utc
        return out

    # -- dunder ------------------------------------------------------------

    def __eq__(self, other) -> bool:
        return isinstance(other, Time) and self._ns == other._ns

    def __hash__(self) -> int:
        return hash(("floor.Time", self._ns))

    def __repr__(self) -> str:
        return (f"Time({self.hour:02d}:{self.minute:02d}:{self.second:02d}"
                f".{self.nanosecond:09d}, utc={self.utc})")


def _from_ns(ns: int, utc: bool) -> Time:
    if not 0 <= ns < _NS_PER_DAY:
        raise ValueError(f"nanoseconds since midnight out of range: {ns}")
    out = Time.__new__(Time)
    out._ns = ns
    out.utc = utc
    return out


def time_from_milliseconds(ms: int, *, utc: bool = True) -> Time:
    return _from_ns(ms * 1_000_000, utc)


def time_from_microseconds(us: int, *, utc: bool = True) -> Time:
    return _from_ns(us * 1_000, utc)


def time_from_nanoseconds(ns: int, *, utc: bool = True) -> Time:
    return _from_ns(ns, utc)
