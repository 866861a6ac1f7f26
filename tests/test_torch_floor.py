"""The port's object mapper (``floor``) and INT96 times against the JAX
package's.

The cases of ``tests/test_floor.py`` run on both packages with the JAX
side beside each: ``Time`` and the INT96 conversion, ``schema_of`` text,
``to_row``/``from_row`` through files, the row and the columnar paths
(flat, STRUCT, MAP, LIST-of-primitive and LIST-of-struct fields) and
their refusals.  Each package gets its own dataclasses (they name its
``Time``); files are written with the same ``created_by`` and compared
byte for byte, objects by ``repr`` (the same class names and fields),
errors by class and words.
"""

import dataclasses
import datetime
import io
import os
import uuid
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import pytest

import tpuparquet.floor as jax_floor
import tpuparquet.format.dsl as jax_dsl
import tpuparquet.int96_time as jax_int96
from tpuparquet import FileReader as JaxFileReader
from tpuparquet import FileWriter as JaxFileWriter
import tpuparquet_torch.floor as port_floor
import tpuparquet_torch.format.dsl as port_dsl
import tpuparquet_torch.int96_time as port_int96
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter

CREATED_BY = "tpuparquet"


def _classes(F):
    """The test dataclasses of one package (its ``Time``)."""

    @dataclass
    class Inner:
        x: int
        y: Optional[str] = None

    @dataclass
    class Record:
        ident: int
        name: str
        score: float
        ok: bool
        raw: bytes
        maybe: Optional[int] = None
        tags: Optional[list[str]] = None
        attrs: Optional[dict[str, int]] = None
        inner: Optional[Inner] = None
        born: Optional[datetime.date] = None
        seen: Optional[datetime.datetime] = None
        at: Optional[F.Time] = None
        uid: Optional[uuid.UUID] = None

    @dataclass
    class Flat:
        ident: int
        name: str
        score: float
        ok: bool
        maybe: Optional[int] = None
        born: Optional[datetime.date] = None
        seen: Optional[datetime.datetime] = None

    @dataclass
    class WithLists:
        ident: int
        tags: Optional[list[str]] = None
        nums: Optional[list[int]] = None

    @dataclass
    class Tag:
        label: Optional[str] = None
        weight: Optional[float] = None

    @dataclass
    class Loc:
        lat: float = 0.0
        lon: Optional[float] = None
        tag: Optional[Tag] = None

    @dataclass
    class Rec:
        ident: int = 0
        loc: Optional[Loc] = None
        note: Optional[str] = None

    @dataclass
    class E:
        x: int = 0
        y: Optional[str] = None

    @dataclass
    class L:
        ident: int = 0
        items: Optional[list[E]] = None

    @dataclass
    class M:
        ident: int = 0
        attrs: Optional[dict[str, int]] = None

    @dataclass
    class Child:
        x: int = 0

    @dataclass
    class MapHolder:
        m: Optional[dict[str, Child]] = None

    @dataclass
    class OneElem:
        x: Optional[int] = None

    @dataclass
    class OneHolder:
        items: Optional[list[OneElem]] = None

    @dataclass
    class T:
        tms: F.Time
        tus: F.Time
        tns: F.Time
        ts_ms: datetime.datetime
        ts_ns: datetime.datetime

    return SimpleNamespace(**{k: v for k, v in locals().items()
                              if isinstance(v, type)})


JAX = SimpleNamespace(name="jax", floor=jax_floor, dsl=jax_dsl,
                      int96=jax_int96, FileReader=JaxFileReader,
                      FileWriter=JaxFileWriter, C=_classes(jax_floor))
PORT = SimpleNamespace(name="port", floor=port_floor, dsl=port_dsl,
                       int96=port_int96, FileReader=FileReader,
                       FileWriter=FileWriter, C=_classes(port_floor))
SIDES = (JAX, PORT)


def both(fn):
    """``fn(side)`` on each package; the two results (``repr`` of objects,
    bytes of files) must be equal; returns the port's."""
    got = [fn(S) for S in SIDES]
    assert got[1] == got[0]
    return got[1]


def raised(fn, *errors):
    """``(class name, words)`` of what ``fn()`` raises."""
    with pytest.raises(errors or Exception) as ei:
        fn()
    return type(ei.value).__name__, str(ei.value)


def write(S, schema=None, cls=None, rows=(), columns=None, path=None):
    """A file of ``rows`` (``write_many``) and ``columns`` (one
    ``write_columns`` call each) through ``new_file_writer``; its
    bytes."""
    target = path or io.BytesIO()
    w = S.floor.new_file_writer(target, schema, cls=cls,
                                created_by=CREATED_BY)
    if rows:
        w.write_many(rows)
    for batch in columns or ():
        w.write_columns(batch)
    w.close()
    if path:
        with open(path, "rb") as f:
            return f.read()
    return target.getvalue()


def read(S, blob, cls=None, columns=False):
    r = S.floor.Reader(S.FileReader(io.BytesIO(blob)), cls=cls)
    if columns:
        return r.read_columns(0)
    return list(r)


def sample(S):
    C = S.C
    return [
        C.Record(
            ident=1, name="alpha", score=1.5, ok=True, raw=b"\x00\x01",
            maybe=7, tags=["a", "b"], attrs={"k": 1, "j": 2},
            inner=C.Inner(x=10, y="deep"),
            born=datetime.date(1999, 12, 31),
            seen=datetime.datetime(2024, 5, 4, 3, 2, 1, 654_321),
            at=S.floor.Time(12, 30, 15, 250_000_000),
            uid=uuid.UUID("12345678-1234-5678-1234-567812345678")),
        C.Record(ident=2, name="beta", score=-2.25, ok=False, raw=b""),
    ]


# ----------------------------------------------------------------------
# Time and INT96
# ----------------------------------------------------------------------

class TestTime:
    def test_accessors_and_units(self):
        def run(S):
            t = S.floor.Time(13, 37, 42, 123_456_789)
            ns = t.nanoseconds()
            return (t.hour, t.minute, t.second, t.nanosecond,
                    t.milliseconds(), t.microseconds(), ns, repr(t),
                    repr(S.floor.time_from_milliseconds(ns // 10**6)),
                    repr(S.floor.time_from_microseconds(ns // 1000)),
                    repr(S.floor.time_from_nanoseconds(ns)),
                    repr(t.utc_adjusted(False)),
                    t.to_datetime_time(),
                    repr(S.floor.Time.from_datetime_time(
                        datetime.time(23, 59, 58, 999_999))),
                    hash(t) == hash(S.floor.Time(13, 37, 42, 123_456_789)))
        assert both(run)[-1]

    @pytest.mark.parametrize("kw", [
        {"hours": 24}, {"minutes": 60}, {"seconds": 61},
        {"nanoseconds": 10**9}, {"hours": -1}])
    def test_range_validation(self, kw):
        both(lambda S: raised(lambda: S.floor.Time(**kw), ValueError))

    @pytest.mark.parametrize("ns", [-1, 86_400 * 10**9])
    def test_from_units_out_of_range(self, ns):
        both(lambda S: raised(
            lambda: S.floor.time_from_nanoseconds(ns), ValueError))


INT96_TIMES = [
    datetime.datetime(1970, 1, 1),
    datetime.datetime(1969, 12, 31, 23, 59, 59, 999_999),
    datetime.datetime(1969, 12, 31, 0, 0, 0, 1),
    datetime.datetime(1900, 3, 1, 12),
    datetime.datetime(1582, 10, 15, 6, 30),
    datetime.datetime(2000, 2, 29, 0, 0),
    datetime.datetime(2024, 2, 29, 23, 59, 59, 999_999),
    datetime.datetime(2023, 12, 31, 23, 59, 59, 999_999),
    datetime.datetime(2038, 1, 19, 3, 14, 8),
    datetime.datetime(9999, 12, 31, 23, 59, 59, 999_999),
    datetime.datetime(2024, 6, 1, 12, tzinfo=datetime.timezone(
        datetime.timedelta(hours=-7))),
]


class TestInt96:
    @pytest.mark.parametrize("dt", INT96_TIMES,
                             ids=[d.isoformat() for d in INT96_TIMES])
    def test_bytes_and_round_trip(self, dt):
        b = both(lambda S: S.int96.datetime_to_int96(dt))
        back = both(lambda S: S.int96.int96_to_datetime(b))
        want = dt if dt.tzinfo is None else dt.astimezone(
            datetime.timezone.utc).replace(tzinfo=None)
        assert back == want

    def test_epoch(self):
        assert both(lambda S: S.int96.datetime_to_int96(
            datetime.datetime(1970, 1, 1))) == \
            (0).to_bytes(8, "little") + (2440588).to_bytes(4, "little")

    @pytest.mark.parametrize("b", [b"short", b"\x00" * 13])
    def test_bad_length(self, b):
        both(lambda S: raised(lambda: S.int96.int96_to_datetime(b),
                              ValueError))


# ----------------------------------------------------------------------
# reflection through files
# ----------------------------------------------------------------------

class TestReflectionRoundTrip:
    def test_schema_of_text_parses(self):
        def run(S):
            text = S.floor.schema_of(S.C.Record)
            sd = S.dsl.parse_schema_definition(text)
            return text, str(sd), [c.name for c in sd.root.children]
        text, _, names = both(run)
        assert names[-1] == "uid" and "TIME(MICROS, true)" in text

    def test_write_read_objects(self):
        def run(S):
            blob = write(S, cls=S.C.Record, rows=sample(S))
            got = read(S, blob, S.C.Record)
            assert got == sample(S)
            return blob, repr(got)
        both(run)

    def test_to_row_and_from_row(self):
        def run(S):
            schema = S.FileWriter(io.BytesIO(), S.floor.schema_of(
                S.C.Record)).schema
            rows = [S.floor.to_row(o, schema) for o in sample(S)]
            back = [S.floor.from_row(r, S.C.Record, schema) for r in rows]
            return repr(rows), repr(back)
        both(run)

    def test_scan_to_plain_dict(self):
        def run(S):
            blob = write(S, cls=S.C.Record, rows=sample(S)[:1])
            r = S.floor.Reader(S.FileReader(io.BytesIO(blob)))
            assert r.next()
            return repr(r.scan())
        both(run)

    def test_explicit_schema_with_time_units(self):
        schema = """message m {
            required int32 tms (TIME(MILLIS, true));
            required int64 tus (TIME(MICROS, true));
            required int64 tns (TIME(NANOS, true));
            required int64 ts_ms (TIMESTAMP(MILLIS, true));
            required int64 ts_ns (TIMESTAMP(NANOS, true));
        }"""

        def run(S):
            t = S.floor.Time(6, 7, 8, 123_000_000)
            rec = S.C.T(tms=t, tus=t, tns=t,
                        ts_ms=datetime.datetime(2020, 1, 2, 3, 4, 5, 678_000),
                        ts_ns=datetime.datetime(2020, 1, 2, 3, 4, 5,
                                                678_901))
            blob = write(S, schema, rows=[rec])
            (got,) = read(S, blob, S.C.T)
            assert got.tns == t and got.ts_ns == rec.ts_ns
            return blob, repr(got)
        both(run)

    def test_parquet_field_name_metadata(self):
        @dataclass
        class Tagged:
            py_name: int = field(metadata={"parquet": "wire_name"})

        def run(S):
            blob = write(S, "message m { required int64 wire_name; }",
                         rows=[Tagged(py_name=42)])
            rows = list(S.FileReader(io.BytesIO(blob)).rows())
            return blob, rows, read(S, blob, Tagged)
        assert both(run)[2] == [Tagged(py_name=42)]

    def test_custom_marshaller_hooks(self):
        class Custom:
            def __init__(self, a=None):
                self.a = a

            def marshal_parquet(self):
                return {"a": self.a * 2}

            def unmarshal_parquet(self, row):
                self.a = row["a"] + 1

        def run(S):
            blob = write(S, "message m { required int64 a; }",
                         rows=[Custom(a=5)])
            r = S.floor.Reader(S.FileReader(io.BytesIO(blob)))
            assert r.next()
            return blob, r.scan(Custom()).a
        assert both(run)[1] == 11

    def test_uuid_wrong_length_rejected(self):
        both(lambda S: raised(lambda: S.floor.new_file_writer(
            io.BytesIO(),
            "message m { required fixed_len_byte_array(8) u (UUID); }"),
            S.dsl.SchemaValidationError))

    def test_missing_required_field_raises(self):
        def run(S):
            w = S.floor.new_file_writer(io.BytesIO(),
                                        "message m { required int64 a; }")
            return raised(lambda: w.write({"a": None}), ValueError,
                          TypeError)
        both(run)

    def test_int96_timestamp_round_trip(self):
        @dataclass
        class Ev:
            when: datetime.datetime

        def run(S):
            dt = datetime.datetime(2023, 7, 14, 9, 8, 7, 654_321)
            blob = write(S, "message m { required int96 when; }",
                         rows=[Ev(when=dt), Ev(when=INT96_TIMES[1])])
            return blob, read(S, blob, Ev)
        assert both(run)[1][1].when == INT96_TIMES[1]

    def test_pyarrow_reads_floor_file(self):
        pytest.importorskip("pyarrow")
        import pyarrow.parquet as pq

        blob = both(lambda S: write(S, cls=S.C.Record, rows=sample(S)))
        rows = pq.read_table(io.BytesIO(blob)).to_pylist()
        assert rows[0]["born"] == datetime.date(1999, 12, 31)
        assert rows[0]["tags"] == ["a", "b"] and rows[1]["maybe"] is None

    def test_pep604_optional_hints(self):
        @dataclass
        class P:
            a: int
            b: "int | None" = None
            t: "datetime.time | None" = None

        def run(S):
            rec = P(a=1, b=None, t=datetime.time(10, 20, 30))
            blob = write(S, cls=P, rows=[rec])
            return S.floor.schema_of(P), blob, read(S, blob, P)
        assert both(run)[2] == [P(a=1, b=None, t=datetime.time(10, 20, 30))]

    def test_legacy_list_names(self):
        @dataclass
        class L2:
            xs: list[int]
            ys: list[int]

        schema = """message m {
            optional group xs (LIST) { repeated group bag {
                optional int64 item; } }
            optional group ys (LIST) { repeated int64 ys_tuple; }
        }"""

        def run(S):
            blob = write(S, schema, rows=[L2(xs=[1, 2, 3], ys=[4, 5])])
            return blob, read(S, blob, L2)
        assert both(run)[1] == [L2(xs=[1, 2, 3], ys=[4, 5])]

    def test_scan_with_hook_class_builds_instance(self):
        @dataclass
        class H:
            a: int = 0

            def unmarshal_parquet(self, row):  # pragma: no cover
                raise AssertionError("hook must not fire for a class")

        def run(S):
            blob = write(S, "message m { required int64 a; }",
                         rows=[{"a": 3}])
            r = S.floor.Reader(S.FileReader(io.BytesIO(blob)))
            assert r.next()
            return r.scan(H)
        assert both(run) == H(a=3)

    def test_writer_closes_file_on_bad_schema(self, tmp_path):
        def run(S):
            p = tmp_path / f"{S.name}.parquet"
            p.write_bytes(b"PREEXISTING")
            return raised(lambda: S.floor.new_file_writer(
                str(p), "message m { required fixed_len_byte_array(8) u "
                "(UUID); }"))
        both(run)

    def test_new_file_writer_needs_schema_or_dataclass(self):
        both(lambda S: raised(lambda: S.floor.new_file_writer(
            io.BytesIO()), TypeError))

    def test_repeated_leaf_legacy(self, tmp_path):
        @dataclass
        class R:
            vals: list[int]

        def run(S):
            p = str(tmp_path / f"{S.name}.parquet")
            blob = write(S, "message m { repeated int64 vals; }",
                         rows=[R(vals=[1, 2, 3]), R(vals=[])], path=p)
            r = S.floor.new_file_reader(p, R)
            got = list(r)
            r.close()
            return blob, got
        assert both(run)[1][0].vals == [1, 2, 3]


# ----------------------------------------------------------------------
# the columnar paths
# ----------------------------------------------------------------------

def _flat_objs(C, n=200):
    return [C.Flat(ident=i, name=f"n{i % 13}", score=i / 7, ok=i % 3 == 0,
                   maybe=None if i % 5 == 0 else i * 2,
                   born=None if i % 4 == 0 else
                   datetime.date(2000, 1, 1 + i % 28),
                   seen=None if i % 6 == 0 else
                   datetime.datetime(2024, 1, 1, 0, 0, i % 60))
            for i in range(n)]


def _list_objs(C, n=60):
    return [C.WithLists(
        ident=i,
        tags=(None if i % 7 == 0 else
              [None if j % 4 == 3 else f"t{i}_{j}" for j in range(i % 5)]),
        nums=None if i % 5 == 0 else list(range(i % 4))) for i in range(n)]


def _struct_objs(C, n=60):
    out = []
    for i in range(n):
        if i % 5 == 0:
            loc = None
        elif i % 5 == 1:
            loc = C.Loc(lat=float(i), lon=None, tag=None)
        elif i % 5 == 2:
            loc = C.Loc(lat=float(i), lon=i / 2, tag=C.Tag(None, None))
        else:
            loc = C.Loc(lat=float(i), lon=i / 2, tag=C.Tag(f"t{i}", i / 4))
        out.append(C.Rec(ident=i, loc=loc,
                         note=None if i % 3 == 0 else f"n{i}"))
    return out


STRUCT_SCHEMA = """message rec {
  required int64 ident (INT(64,true));
  optional group loc {
    required double lat;
    optional double lon;
    optional group tag {
      optional binary label (STRING);
      optional double weight;
    }
  }
  optional binary note (STRING);
}"""


def _cases():
    """name -> (schema or None, class name, objects(C))."""
    return {
        "flat": (None, "Flat", _flat_objs),
        "full record": (None, "Record", lambda C: None),
        "lists": (None, "WithLists", _list_objs),
        "structs": (STRUCT_SCHEMA, "Rec", _struct_objs),
        "list of structs": (None, "L", lambda C: [
            C.L(1, [C.E(1, "a"), C.E(2, None)]), C.L(2, None), C.L(3, []),
            C.L(4, [C.E(7, "z")]), C.L(5, [None, C.E(3, "b"), None])]),
        "maps": (None, "M", lambda C: [
            C.M(1, {"a": 1, "b": 2}), C.M(2, None), C.M(3, {}),
            C.M(4, {"z": None}), C.M(5, {"q": 9})]),
        "one-field elements": (None, "OneHolder", lambda C: [
            C.OneHolder([C.OneElem(1), C.OneElem(None)]), C.OneHolder(None),
            C.OneHolder([]), C.OneHolder([None, C.OneElem(3)])]),
    }


class TestColumnarPaths:
    @pytest.mark.parametrize("case", list(_cases()))
    def test_columnar_equals_row_path(self, case):
        """``write_columns`` and ``write_many`` of the same objects read
        back equal (iteration and ``read_columns``), the files byte-equal
        to the JAX package's."""
        schema, cname, make = _cases()[case]

        def run(S):
            cls = getattr(S.C, cname)
            objs = make(S.C) or sample(S)
            rows = write(S, schema, cls=cls, rows=objs)
            cols = write(S, schema, cls=cls, columns=[objs])
            want = read(S, rows, cls)
            assert read(S, cols, cls) == want
            assert read(S, cols, cls, columns=True) == want
            assert read(S, rows, cls, columns=True) == want
            return rows, cols, repr(want)
        both(run)

    def test_required_null_rejected(self):
        def run(S):
            objs = _flat_objs(S.C, 3)
            objs[1] = S.C.Flat(ident=1, name=None, score=0.0, ok=True)
            w = S.floor.new_file_writer(io.BytesIO(), cls=S.C.Flat)
            err = raised(lambda: w.write_columns(objs), ValueError)
            w.write_columns(_flat_objs(S.C, 3))
            return err
        both(run)

    def test_marshal_hook_rejected(self):
        @dataclass
        class Hooked:
            ident: int

            def marshal_parquet(self):
                return {"ident": self.ident * 100}

        def run(S):
            w = S.floor.new_file_writer(io.BytesIO(),
                                        S.floor.schema_of(Hooked))
            return raised(lambda: w.write_columns([Hooked(ident=1)]),
                          TypeError)
        assert "marshal_parquet" in both(run)[1]

    def test_read_columns_needs_cls(self):
        def run(S):
            blob = write(S, cls=S.C.Flat, columns=[_flat_objs(S.C, 3)])
            r = S.floor.Reader(S.FileReader(io.BytesIO(blob)))
            return raised(lambda: r.read_columns(0), TypeError)
        both(run)

    def test_required_list_none_rejected(self):
        @dataclass
        class R:
            tags: list[str]

        schema = ("message m { required group tags (LIST) "
                  "{ repeated group list { required binary element "
                  "(STRING); } } }")

        def run(S):
            w = S.floor.new_file_writer(io.BytesIO(), schema,
                                        created_by=CREATED_BY)
            errs = [raised(lambda: w.write_columns([R(tags=None)]),
                           ValueError),
                    raised(lambda: w.write_columns([R(tags=["a", None])]),
                           ValueError)]
            w.write_columns([R(tags=["a", "b"]), R(tags=[])])
            return errs
        both(run)

    def test_required_group_none_rejected(self):
        schema = """message m {
          required group g { required int64 a (INT(64,true)); }
        }"""

        @dataclass
        class G:
            a: int = 0

        @dataclass
        class MG:
            g: Optional[G] = None

        def run(S):
            w = S.floor.Writer(S.FileWriter(io.BytesIO(), schema))
            return raised(lambda: w.write_columns([MG(g=None)]),
                          ValueError)
        both(run)

    def test_dicts_and_projection(self):
        def run(S):
            objs = _struct_objs(S.C, 20)
            dicts = [dataclasses.asdict(o) for o in objs]
            blob = write(S, STRUCT_SCHEMA, columns=[dicts])
            assert read(S, blob, S.C.Rec, columns=True) == objs
            fr = S.FileReader(io.BytesIO(blob), "ident", "note")
            got = S.floor.Reader(fr, cls=S.C.Rec).read_columns(0)
            assert all(g.loc is None for g in got)
            return blob, repr(got)
        both(run)

    def test_uuid_and_unmatched_fields(self):
        @dataclass
        class WithUuid:
            ident: int
            uid: Optional[uuid.UUID] = None

        @dataclass
        class NoMatch:
            other: Optional[int] = None

        def run(S):
            objs = [WithUuid(ident=i, uid=None if i % 3 == 0 else
                             uuid.UUID(int=i * 7919)) for i in range(30)]
            blob = write(S, cls=WithUuid, columns=[objs])
            assert read(S, blob, WithUuid, columns=True) == objs
            r = S.floor.Reader(S.FileReader(io.BytesIO(blob)))
            return blob, r.read_columns(0, cls=NoMatch)
        assert both(run)[1] == [NoMatch()] * 30

    def test_element_hint_suppresses_decoding(self):
        @dataclass
        class B:
            tags: Optional[list[Optional[bytes]]] = None

        schema = ("message m { optional group tags (LIST) { repeated "
                  "group list { optional binary element (STRING); } } }")

        def run(S):
            objs = [B(tags=[b"ab", None, b"cd"]), B(tags=None)]
            blob = write(S, schema, columns=[objs])
            assert read(S, blob, B) == read(S, blob, B, columns=True) \
                == objs
            return blob
        both(run)

    def test_list_of_dates_and_times(self):
        @dataclass
        class R:
            days: Optional[list[datetime.date]] = None
            stamps: Optional[list[datetime.datetime]] = None

        def run(S):
            objs = [R(days=[datetime.date(2024, 1, i + 1) for i in range(3)],
                      stamps=[datetime.datetime(2024, 1, 1, 12, 0, i)
                              for i in range(2)]),
                    R(days=[], stamps=None),
                    R(days=None, stamps=[datetime.datetime(1999, 12, 31, 23)])]
            blob = write(S, cls=R, columns=[objs])
            assert read(S, blob, R) == read(S, blob, R, columns=True) == objs
            return blob
        both(run)

    def test_map_of_structs_stays_on_the_row_path(self):
        def run(S):
            objs = [S.C.MapHolder(m={"a": S.C.Child(5)})]
            w = S.floor.new_file_writer(io.BytesIO(), cls=S.C.MapHolder,
                                        created_by=CREATED_BY)
            errs = [raised(lambda: w.write_columns(objs), ValueError)]
            w.write_many(objs)
            w.close()
            blob = w.file_writer._f.getvalue()
            assert read(S, blob, S.C.MapHolder) == objs
            r = S.floor.Reader(S.FileReader(io.BytesIO(blob)),
                               cls=S.C.MapHolder)
            errs.append(raised(lambda: r.read_columns(0), ValueError))
            return errs, blob
        assert "nested" in both(run)[0][0][1]

    def test_write_columns_empty_is_noop(self):
        def run(S):
            blob = write(S, cls=S.C.Flat,
                         columns=[[], _flat_objs(S.C, 5)])
            fr = S.FileReader(io.BytesIO(blob))
            return blob, fr.row_group_count(), fr.num_rows
        assert both(run)[1:] == (1, 5)


def test_floor_writes_a_path_and_closes_it(tmp_path):
    """``new_file_writer(path)`` owns the file it opened: the port's file
    is the JAX package's, and both readers open it by path."""
    def run(S):
        p = str(tmp_path / f"{S.name}.parquet")
        with S.floor.new_file_writer(p, cls=S.C.Flat,
                                     created_by=CREATED_BY) as w:
            w.write_columns(_flat_objs(S.C, 10))
        with S.floor.new_file_reader(p, S.C.Flat) as r:
            got = r.read_columns(0)
        return open(p, "rb").read(), repr(got), os.path.getsize(p)
    both(run)
