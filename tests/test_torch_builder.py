"""The port's schema builder (``format/builder.py``) and top level against
the JAX package's.

Each ``logical_*`` and ``new_*`` helper builds the same tree in both
packages (its DSL text and every ``SchemaElement`` field), the trees pass
or fail ``validate``/``validate_strict`` with the same words, a
``FileWriter`` over ``new_root(...)`` writes the same file, and the
port's top level exports every public name the reference's does.
"""

from __future__ import annotations

import io
from enum import Enum
from types import ModuleType, SimpleNamespace

import numpy as np
import pytest

import tpuparquet
import tpuparquet.format.builder as jax_builder
import tpuparquet.format.dsl as jax_dsl
import tpuparquet.format.metadata as jax_meta
import tpuparquet_torch
import tpuparquet_torch.format.builder as port_builder
import tpuparquet_torch.format.dsl as port_dsl
import tpuparquet_torch.format.metadata as port_meta

JAX = SimpleNamespace(b=jax_builder, dsl=jax_dsl, m=jax_meta,
                      FileWriter=tpuparquet.FileWriter)
PORT = SimpleNamespace(b=port_builder, dsl=port_dsl, m=port_meta,
                       FileWriter=tpuparquet_torch.FileWriter)
SIDES = (JAX, PORT)


def plain(x):
    """A thrift struct or a column tree as plain values (enums by name),
    so the two packages' objects compare."""
    if isinstance(x, Enum):
        return x.name
    if hasattr(x, "_NAMES"):
        return (type(x).__name__,
                {n: plain(getattr(x, n)) for n in x._NAMES
                 if getattr(x, n) is not None})
    if hasattr(x, "element") and hasattr(x, "children"):
        return plain(x.element), [plain(c) for c in x.children]
    if hasattr(x, "root"):
        return plain(x.root)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def both(fn):
    got = [fn(S) for S in SIDES]
    assert got[1] == got[0]
    return got[1]


def raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared by class and words
        return type(e).__name__, str(e)
    return None


LOGICAL = [
    ("logical_string", ()), ("logical_date", ()), ("logical_uuid", ()),
    ("logical_enum", ()), ("logical_json", ()), ("logical_bson", ()),
    ("logical_int", (8,)), ("logical_int", (16, False)),
    ("logical_int", (32, True)), ("logical_int", (64, False)),
    ("logical_decimal", (9, 2)), ("logical_decimal", (38, 18)),
    ("logical_time", ()), ("logical_time", ("MICROS", False)),
    ("logical_time", ("NANOS",)), ("logical_timestamp", ()),
    ("logical_timestamp", ("micros", True)),
    ("logical_timestamp", ("NANOS", False)),
]


@pytest.mark.parametrize("name,args", LOGICAL,
                         ids=[f"{n}{a}" for n, a in LOGICAL])
def test_logical_helpers(name, args):
    assert both(lambda S: plain(getattr(S.b, name)(*args)))


@pytest.mark.parametrize("call", [
    lambda b: b.logical_int(7), lambda b: b.logical_time("HOURS"),
    lambda b: b.logical_timestamp("seconds", True)],
    ids=["int width", "time unit", "timestamp unit"])
def test_logical_helper_errors(call):
    assert both(lambda S: raised(lambda: call(S.b)))


def _leaves(S):
    """Every leaf shape: a column of each physical type, each logical
    type on its type, a converted type alone, a field id."""
    b, T, R = S.b, S.m.Type, S.m.FieldRepetitionType
    return [
        b.new_data_column("a", T.INT64),
        b.new_data_column("b", T.BOOLEAN, R.OPTIONAL),
        b.new_data_column("s", T.BYTE_ARRAY, logical_type=b.logical_string()),
        b.new_data_column("d", T.INT32, R.OPTIONAL,
                          logical_type=b.logical_date()),
        b.new_data_column("u", T.FIXED_LEN_BYTE_ARRAY, type_length=16,
                          logical_type=b.logical_uuid()),
        b.new_data_column("e", T.BYTE_ARRAY, logical_type=b.logical_enum()),
        b.new_data_column("j", T.BYTE_ARRAY, logical_type=b.logical_json()),
        b.new_data_column("bs", T.BYTE_ARRAY, logical_type=b.logical_bson()),
        b.new_data_column("i8", T.INT32, logical_type=b.logical_int(8)),
        b.new_data_column("u64", T.INT64,
                          logical_type=b.logical_int(64, False)),
        b.new_data_column("dec", T.FIXED_LEN_BYTE_ARRAY, type_length=16,
                          logical_type=b.logical_decimal(38, 9)),
        b.new_data_column("tm", T.INT32, logical_type=b.logical_time()),
        b.new_data_column("tn", T.INT64,
                          logical_type=b.logical_time("NANOS")),
        b.new_data_column("ts", T.INT64,
                          logical_type=b.logical_timestamp("MICROS")),
        b.new_data_column("x", T.INT96),
        b.new_data_column("f", T.FLOAT, field_id=7),
        b.new_data_column("g", T.DOUBLE, R.REPEATED),
        b.new_data_column("c", T.INT32,
                          converted_type=S.m.ConvertedType.UINT_16),
    ]


def _tree(S):
    b, T, R = S.b, S.m.Type, S.m.FieldRepetitionType
    return b.new_root("msg", _leaves(S) + [
        b.new_group("grp", R.OPTIONAL, [
            b.new_data_column("x", T.INT32),
            b.new_group("inner", R.REQUIRED,
                        [b.new_data_column("y", T.DOUBLE, R.OPTIONAL)])],
            field_id=3),
        b.new_list_column("l", b.new_data_column("v", T.INT64, R.OPTIONAL)),
        b.new_list_column("ll", b.new_list_column(
            "inner", b.new_data_column("v", T.INT32)), R.REQUIRED),
        b.new_map_column("m", b.new_data_column(
            "k", T.BYTE_ARRAY, logical_type=b.logical_string()),
            b.new_data_column("v", T.INT32, R.OPTIONAL)),
        b.new_map_column("mm", b.new_data_column("k", T.INT32),
                         b.new_group("v", R.OPTIONAL, [
                             b.new_data_column("z", T.BOOLEAN)])),
    ])


def test_new_root_tree_and_text():
    """The whole tree, its DSL text and every element; strict
    validation passes."""
    def run(S):
        sd = _tree(S)
        sd.validate()
        sd.validate_strict()
        return str(sd), plain(sd)
    text, tree = both(run)
    assert "(LIST)" in text and "(MAP)" in text


@pytest.mark.parametrize("i", range(18))
def test_each_leaf_helper(i):
    def run(S):
        leaf = _leaves(S)[i]
        sd = S.b.new_root("m", [leaf])
        sd.validate_strict()
        return str(sd), plain(leaf)
    both(run)


def test_file_from_new_root_equal():
    """A FileWriter over a built schema writes the same file."""
    def run(S):
        b, T, R = S.b, S.m.Type, S.m.FieldRepetitionType
        sd = b.new_root("m", [
            b.new_data_column("id", T.INT64),
            b.new_data_column("s", T.BYTE_ARRAY, R.OPTIONAL,
                              logical_type=b.logical_string()),
            b.new_data_column("d", T.INT32,
                              logical_type=b.logical_date())])
        buf = io.BytesIO()
        w = S.FileWriter(buf, sd, created_by="tpuparquet")
        w.write_columns({"id": np.arange(5, dtype=np.int64),
                         "s": [b"a", b"c"], "d": np.arange(5, dtype=np.int32)},
                        masks={"s": np.array([1, 0, 1, 0, 0], dtype=bool)})
        w.close()
        return buf.getvalue()
    both(run)


def _bad_trees(S):
    """Trees each helper or validator refuses, built the same way in both
    packages: ``(label, call)``; ``call`` builds (and validates)."""
    b, T, R, CT = S.b, S.m.Type, S.m.FieldRepetitionType, S.m.ConvertedType

    def strict(*cols):
        return lambda: b.new_root("m", list(cols)).validate_strict()

    def loose(*cols):
        return lambda: b.new_root("m", list(cols)).validate()

    def list_group(child_name):
        g = b.new_group("l", R.OPTIONAL, [b.new_group(
            child_name, R.REPEATED, [b.new_data_column("element", T.INT32)])])
        g.element.converted_type = CT.LIST
        return g

    def two_children():
        g = b.new_group("l", R.OPTIONAL, [
            b.new_data_column("a", T.INT32, R.REPEATED),
            b.new_data_column("b", T.INT32, R.REPEATED)])
        g.element.converted_type = CT.LIST
        return g

    def map_group(key_rep=R.REQUIRED, extra=False):
        kids = [b.new_data_column("key", T.INT32, key_rep),
                b.new_data_column("value", T.INT32, R.OPTIONAL)]
        if extra:
            kids.append(b.new_data_column("other", T.INT32))
        g = b.new_group("m", R.OPTIONAL, [b.new_group("key_value",
                                                      R.REPEATED, kids)])
        g.element.converted_type = CT.MAP
        return g

    return [
        ("flba without length",
         lambda: b.new_data_column("f", T.FIXED_LEN_BYTE_ARRAY)),
        ("repeated list", lambda: b.new_list_column(
            "l", b.new_data_column("v", T.INT32), R.REPEATED)),
        ("repeated element", lambda: b.new_list_column(
            "l", b.new_data_column("v", T.INT32, R.REPEATED))),
        ("optional key", lambda: b.new_map_column(
            "m", b.new_data_column("k", T.INT32, R.OPTIONAL),
            b.new_data_column("v", T.INT32))),
        ("repeated map", lambda: b.new_map_column(
            "m", b.new_data_column("k", T.INT32),
            b.new_data_column("v", T.INT32), R.REPEATED)),
        ("repeated value", lambda: b.new_map_column(
            "m", b.new_data_column("k", T.INT32),
            b.new_data_column("v", T.INT32, R.REPEATED))),
        ("list child name", strict(list_group("bag"))),
        ("list of two children", loose(two_children())),
        ("map key optional", strict(map_group(R.OPTIONAL))),
        ("map extra child", strict(map_group(extra=True))),
        ("map extra child, loose", loose(map_group(extra=True))),
        ("date on int64", loose(b.new_data_column(
            "d", T.INT64, logical_type=b.logical_date()))),
        ("uuid on 8 bytes", loose(b.new_data_column(
            "u", T.FIXED_LEN_BYTE_ARRAY, type_length=8,
            logical_type=b.logical_uuid()))),
        ("decimal precision", loose(b.new_data_column(
            "p", T.INT32, logical_type=b.logical_decimal(12, 2)))),
        ("decimal on double", loose(b.new_data_column(
            "p", T.DOUBLE, logical_type=b.logical_decimal(5, 2)))),
        ("time millis on int64", loose(b.new_data_column(
            "t", T.INT64, logical_type=b.logical_time("MILLIS")))),
        ("timestamp on int32", loose(b.new_data_column(
            "t", T.INT32, logical_type=b.logical_timestamp()))),
        ("int width on int32", loose(b.new_data_column(
            "i", T.INT32, logical_type=b.logical_int(64)))),
        ("enum on int32", loose(b.new_data_column(
            "e", T.INT32, logical_type=b.logical_enum()))),
        ("empty group", loose(b.new_group("g", R.OPTIONAL))),
    ]


@pytest.mark.parametrize("i", range(20))
def test_refusals_same_words(i):
    def run(S):
        label, call = _bad_trees(S)[i]
        return label, raised(call)
    label, err = both(run)
    assert err is not None and err[0] == "SchemaValidationError", label


def test_top_level_exports_the_reference_names():
    """Every public name of the reference's top level is the port's too
    (``_lockcheck``, armed by ``TPQ_LOCKCHECK``, is not ported yet).
    Submodules are left out: they appear on a package as other code
    imports them."""
    ref = {n for n, v in vars(tpuparquet).items()
           if not n.startswith("_") and not isinstance(v, ModuleType)}
    missing = sorted(ref - set(vars(tpuparquet_torch)))
    assert missing == []
    for name in ("DatasetWriter", "compact_dataset", "new_root",
                 "new_map_column", "logical_timestamp"):
        assert getattr(tpuparquet_torch, name).__module__.startswith(
            "tpuparquet_torch.")
