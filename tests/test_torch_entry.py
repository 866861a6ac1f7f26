"""The port's entry points take the reference's arguments: row-group
indices (``read_row_groups_device(reader, rg_indices=None, *,
device=None)``, ``read_row_group_device(reader, rg_index, *,
device=None)``) and column selection (``FileReader(source,
*columns)``), with the device keyword-only."""

import io

import numpy as np
import pytest

from tpuparquet.io.reader import FileReader as JaxFileReader
from tpuparquet.kernels.device import read_row_groups_device as \
    jax_read_row_groups_device
from tpuparquet_torch.format.dsl import SchemaValidationError
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.kernels.device import read_row_group_device, \
    read_row_groups_device
from tpuparquet_torch.stats import collect_stats

SCHEMA = """message m {
    required int64 a;
    optional int32 b;
    optional group l (LIST) { repeated group list { optional int64 element; } }
}"""


def _file(n_groups: int = 3, rows: int = 500) -> tuple:
    rng = np.random.default_rng(31)
    buf = io.BytesIO()
    groups = []
    with FileWriter(buf, SCHEMA) as w:
        for _ in range(n_groups):
            mask = rng.random(rows) >= 0.2
            offs = np.concatenate([[0], np.cumsum(rng.integers(0, 3, rows))])
            cols = {"a": rng.integers(-2**40, 2**40, rows),
                    "b": rng.integers(0, 99, int(mask.sum()), dtype=np.int32),
                    "l": rng.integers(0, 7, int(offs[-1]))}
            w.write_columns(cols, masks={"b": mask}, offsets={"l": offs})
            groups.append(cols)
    return buf.getvalue(), groups


def test_rg_indices_read_only_those_groups():
    """A reference-style call ``read_row_groups_device(reader, [1])``
    reads row group 1 only, as the reference does."""
    blob, groups = _file()
    with collect_stats() as st:
        got = list(read_row_groups_device(FileReader(blob), [1],
                                          device="cpu"))
    theirs = list(jax_read_row_groups_device(JaxFileReader(io.BytesIO(blob)),
                                             [1]))
    assert [rg for rg, _ in got] == [rg for rg, _ in theirs] == [1]
    np.testing.assert_array_equal(got[0][1]["a"].to_numpy()[0],
                                  groups[1]["a"])
    one = st.bytes_staged
    with collect_stats() as st:
        list(read_row_groups_device(FileReader(blob), device="cpu"))
    assert st.bytes_staged > 2 * one
    order = [rg for rg, _ in read_row_groups_device(
        FileReader(blob), (2, 0), device="cpu")]
    assert order == [2, 0]


def test_device_is_keyword_only():
    reader = FileReader(_file(1, 10)[0])
    with pytest.raises(TypeError):
        read_row_group_device(reader, 0, "cpu")
    with pytest.raises(TypeError):
        read_row_groups_device(reader, None, "cpu")


@pytest.mark.parametrize("columns,want", [
    (("a",), ["a"]),
    (("b", "a"), ["a", "b"]),
    (("l",), ["l.list.element"]),
    (("l.list.element",), ["l.list.element"]),
    ((), ["a", "b", "l.list.element"]),
])
def test_file_reader_selects_columns(columns, want):
    """``FileReader(src, *columns)`` stages only the selected chunks (a
    group selects its subtree), as the reference's ``selected_chunks``;
    the values equal the full read's."""
    blob, groups = _file(2)
    reader = FileReader(blob, *columns)
    jax_reader = JaxFileReader(io.BytesIO(blob), *columns)
    rg = reader.meta.row_groups[0]
    assert [p for p, _, _ in reader.selected_chunks(rg)] == want == [
        p for p, _, _ in jax_reader.selected_chunks(
            jax_reader.meta.row_groups[0])]
    with collect_stats() as st:
        got = read_row_group_device(reader, 1, device="cpu")
    assert list(got) == want
    full = read_row_group_device(FileReader(blob), 1, device="cpu")
    for name in want:
        np.testing.assert_array_equal(got[name].to_numpy()[0],
                                      full[name].to_numpy()[0])
    if columns == ("a",):
        # only a's words crossed: 500 int64 values staged as 1000 words
        assert st.bytes_staged <= 2 * 500 * 8


def test_file_reader_rejects_unknown_column():
    with pytest.raises(SchemaValidationError, match="not in the schema"):
        FileReader(_file(1, 10)[0], "nope")
