"""tpuparquet_torch's CUDA kernels on the card (skipped without one).

Imports neither JAX nor tpuparquet, so it runs on a machine with a GPU
and no JAX, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from tpuparquet_torch.io.reader import FileReader  # noqa: E402
from tpuparquet_torch.kernels import (  # noqa: E402
    bitunpack,
    decode,
    encode,
    hybrid,
    snappy,
)
from tpuparquet_torch.kernels.device import (  # noqa: E402
    read_row_group_device,
    read_row_groups_device,
)
from tpuparquet_torch.stats import collect_stats  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)


def test_kernels_match_plain_versions(cuda):
    """K1-K13 against their plain versions, bit for bit (the checks of
    chip_smoke.py's phase 2)."""
    chip_smoke.check_kernels(cuda)


@pytest.mark.parametrize("check", ["_check_planes", "_check_unpack_u64",
                                   "_check_delta_scan", "_check_tokens"])
def test_transport_kernel_matches_plain_version(cuda, check):
    """K5 (planes_to_words), K6 (unpack_u64), K7 (delta_scan) and K8
    (expand_tokens, as bytes and as words from any offset) one by one."""
    getattr(chip_smoke, check)(np.random.default_rng(1), cuda)
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", list(chip_smoke.UNPACK_EDGE_CASES))
def test_unpack_tile_edges_match_plain_version(cuda, case):
    """K1 where its design has edges (chip_smoke.UNPACK_EDGE_CASES): widths
    0-32, counts around a thread's 4 lanes, a 32-lane block and a tile,
    2^21 + 3 lanes at every width, words from views 1-3 words into their
    buffer and ending exactly at ceil(count / 32) * width; the whole
    output, allocated over garbage."""
    chip_smoke._check_unpack_edges(np.random.default_rng(16), cuda, [case])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", list(chip_smoke.HYBRID_EDGE_CASES))
def test_hybrid_tile_edges_match_plain_version(cuda, case):
    """K2 where its design has edges (chip_smoke.HYBRID_EDGE_CASES):
    rate_code's shape, one RLE run, one bit-packed run as a table, a
    run-dense stream whose tiles meet more runs than a block stages, run
    ends on tile edges, runs of length 0, no padding runs, clamps past
    nbp, widths 0-32, counts 1 to 2^21 + 3, views off 16-byte boundaries;
    the whole output, allocated over garbage."""
    chip_smoke._check_hybrid_edges(np.random.default_rng(17), cuda, [case])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", list(chip_smoke.LEVELS_EDGE_CASES))
def test_levels_tile_edges_match_plain_version(cuda, case):
    """K4 where its design has edges (chip_smoke.LEVELS_EDGE_CASES): sizes
    around a lane's 4 slots and a tile, look-back over 9 tiles, 2^21 + 3
    slots, all null, no nulls, max_def 1 and 3, def levels from views 1-3
    words into their buffer; the whole output, allocated over garbage."""
    chip_smoke._check_levels_edges(np.random.default_rng(12), cuda, [case])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", list(chip_smoke.PLANES_EDGE_CASES))
def test_planes_tile_edges_match_plain_version(cuda, case):
    """K5 where its design has edges (chip_smoke.PLANES_EDGE_CASES): counts
    around a tile and a group of 4 values, raw slabs 1-3 at every offset
    mod 4, runs of length 1 (more than a block stages), one run over the
    page, run ends on tile edges, table slices past 0, lanes 1-4, buffers
    from views off 16-byte boundaries; the whole output, allocated over
    garbage."""
    chip_smoke._check_planes_edges(np.random.default_rng(13), cuda, [case])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("check", ["_check_dict_bytes",
                                   "_check_bytes_from_blob"])
def test_bytes_kernel_matches_plain_version(cuda, check):
    """K9 (page_dict_bytes: single-run and run-table index streams, width
    0, an empty dictionary blob, an exact bucket, an all-null page, a
    dictionary over several 16 MB pieces) and K10 (plain_bytes_from_blob
    on every case of chip_smoke.BLOB_CASES), over the whole padded
    output."""
    getattr(chip_smoke, check)(np.random.default_rng(2), cuda)
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("name", ["run over the tiles", "copies across tiles",
                                  "copies past 64 KiB",
                                  "literals over a tile", "length 3 mod 4"])
def test_snappy_tile_edges_match_plain_version(cuda, name):
    """K8 where its design has edges: a chain through 19 16-KiB tiles,
    copies across tile edges, 4-byte offsets from more than 64 KiB back,
    literals longer than a tile, words at offsets 0, 1 and 3 of a block
    of 3 mod 4 bytes; the whole padded output."""
    chip_smoke._check_tokens(np.random.default_rng(4), cuda, [name])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", ["value over a tile", "5000 empty values",
                                  "tail reads the last entry",
                                  "indices past the dictionary"])
def test_dict_bytes_block_edges_match_plain_version(cuda, case):
    """K9 where its design has edges: a value longer than a block's
    share, empty values across block edges, a tail read from the last
    slot's entry past non_null, indices past the dictionary."""
    chip_smoke._check_dict_bytes(np.random.default_rng(5), cuda, [case])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", ["pos 1", "pos 2", "pos 3",
                                  "value over two tiles",
                                  "empty run in a tile",
                                  "empty run at a tile edge",
                                  "nb one short of a tile",
                                  "nb one past a tile", "unpadded tail",
                                  "short unpadded tail"])
def test_blob_tile_edges_match_plain_version(cuda, case):
    """K10 where its design has edges: source offsets 1-3 mod 4, a value
    over two tiles, empty runs inside a tile (more ends than it stages)
    and on its edge, the values' bytes one short of and one past a tile,
    the unpadded tail and a blob it reaches past; the whole padded
    output."""
    chip_smoke._check_bytes_from_blob(np.random.default_rng(8), cuda, [case])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", sorted(chip_smoke.DICT_CASES))
def test_dict_build_range_edges_match_plain_version(cuda, case):
    """KE4 where its design has edges: one hot value, ranges on either
    side of its shared-memory threshold, first occurrences at the last
    index of a warp and of a block, ranges 2^16 and 2^22; int32 and
    int64, order, size and indices."""
    chip_smoke._check_dict_build(np.random.default_rng(9), cuda, [case])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", ["tile edges", "many tiles", "small blocks",
                                  "misaligned dlo"])
def test_delta_scan_tile_edges_match_plain_version(cuda, case):
    """K7 where its design has edges: totals one short of, at and one
    past a 4,096-value tile and its double, 38 tiles of look-back, block
    sizes 1, 3 and 127 (a lane's rows cross several blocks), deltas read
    from views that are not 8-byte aligned; int32 and int64, the whole
    output."""
    chip_smoke._check_delta_scan(np.random.default_rng(6), cuda, [case])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", ["warp edges", "CTA edges",
                                  "odd word offset"])
def test_delta_phase1_warp_edges_match_plain_version(cuda, case):
    """KE3 where its design has edges: deltas at a warp's 4 blocks and a
    CTA's 32, plus or minus one, and values that start one word into
    their buffer; every output, and each page against the host
    encoder."""
    chip_smoke._check_delta_phase1(np.random.default_rng(7), cuda, [case])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("check", ["_check_delta_scatter", "_check_bss"])
def test_delta_and_bss_kernels_match_plain_versions(cuda, check):
    """K11 (scatter_deltas: int32 and int64 lanes, miniblocks of 32 and
    64, a partial last miniblock, targets past ``out_len``; whole bursty
    delta streams at block 256) and K12 (bss_to_lanes: 4, 6 and 8
    streams, counts not a multiple of 32)."""
    getattr(chip_smoke, check)(np.random.default_rng(3), cuda)
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", list(chip_smoke.BSS_EDGE_CASES))
def test_bss_tile_edges_match_plain_version(cuda, case):
    """K12 where its design has edges (chip_smoke.BSS_EDGE_CASES): every k
    from 1 to 16, counts around a tile and at every residue mod 16, views
    1-13 bytes into their buffer, streams of exactly k * count bytes, rows
    that fill a block's shared memory and rows whose lanes split over
    gridDim.y; the whole output, allocated over garbage."""
    chip_smoke._check_bss_edges(np.random.default_rng(20), cuda, [case])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("check", ["_check_flba", "_check_new_shapes"])
def test_slice5_shapes_match_plain_versions(cuda, check):
    """K13 (flba_bytes_to_lanes at row lengths 1, 3, 4, 5, 7, 8, 9, 12,
    13, 16, 17, 20, 22, 24 and 1,031, at counts one short of, at and one
    past a row tile and five tiles and a remainder, from views 1, 3 and 8
    bytes into their buffer), K3 at 3 and 4 lanes over a padded
    dictionary, K12 with k = 9 and 16 over 3 and 4 lanes, K8 on
    front-coded strings and rows."""
    getattr(chip_smoke, check)(np.random.default_rng(4), cuda)
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("check", ["_check_pack_bits", "_check_encode"])
def test_encode_kernels_match_plain_versions(cuda, check):
    """KE1 (pack_bits at widths 1, 7, 31, 32, 33, 63 and 64, counts 1, 33
    and 2^20 + 5, over a miniblock list) and KE2-KE5 (bss_encode_device
    at (k, lanes) (4, 1), (4, 2), (8, 2), (3, 1), (9, 3), (16, 4) and
    (1601, 401), counts 1-6, one short of and one past a tile and past
    2^20 with streams that start off a 16-byte boundary, from a view one
    word into its buffer; delta_phase1 on wrapping int32 and extreme int64 deltas,
    dict_build on every case of chip_smoke.DICT_CASES,
    lanes_min_max on NaN, infinities, signed zeros and unsigned order)."""
    getattr(chip_smoke, check)(np.random.default_rng(5), cuda)
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", list(chip_smoke.PACK_EDGE_CASES))
def test_pack_warp_edges_match_plain_version(cuda, case):
    """KE1 where its design has edges (chip_smoke.PACK_EDGE_CASES): widths
    1, 31, 32, 33 and 64 at counts around a miniblock and one value past
    a warp's and a block's share of miniblocks, miniblock lists reversed,
    with repeats and over a source whose last lanes are missing, inputs
    shorter than the count; the whole output, allocated over garbage."""
    chip_smoke._check_pack_edges(np.random.default_rng(18), cuda, [case])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", list(chip_smoke.MINMAX_EDGE_CASES))
def test_min_max_edges_match_plain_version(cuda, case):
    """KE5 where its design has edges (chip_smoke.MINMAX_EDGE_CASES): one
    value, a vector's values and one past, a block's round and one past,
    views 1 and 2 words in, the extremes in the last block's last vector,
    NaN in the tail only, all NaN, and calls back to back whose grids
    differ (the ticket's reset); the keys' buffer and the partials hold
    garbage before every call."""
    chip_smoke._check_minmax_edges(np.random.default_rng(19), cuda, [case])
    torch.cuda.synchronize(cuda)


def _encode_launches():
    return {k: getattr(encode, k).launches for k in (
        "pack_bits", "bss_encode_device", "delta_phase1", "dict_build",
        "lanes_min_max")}


@pytest.mark.parametrize("table", ["sensors", "config2"])
def test_write_from_card_is_byte_identical(cuda, monkeypatch, table):
    """The write path on the card at 2,000,000 values: every row group
    read on the card and written back from ``as_values()`` is the
    original file byte for byte, with the pages and launches the
    reference's routing gives (sensor table: KE1-KE3 and KE5; config 2:
    KE5 on five columns, KE4 on four)."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    if table == "sensors":
        blob, _ = chip_smoke.build_sensors(250_000, 2)
        schema, enc = chip_smoke.SENSORS_SCHEMA, chip_smoke._encodings(
            chip_smoke.SENSORS_ENCODINGS)
        pages, want = 8, {"bss_encode_device": 4, "delta_phase1": 4,
                          "lanes_min_max": 8, "dict_build": 0}
    else:
        blob, _ = chip_smoke.build_config2(2_000_000, 2)
        schema, enc = chip_smoke.SCHEMA, None
        pages, want = 4, {"dict_build": 8, "lanes_min_max": 14,
                          "pack_bits": 0, "delta_phase1": 0}
    dv = chip_smoke._device_groups(FileReader(io.BytesIO(blob)), cuda)
    assert all(v.flat.device.type == "cuda" for c, _ in dv
               for v in c.values())
    wrappers = {k: getattr(encode, k) for k in _encode_launches()}
    launches = chip_smoke.check_write(table, blob, schema, enc, dv, wrappers,
                                      pages)
    assert {k: launches[k] for k in want} == want
    if table == "sensors":
        assert launches["pack_bits"] > 0


def _same_buffers(reader, out, groups):
    for rg, cols_out in out:
        cpu = read_row_group_device(reader, rg, device="cpu")
        cols = groups[rg][0]
        for name, col in cols_out.items():
            assert col.device.type == "cuda"
            a, b = col.padded_buffers(), cpu[name].padded_buffers()
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=name)
            assert chip_smoke._same_values(col.to_numpy()[0], cols[name])


def _launches(names):
    fns = {"K1": bitunpack.unpack_u32, "K4": decode.levels_to_validity,
           "K5": decode.planes_to_words, "K6": bitunpack.unpack_u64,
           "K7": decode.delta_scan, "K8": snappy.expand_tokens,
           "K9": decode.page_dict_bytes,
           "K10": decode.plain_bytes_from_blob,
           "K11": decode.scatter_deltas, "K12": decode.bss_to_lanes,
           "K3": decode.page_dict_fixed,
           "K13": decode.flba_bytes_to_lanes}
    return {k: fns[k].launches for k in names}


def test_config4_on_card_matches_cpu_buffer_for_buffer(cuda, monkeypatch):
    """Config 4 at 250,000 rows a group: dictionary strings through K9,
    doubles PLAIN, data page v2."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    blob, groups = chip_smoke.build_config4(2_000_000, 2)
    reader = FileReader(io.BytesIO(blob))
    before = _launches(["K9"])
    out = list(read_row_groups_device(reader))
    _same_buffers(reader, out, groups)
    assert _launches(["K9"])["K9"] == before["K9"] + 4


def test_string_mix_on_card(cuda, monkeypatch):
    """The URL pages through K8 then K10, the hex tokens raw."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    blob, groups = chip_smoke.build_strings(2_000_000, 2)
    reader = FileReader(io.BytesIO(blob))
    before = _launches(["K8", "K10"])
    with collect_stats() as st:
        out = list(read_row_groups_device(reader))
    after = _launches(["K8", "K10"])
    _same_buffers(reader, out, groups)
    assert st.pages_device_snappy == 4
    assert all(after[k] == before[k] + 4 for k in after)


def test_sensor_table_on_card(cuda, monkeypatch):
    """The sensor table at 100,000 rows a group: bursty timestamps and the
    optional sequence through K1/K6, K11 and K7, the readings through K12
    (one launch per BYTE_STREAM_SPLIT page)."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    blob, groups = chip_smoke.build_sensors(100_000, 2)
    reader = FileReader(io.BytesIO(blob))
    before = _launches(["K7", "K11", "K12"])
    with collect_stats() as st:
        out = list(read_row_groups_device(reader))
    after = _launches(["K7", "K11", "K12"])
    _same_buffers(reader, out, groups)
    assert (st.pages_device_snappy, st.pages_device_delta_lanes,
            st.pages_device_planes) == (0, 0, 0)
    assert after["K12"] == before["K12"] + 4
    assert after["K11"] > before["K11"] and after["K7"] > before["K7"]


def test_config3_on_card(cuda, monkeypatch):
    """Config 3 at 100,000 rows a group: rep and def levels, deltas and
    validity on the card, buffer for buffer with the CPU run and level
    for level with the generator."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    blob, groups = chip_smoke.build_config3(600_000, 2)
    reader = FileReader(io.BytesIO(blob))
    before = _launches(["K1", "K4", "K7"])
    out = list(read_row_groups_device(reader))
    after = _launches(["K1", "K4", "K7"])
    for rg, cols_out in out:
        cpu = read_row_group_device(reader, rg, device="cpu")
        for name, col in cols_out.items():
            a, b = col.padded_buffers(), cpu[name].padded_buffers()
            assert a.keys() == b.keys() and "rep_levels" in a
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    chip_smoke._check_list_read("config 3", reader, out, groups)
    assert all(after[k] > before[k] for k in after)


def test_transports_on_card_match_cpu_buffer_for_buffer(cuda, monkeypatch):
    """Config 2 with the default transports at 200,000 rows a group
    (enough distinct values that ``trip_distance_mm`` is PLAIN): planes
    (K5) and delta lanes (K1 then K7) on the card, buffer for buffer
    with the CPU run."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    blob, groups = chip_smoke.build_config2(2_000_000, 2)
    reader = FileReader(io.BytesIO(blob))
    before = _launches(["K5", "K7"])
    with collect_stats() as st:
        out = list(read_row_groups_device(reader))
    after = _launches(["K5", "K7"])
    _same_buffers(reader, out, groups)
    assert (st.pages_device_planes, st.pages_device_delta_lanes) == (2, 2)
    assert all(after[k] > before[k] for k in after)


def test_transport_mix_on_card(cuda, monkeypatch):
    """Every route on the card: tokens (K8), delta lanes at width 39
    (K6, K7), planes (K5)."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    blob, groups = chip_smoke.build_mix(2_000_000, 2)
    reader = FileReader(io.BytesIO(blob))
    before = _launches(["K5", "K6", "K7", "K8"])
    with collect_stats() as st:
        out = list(read_row_groups_device(reader))
    after = _launches(["K5", "K6", "K7", "K8"])
    _same_buffers(reader, out, groups)
    assert (st.pages_device_snappy, st.pages_device_delta_lanes,
            st.pages_device_planes) == (4, 4, 2)
    assert all(after[k] > before[k] for k in after)


def test_read_on_card_matches_cpu_buffer_for_buffer(cuda, monkeypatch):
    """The no-transport configuration (``TPQ_DEVICE_*=0``): PLAIN pages
    ship their words, so the launches are K1-K4's alone."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.setenv(k, "0")
    blob, groups = chip_smoke.build_config2(400_000, 2)
    reader = FileReader(io.BytesIO(blob))
    wrappers = (bitunpack.unpack_u32, hybrid.expand_hybrid,
                decode.page_dict_fixed, decode.levels_to_validity)
    before = [fn.launches for fn in wrappers]
    for rg, out in read_row_groups_device(reader):
        cpu = read_row_group_device(reader, rg, device="cpu")
        cols, pay_mask = groups[rg]
        for name, col in out.items():
            assert col.device.type == "cuda"
            a, b = col.padded_buffers(), cpu[name].padded_buffers()
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=name)
            np.testing.assert_array_equal(col.to_numpy()[0], cols[name])
    k1, k2, k3, k4 = [fn.launches - b for fn, b in zip(wrappers, before)]
    # per row group: the optional column's def levels (one bit-packed
    # run: K1), one launch per dictionary-encoded chunk (K3, after K2
    # where its index stream is a run table) and one validity pass (K4)
    dict_chunks = sum(cc.meta_data.dictionary_page_offset is not None
                      for rg in reader.meta.row_groups for cc in rg.columns)
    assert (k1, k3, k4) == (2, dict_chunks, 2)
    assert 0 <= k2 <= dict_chunks


def test_parquet_mr_v2_table_on_card(cuda, monkeypatch):
    """The parquet-mr v2 table at 100,000 rows a group: RLE booleans,
    front-coded URLs through K8 and DECIMAL rows through K8 then K13, the
    session ids assembled on the host, on the card buffer for buffer
    with the CPU run."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    blob, groups = chip_smoke.build_mr_v2(1_250_000, 2)
    reader = FileReader(io.BytesIO(blob))
    before = _launches(["K8", "K13"])
    out = list(read_row_groups_device(reader))
    after = _launches(["K8", "K13"])
    _same_buffers(reader, out, groups)
    assert after["K8"] == before["K8"] + 4
    assert after["K13"] == before["K13"] + 2


def test_spark_table_on_card(cuda, monkeypatch):
    """The Spark-style table at 100,000 rows a group: INT96 planes (K5 at
    3 lanes) and dictionary (K3 at 3 lanes), optional BOOLEAN (K1) and
    fixed-length rows, on the card buffer for buffer with the CPU run."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    blob, groups = chip_smoke.build_spark(1_000_000, 2)
    reader = FileReader(io.BytesIO(blob))
    before = _launches(["K3", "K5"])
    with collect_stats() as st:
        out = list(read_row_groups_device(reader))
    after = _launches(["K3", "K5"])
    _same_buffers(reader, out, groups)
    assert st.pages_device_planes == 2
    assert all(after[k] > before[k] for k in after)


def test_shard_kernels_match_plain_versions(cuda):
    """KS1-KS4 against their plain versions (chip_smoke.py's phase 2)."""
    chip_smoke._check_shard_kernels(np.random.default_rng(2), cuda)
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", list(chip_smoke.STEP_EDGE_CASES))
def test_spmd_tile_edges_match_plain_version(cuda, case):
    """KS2 where its design has edges (chip_smoke.STEP_EDGE_CASES): counts
    a tile - 1, a tile and a tile + 1, padded positions clamped into a
    bit-packed last run, an RLE run over a tile edge, shares that start
    off 16-byte boundaries, a tile that meets more runs than a block
    stages; every slot of each sp that divides the count, the whole
    output."""
    chip_smoke._check_spmd_edges(np.random.default_rng(10), cuda, [case])
    torch.cuda.synchronize(cuda)


@pytest.mark.parametrize("case", list(chip_smoke.DENSIFY_CASES))
def test_densify_tile_edges_match_plain_version(cuda, case):
    """KS3 where its design has edges (chip_smoke.DENSIFY_CASES): slots
    around a tile and 9 tiles of look-back, nulls, no values, no slots,
    no mask, 15-17 data bytes, a data view 3 bytes in, padded rows, and
    rows of a block that start off 16-byte boundaries."""
    chip_smoke._check_densify_edges(np.random.default_rng(11), cuda, [case])
    torch.cuda.synchronize(cuda)


def _shard_wrappers():
    from tpuparquet_torch.kernels import gather

    return {"scatter_to_dense": decode.scatter_to_dense,
            "spmd_step_slot": gather.spmd_step_slot,
            "byte_densify": gather.byte_densify,
            "place_rows": gather.place_rows}


@pytest.mark.parametrize("shape", ["1x1", "2x2"])
def test_sharded_scan_on_card(cuda, shape):
    """A small ShardedScan of config 2 and config 4 on cuda:0 (phase 6's
    checks), equal to the same scan on a CPU mesh of the same shape, and
    sharded_dict_decode through KS2."""
    cpu = torch.device("cpu")
    mesh = dict(chip_smoke.shard_meshes(cuda))[shape]
    cpu_mesh = dict(chip_smoke.shard_meshes(cpu))[shape]
    wrappers = _shard_wrappers()
    blob, groups = chip_smoke.build_config2(800_000, 8)
    blob4, groups4 = chip_smoke.build_config4(800_000, 8)
    g2 = [(c, {"payment_type": m}) for c, m in groups]
    for fblob, fgroups, fixed, byte_cols in (
            (blob, g2, list(groups[0][0]), []),
            (blob4, groups4, ["fare", "tip"], ["vendor", "note"])):
        got = chip_smoke.check_sharded_scan(
            shape, mesh, fblob, fgroups, fixed, byte_cols, cuda, wrappers, 1)
        want = chip_smoke.check_sharded_scan(
            shape, cpu_mesh, fblob, fgroups, fixed, byte_cols, cpu,
            wrappers, 1)
        assert got["moved"] == want["moved"]
        for name, rep in got["out"].items():
            for a, b in zip(rep, want["out"][name]):
                np.testing.assert_array_equal(a, b)
        assert got["launches"]["scatter_to_dense"] > 0
        assert got["launches"]["place_rows"] > 0
        # three gathers a string column (replicated, to device 0, to
        # the host), each densifying every unit once
        assert got["launches"]["byte_densify"] == (
            3 * 2 * len(groups4) if byte_cols else 0)
        if fblob is blob:
            results = got["results"]
    streams = chip_smoke.dict_index_streams(FileReader(blob))
    launches = chip_smoke.check_dict_decode(shape, mesh, streams, results,
                                            wrappers)
    assert launches["spmd_step_slot"] == len(streams) * mesh.devices.size


@pytest.mark.parametrize("shape", ["1x1", "2x2"])
def test_gather_to_host_from_card_mesh(cuda, shape):
    """A mesh of cuda:0 slots gathered with ``gather_to="cpu"``: the
    direct assembly copies each unit's row to the host (no KS4 launch),
    equal to the replicated gather and to the gather placed on the
    card, and moves exactly the bytes of its arrays."""
    from tpuparquet_torch.shard import ShardedScan

    mesh = dict(chip_smoke.shard_meshes(cuda))[shape]
    blob4, _ = chip_smoke.build_config4(800_000, 3)
    wrappers = _shard_wrappers()
    with ShardedScan([blob4], mesh=mesh) as scan:
        results = scan.run()
        for fn, name, n_arrays in ((scan.gather_column, "fare", 1),
                                   (scan.gather_byte_column, "vendor", 2)):
            rep = fn(results, name)
            placed = fn(results, name, gather_to=0)
            for f in wrappers.values():
                f.launches = 0
            with collect_stats() as st:
                sink = fn(results, name, gather_to="cpu")
            assert wrappers["place_rows"].launches == 0
            assert all(a.device.type == "cpu" for a in sink[:n_arrays])
            assert st.gather_bytes_moved == sum(
                a.numel() * a.element_size() for a in sink[:n_arrays])
            assert st.gather_reshard_s > 0
            for a, b, c in zip(sink, rep, placed):
                a = a.numpy() if isinstance(a, torch.Tensor) else a
                c = c.cpu().numpy() if isinstance(c, torch.Tensor) else c
                np.testing.assert_array_equal(a.view(b.dtype), b)
                np.testing.assert_array_equal(a, c)


def test_pipelined_read_same_at_every_worker_count(cuda, monkeypatch):
    """The read of config 2 at 4 plan workers and at 1: the same buffers,
    counters and kernel launches (launches are counted on the calling
    thread, which alone dispatches)."""
    blob, _ = chip_smoke.build_config2(2_000_000, 4)
    reader = FileReader(blob)
    wrappers = {"unpack_u32": bitunpack.unpack_u32,
                "expand_hybrid": hybrid.expand_hybrid,
                "levels_to_validity": decode.levels_to_validity,
                "planes_to_words": decode.planes_to_words,
                "delta_scan": decode.delta_scan}
    monkeypatch.setenv("TPQ_PLAN_THREADS", "4")
    got, launches, st = chip_smoke._drive(reader, cuda, wrappers)
    assert launches["planes_to_words"] > 0 and launches["delta_scan"] > 0
    chip_smoke._same_at_one_worker("config 2", reader, cuda, wrappers, got,
                                   launches, st)


@pytest.mark.parametrize("codec", ["GZIP", "ZSTD", "LZ4_RAW"])
def test_codec_read_on_card_matches_cpu(cuda, monkeypatch, codec):
    """Config 2 at 2,000,000 values in each codec: the card's read equals
    the CPU run buffer for buffer and the generator, with the SNAPPY
    file's routing and launches (chip_smoke.py's phase 3i, small)."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    groups = chip_smoke.config2_groups(2_000_000, 2)
    wrappers = {k: getattr(m, k) for m, k in (
        (bitunpack, "unpack_u32"), (hybrid, "expand_hybrid"),
        (decode, "page_dict_fixed"), (decode, "levels_to_validity"),
        (decode, "planes_to_words"), (decode, "delta_scan"),
        (snappy, "expand_tokens"))}
    snappy_read = chip_smoke._drive(
        FileReader(chip_smoke._write(chip_smoke.SCHEMA, groups,
                                     "payment_type")), cuda, wrappers)[1:]
    blob = chip_smoke._write(chip_smoke.SCHEMA, groups, "payment_type",
                             codec=codec)
    launches = chip_smoke.check_codec_read(codec, blob, groups, cuda,
                                           wrappers, 0, snappy_read)
    assert launches["expand_tokens"] == 0
    out = list(read_row_groups_device(FileReader(blob)))
    _same_buffers(FileReader(blob), out, groups)


def test_device_values_pool_write_equals_serial(cuda, monkeypatch):
    """Config 2's columns read on the card and written back as
    ``DeviceValues`` at 4 encode workers (the pool: KE4 and KE5 launch
    from its threads) and at 1: equal files, equal launch counts."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    blob, _ = chip_smoke.build_config2(2_000_000, 2)
    dv = chip_smoke._device_groups(FileReader(io.BytesIO(blob)), cuda)
    wrappers = {k: getattr(encode, k) for k in _encode_launches()}
    files, counts = [], []
    for threads in (4, 1):
        for fn in wrappers.values():
            fn.launches = 0
        files.append(chip_smoke._write(chip_smoke.SCHEMA, dv, None,
                                       encode_threads=threads))
        counts.append({k: fn.launches for k, fn in wrappers.items()})
    assert files[0] == files[1] == blob
    assert counts[0] == counts[1]
    assert counts[0]["dict_build"] == 8 and counts[0]["lanes_min_max"] == 14


def test_multihost_scan_on_card(cuda):
    """Phase 7 at a small size: two processes scan config 2 on cuda:0
    over a gloo group, each launching config 2's kernels; their gathered
    checksums equal this process's reads, and a stopped pair resumes to
    cover every unit once."""
    from tpuparquet_torch.shard import ShardedScan, make_mesh

    blob, _ = chip_smoke.build_config2(2_000_000, 4)
    results = ShardedScan([blob], mesh=make_mesh()).run()
    launches = chip_smoke.check_multihost(blob, results, 1.0, 2_000_000,
                                          cuda)
    assert all(launches[k] > 0 for k in chip_smoke.MULTIHOST_KERNELS)


def test_resilient_ladder_on_card(cuda):
    """Phase 8b on the card at a small size: injected dispatch faults
    retried, then one unit decoded on the host (its levels by K1/K2 and
    K4, no K3), a corrupt page and a hung dispatch quarantined; every
    other unit equals the pipelined scan's."""
    from tpuparquet_torch.kernels.device import \
        read_row_group_device_resilient
    from tpuparquet_torch.faults import inject_faults
    from tpuparquet_torch.shard import ShardedScan

    one = chip_smoke.shard_meshes(cuda)[0][1]
    wrappers = chip_smoke.kernel_wrappers()
    blob, groups = chip_smoke.build_config2(800_000, 4)
    with ShardedScan([blob], mesh=one) as s:
        results = s.run()
    launches = chip_smoke.check_resilient("8b", one, blob, results, cuda,
                                          wrappers, unit=2, budget=1.0)
    assert launches["page_dict_fixed"] > 0
    for fn in wrappers.values():
        fn.launches = 0
    with inject_faults() as inj:
        inj.inject("kernels.device.unit_dispatch", "dispatch", times=3)
        with collect_stats() as st:
            out = read_row_group_device_resilient(FileReader(blob), 0,
                                                  retries=2, device=cuda)
    torch.cuda.synchronize(cuda)
    assert (st.dispatch_retries, st.units_degraded) == (2, 1)
    assert wrappers["page_dict_fixed"].launches == 0
    assert wrappers["levels_to_validity"].launches > 0
    for path, col in out.items():
        assert col.data.device == cuda
        for a, b in zip(col.to_numpy(), results[0][path].to_numpy()):
            assert chip_smoke._same_values(np.asarray(a), b), path


def test_failed_launch_is_not_degraded_on_card(cuda, monkeypatch):
    """A launch that really fails is raised, not hidden: K1 given a tile
    it was not compiled for returns cudaErrorInvalidValue from its CUDA
    entry point (no kernel runs, the context stays usable), and the
    resilient read and the quarantining scan raise KernelLaunchError
    with no retry, no host decode and no quarantine."""
    from tpuparquet_torch.errors import KernelLaunchError
    from tpuparquet_torch.kernels import bitunpack
    from tpuparquet_torch.kernels.device import \
        read_row_group_device_resilient
    from tpuparquet_torch.shard import ShardedScan

    one = chip_smoke.shard_meshes(cuda)[0][1]
    blob, _ = chip_smoke.build_config2(400_000, 2)
    healthy = read_row_group_device(FileReader(blob), 0, device=cuda)
    tile = bitunpack.unpack_tile_lanes()
    monkeypatch.setattr(bitunpack, "unpack_tile_lanes", lambda: tile + 1)
    with collect_stats() as st:
        with pytest.raises(KernelLaunchError, match="tpq_unpack_u32"):
            read_row_group_device_resilient(FileReader(blob), 0, retries=2,
                                            sleep=lambda s: None,
                                            device=cuda)
        with pytest.raises(KernelLaunchError, match="tpq_unpack_u32"):
            with ShardedScan([blob], mesh=one, on_error="quarantine",
                             retries=2) as s:
                s.run()
    assert (st.dispatch_retries, st.units_degraded, st.pages_degraded,
            st.units_quarantined) == (0, 0, 0, 0)
    monkeypatch.undo()
    again = read_row_group_device(FileReader(blob), 0, device=cuda)
    for path, col in healthy.items():
        for a, b in zip(col.to_numpy(), again[path].to_numpy()):
            assert chip_smoke._same_values(np.asarray(a), b), path


def test_consumer_mesh_gather_on_card(cuda):
    """Phase 8a on the card at a small size: gathers under a
    NamedSharding over two (and 2x2) cuda:0 slots, each shard on the card,
    equal to the replicated gather; read_row_groups_device onto the
    slots."""
    from tpuparquet_torch.shard.mesh import Mesh, NamedSharding, \
        PartitionSpec as P
    from tpuparquet_torch.shard import gather_column

    one = chip_smoke.shard_meshes(cuda)[0][1]
    wrappers = chip_smoke.kernel_wrappers()
    blob, groups = chip_smoke.build_config2(800_000, 4)
    blob4, groups4 = chip_smoke.build_config4(800_000, 4)
    fixed2 = list(groups[0][0])
    c2 = chip_smoke.check_sharded_scan(
        "6a", one, blob, [(c, {"payment_type": m}) for c, m in groups],
        fixed2, [], cuda, wrappers, 1)
    c4 = chip_smoke.check_sharded_scan("6b", one, blob4, groups4,
                                       ["fare", "tip"], ["vendor", "note"],
                                       cuda, wrappers, 1)
    launches = chip_smoke.check_consumer_meshes(
        "8a", one, [("config 2", c2, fixed2, []),
                    ("config 4", c4, ["fare", "tip"], ["vendor", "note"])],
        FileReader(blob), cuda, wrappers)
    for k in ("scatter_to_dense", "byte_densify", "place_rows"):
        assert launches[k] > 0, k
    two = NamedSharding(Mesh([cuda, cuda], ("data",)), P("data"))
    v, counts = gather_column(one, c2["results"], "pickup_ts",
                              out_sharding=two)
    assert len(v.addressable_shards) == 2
    assert all(sh.data.device == cuda for sh in v.addressable_shards)
    # the two slots hold separate buffers, not views of one
    a, b = (sh.data for sh in v.addressable_shards)
    assert a.data_ptr() != b.data_ptr()


def test_filtered_read_on_card_matches_cpu(cuda):
    """A filtered read on ``cuda:0`` (late materialization: the host
    decodes the surviving rows, the card receives them) equals the same
    read with ``device="cpu"``, buffer for buffer and counter for
    counter; then phase 9 at a small size on the card."""
    from tpuparquet_torch.filter import col

    blob, groups = chip_smoke.build_config2(400_000, 2)
    g2 = [(c, {"payment_type": m}) for c, m in groups]
    blob = chip_smoke._write(chip_smoke.SCHEMA, g2, None, page_rows=4096,
                             bloom_columns=chip_smoke.BLOOM_COLUMNS)
    reader = FileReader(blob)
    limit = 1_700_000_000_000 + 180_000 * groups[0][0]["pickup_ts"].size
    for f in (col("pickup_ts") < limit,
              (col("rate_code") == 3) & col("payment_type").not_null()):
        outs = []
        for device in (cuda, "cpu"):
            with collect_stats() as st:
                got = dict(read_row_groups_device(reader, device=device,
                                                  filter=f))
            outs.append((got, {k: getattr(st, k)
                               for k in chip_smoke.PRUNE_COUNTERS
                               + ("chunks", "pages", "values",
                                  "bytes_staged", "row_groups")}))
        (card, st_card), (cpu, st_cpu) = outs
        assert st_card == st_cpu and card.keys() == cpu.keys()
        for rg in card:
            for name, c in card[rg].items():
                assert c.device.type == "cuda"
                a, b = c.padded_buffers(), cpu[rg][name].padded_buffers()
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k], err_msg=name)
    launches = chip_smoke.check_filtered(cuda, 400_000, 2,
                                         chip_smoke.kernel_wrappers(),
                                         reps=0, page_rows=16_384,
                                         bloom_rows=40_000)
    assert launches["scatter_to_dense"] and launches["byte_densify"]


def _salvage_inputs(cuda):
    """Config 2 at 200,000 rows a row group in 8 groups, with the 1x1
    mesh's scan of it (phase 6a's units at a small size)."""
    from tpuparquet_torch.shard import ShardedScan

    one = chip_smoke.shard_meshes(cuda)[0][1]
    blob, groups = chip_smoke.build_config2(8_000_000, 8)
    results = ShardedScan([blob], mesh=one).run()
    return one, blob, groups, results


def test_salvage_on_card_matches_cpu(cuda):
    """Phase 10a and 10b at a small size: each damaged copy salvaged and
    read on the card equals its read on the CPU buffer for buffer, and
    the phase's checks (every recovered buffer as the intact read's,
    exact counters, K1-K5 and K7 launching, the strict reject, the
    salvaging scan) pass."""
    one, blob, groups, results = _salvage_inputs(cuda)
    for label, data, want in chip_smoke.damaged_copies(blob):
        r = FileReader(data, salvage=True)
        assert r.row_group_count() == want, label
        card = dict(read_row_groups_device(r, device=cuda))
        cpu = dict(read_row_groups_device(r, device="cpu"))
        for rg in card:
            for name, c in card[rg].items():
                a, b = c.padded_buffers(), cpu[rg][name].padded_buffers()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k],
                                                  err_msg=f"{label} {name}")
    launches = chip_smoke.check_salvage(blob, groups, results, one, cuda,
                                        chip_smoke.kernel_wrappers())
    for k in chip_smoke.CONFIG2_KERNELS:
        assert launches[k] > 0, k


def test_hedged_reads_on_card(cuda):
    """Phase 10c at a small size: the hung primary hedged to its mirror,
    bit-exact on the card, in a read and a replica-group scan; the hang
    with no mirror ends in DeadlineExceededError within its budget."""
    one, blob, _, results = _salvage_inputs(cuda)
    launches = chip_smoke.check_hedged(blob, results, one, cuda,
                                       chip_smoke.kernel_wrappers(), 0.0)
    for k in chip_smoke.CONFIG2_KERNELS:
        assert launches[k] > 0, k


def test_decode_chunk_on_card(cuda):
    """Phase 10d at a small size: decode_chunk_device of each chunk of
    row group 0 equals read_row_group_device's buffers, and the thread
    arena's slabs come back once the stream is done."""
    from tpuparquet_torch.kernels.arena import thread_arena

    blob, _ = chip_smoke.build_config2(2_000_000, 2)
    launches = chip_smoke.check_decode_chunk(
        FileReader(blob), cuda, chip_smoke.kernel_wrappers())
    for k in chip_smoke.CONFIG2_KERNELS:
        assert launches[k] > 0, k
    assert not thread_arena()._used


def test_nested_write_on_card(cuda):
    """Phase 11a at a small size: the nested table (a struct, a MAP and a
    LIST of structs) written from DeviceValues on the card equals the
    numpy-written file at 1 and the default encode workers, and its read
    on the card equals the generator's values, levels and masks."""
    launches = chip_smoke.check_nested_write(
        400_000, 2, cuda, chip_smoke.kernel_wrappers(), reps=1)
    for k in ("lanes_min_max", "dict_build", "unpack_u32",
              "levels_to_validity"):
        assert launches[k] > 0, k


def test_traced_pass_on_card(cuda):
    """Phase 11b at a small size: a traced, event-logging read is one
    connected tree, its events and histograms count every page, the
    live registry equals the collector, and it launches what the
    untraced read launches."""
    blob, _ = chip_smoke.build_config2(2_000_000, 2)
    launches = chip_smoke.check_traced_pass(
        FileReader(blob), cuda, chip_smoke.kernel_wrappers(), 2_000_000,
        reps=1)
    for k in chip_smoke.CONFIG2_KERNELS:
        assert launches[k] > 0, k


def test_postmortem_scan_on_card(cuda):
    """Phase 11c at a small size: one corrupt page quarantines one unit,
    the post-mortem holds its incident with a flight-recorder tail, and
    the exported trace loads as one tree."""
    from tpuparquet_torch.shard import make_mesh

    blob, _ = chip_smoke.build_config2(2_000_000, 2)
    chip_smoke.check_postmortem_scan(blob, make_mesh(1), cuda,
                                     chip_smoke.kernel_wrappers())


def test_armed_scan_on_card(cuda):
    """Phase 12 at a small size: a traced and profiled sharded scan of a
    config-2-shaped file on the card.  Hand-driven samples inside the
    calling thread's transfer and dispatch windows carry those stages,
    the ledger's and the progress frame's ``bytes_staged`` equal the
    collector's of a plain read, the ledgers sum to the registry, the
    digests count every unit, a hung read fires the burn-rate alert, and
    config 2's kernels launch."""
    from tpuparquet_torch.kernels.device import read_row_groups_device
    from tpuparquet_torch.shard import make_mesh

    blob, _ = chip_smoke.build_config2(2_000_000, 2)
    with collect_stats() as st:
        list(read_row_groups_device(FileReader(blob), device=cuda))
    torch.cuda.synchronize()
    launches = chip_smoke.check_armed_scan(
        blob, make_mesh(1), cuda, chip_smoke.kernel_wrappers(), 2_000_000,
        want_staged=st.bytes_staged, reps=1)
    for k in chip_smoke.CONFIG2_KERNELS:
        assert launches[k] > 0, k


def test_arbiter_pair_on_card(cuda):
    """Phase 13 at a small size: two tenants' scans of a config-2-shaped
    file at once on the card, each sized by its share, units equal to a
    plain scan's, admission refused on a full queue, the budgets back to
    the legacy knobs once the arbiter is gone."""
    from tpuparquet_torch.serve import plan_budget
    from tpuparquet_torch.shard import ShardedScan, make_mesh

    blob, _ = chip_smoke.build_config2(2_000_000, 2)
    mesh = make_mesh(1)
    results = ShardedScan([blob], mesh=mesh).run()
    torch.cuda.synchronize()
    launches = chip_smoke.check_arbiter(
        blob, results, mesh, cuda, chip_smoke.kernel_wrappers(), reps=1)
    for k in chip_smoke.CONFIG2_KERNELS:
        assert launches[k] > 0, k
    assert plan_budget() is None


def test_native_writes_on_card(cuda):
    """Phase 5's native legs at a small size: config 2 from numpy and from
    card-resident DeviceValues, on the native page path and the pure one,
    at one and the default encode workers: every file byte-equal, every
    data page native on the native leg."""
    blob, groups = chip_smoke.build_config2(2_000_000, 2)
    dv = chip_smoke._device_groups(FileReader(blob), cuda)
    chip_smoke.check_native_writes(groups, dv, 2_000_000, reps=1)


def test_remote_reads_and_dataset_on_card(cuda):
    """Phase 14 at a small size: config 2 through ``emu://`` and an
    ``http://`` origin on 127.0.0.1, cold then warm (exact fetch, coalesce,
    retry and disk-hit counts, buffers equal to the in-memory read's), two
    processes over one shared disk tier, and a ``DatasetScan`` of four
    hive partitions pruned to two, config 2's kernels launching."""
    from tpuparquet_torch.shard import make_mesh

    # 200,000 rows a row group, one a partition: the transports engage
    blob, groups = chip_smoke.build_config2(4_000_000, 4)
    launches = chip_smoke.check_remote(
        blob, groups, FileReader(blob), make_mesh(1), cuda,
        chip_smoke.kernel_wrappers(), 0.0)
    for k in chip_smoke.CONFIG2_KERNELS + ["scatter_to_dense",
                                           "place_rows"]:
        assert launches[k] > 0, k


def test_server_and_tool_on_card(cuda):
    """Phase 15 at a small size: config 2 (200,000 rows a row group, so
    the transports engage) through a two-tenant ``ScanServer``, its drain
    and resume, its prefetch over ``emu://`` and its plan cache, and the
    command-line tool's verify, serve, tenants and meta, config 2's
    kernels launching."""
    from tpuparquet_torch.shard import ShardedScan, make_mesh

    blob, _ = chip_smoke.build_config2(4_000_000, 4)
    mesh = make_mesh(1)
    results = ShardedScan([blob], mesh=mesh).run()
    torch.cuda.synchronize()
    launches = chip_smoke.check_server(blob, results, FileReader(blob), mesh,
                                       cuda, chip_smoke.kernel_wrappers())
    for k in chip_smoke.CONFIG2_KERNELS:
        assert launches[k] > 0, k


def test_server_job_and_verify_on_card_equal_cpu(cuda, tmp_path):
    """A ``ScanServer`` job on the card gives the CPU mesh's job buffer for
    buffer, byte planes among its pages; ``parquet_tool verify`` on the
    card prints what it prints with ``--device cpu``, timings aside."""
    import contextlib
    import re

    from tpuparquet_torch.cli import parquet_tool
    from tpuparquet_torch.serve import ResourceArbiter, ScanServer
    from tpuparquet_torch.shard import make_mesh

    blob, _ = chip_smoke.build_config2(2_000_000, 2)
    path = str(tmp_path / "config2.parquet")
    with open(path, "wb") as f:
        f.write(blob)
    jobs = []
    for mesh in (make_mesh(1), make_mesh(1, devices=["cpu"])):
        with ScanServer(arbiter=ResourceArbiter(total_workers=2),
                        mesh=mesh) as srv:
            srv.add_tenant("t")
            job = srv.submit("t", [path])
            assert job.wait(300) and job.state == "done", job.as_dict()
        jobs.append(job)
    card, cpu = jobs
    assert card.stats.pages_device_planes > 0
    assert card.stats.pages_device_planes == cpu.stats.pages_device_planes
    assert sorted(card.outputs) == sorted(cpu.outputs) == [0, 1]
    for k, cols in card.outputs.items():
        for name, col in cols.items():
            a, b = col.padded_buffers(), cpu.outputs[k][name].padded_buffers()
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
    outs = []
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert parquet_tool.main(["verify", "--device", device,
                                      path]) == 0
        outs.append(re.sub(r"cpu [0-9.]+ms  device [0-9.]+ms", "-",
                           buf.getvalue()))
    assert outs[0] == outs[1] and "all row groups bit-exact" in outs[0]


def test_dataset_write_and_compaction_on_card(cuda):
    """Phase 16a-16c at a small size: config 2 (200,000 rows a row group,
    so the transports engage) written by the port's DatasetWriter,
    hive-partitioned by rate_code, and read by ``DatasetScan`` on the
    card; a commit killed at its first promote and resumed; compaction
    through ``parquet_tool compact``, then filtered scans before and after
    with exact pruning counters, K1-K4 launching (K5 and K7 as routed)."""
    from tpuparquet_torch.shard import make_mesh

    _, groups = chip_smoke.build_config2(4_000_000, 4)
    launches = chip_smoke.check_dataset(
        groups, make_mesh(1), cuda, chip_smoke.kernel_wrappers(),
        target_mb=2, compact_mb=8, page_rows=16_384)
    for k in chip_smoke.CONFIG2_KERNELS[:4]:
        assert launches[k] > 0, k


def test_floor_file_read_on_card(cuda):
    """Phase 16d at a small size: config 2's rows as ``Trip`` objects
    written by ``floor.Writer.write_columns`` in four row groups and read
    by ``read_row_groups_device`` on the card, the generator's columns;
    ``floor.Reader``'s objects and the row path's columns agree; K1-K4
    launching (K5 and K7 as routed)."""
    _, groups = chip_smoke.build_config2(4_000_000, 4)
    launches = chip_smoke.check_floor(groups, cuda,
                                      chip_smoke.kernel_wrappers(),
                                      n_objects=200_000, n_row_path=2_000)
    for k in chip_smoke.CONFIG2_KERNELS[:4]:
        assert launches[k] > 0, k
