"""tpuparquet_torch: the PyTorch/CUDA port of tpuparquet's device paths.

A second package beside the JAX reference (``tpuparquet``), importing
nothing from it.  It reads Parquet columns of every physical type onto
an NVIDIA GPU through hand-written CUDA kernels for Hopper (``csrc/``),
built with ``nvcc`` at first use, and writes card-resident columns back
(:class:`DeviceValues`), encoding their pages on the card:

    from tpuparquet_torch.io.reader import FileReader
    from tpuparquet_torch.io.writer import FileWriter
    from tpuparquet_torch.kernels.device import read_row_groups_device

    reader = FileReader("taxi.parquet", "payment_type")
    for rg, columns in read_row_groups_device(reader, [0, 1]):
        values, rep, dl = columns["payment_type"].to_numpy()
        dv = columns["payment_type"].as_values()  # for write_columns

Many files' row groups scan data-parallel over a mesh of devices
(:class:`ShardedScan`), and a column gathers to every device or to the one
that consumes it:

    from tpuparquet_torch import ShardedScan, make_mesh

    with ShardedScan(["a.parquet", "b.parquet"], mesh=make_mesh()) as scan:
        units = scan.run()
        values, counts = scan.gather_column(units, "fare")

A reader's source may be a byte-range source or its URI (``file://``,
``emu://``, ``http(s)://``; ``io/source.py``), read through the range
caches (``io/rangecache.py``), and a partitioned dataset directory scans
through its manifest or its hive directories (:class:`DatasetScan`):

    from tpuparquet_torch import DatasetScan

    with DatasetScan("emu:///data/trips", "fare",
                     filter="region == 'eu'") as ds:
        units = ds.run()

Entry points run on the current CUDA device unless ``device="cpu"`` (or
a mesh of ``cpu`` slots) is passed, which runs every kernel's plain
PyTorch version instead.

A :class:`DatasetWriter` writes such a dataset, hive-partitioned, each
commit atomic (a manifest journal), and :func:`compact_dataset` merges
its small files; ``floor`` maps dataclasses to rows and back:

    from tpuparquet_torch import DatasetWriter, compact_dataset

    with DatasetWriter("/data/trips", schema, ["region"]) as w:
        w.write_columns({"region": regions, "fare": fares})
    compact_dataset("/data/trips", sort_by="fare")

The top level also carries the reference's surface: the reader and the
writer, the format's enums, the schema DSL, the error taxonomy, the fault
harness, the filter DSL, the counters, the codec registry, the source and
range-cache hooks, the schema builders (``new_*``, ``logical_*``), the
dataset writer, scan and compaction, and ``obs``.

Under ``TPQ_LOCKCHECK`` the lock-order recorder (``lockcheck.py``) is
installed before anything else is imported, ``torch`` included, so every
lock the package creates is wrapped.
"""

import os as _os

if _os.environ.get("TPQ_LOCKCHECK", "") not in ("", "0"):
    from . import lockcheck as _lockcheck

    _lockcheck.install()

from . import obs  # noqa: F401,E402
from .compress import BlockCompressor, register_block_compressor  # noqa: F401
from .errors import (  # noqa: F401
    CorruptChunkError,
    CorruptFooterError,
    CorruptPageError,
    DeadlineExceededError,
    DeviceDispatchError,
    DispatchDeadlineError,
    ScanError,
    TransientIOError,
)
from .faults import QuarantineReport, inject_faults, retry_transient  # noqa: F401
from .filter import Filter, col, parse_filter  # noqa: F401
from .format.builder import (  # noqa: F401
    logical_bson,
    logical_date,
    logical_decimal,
    logical_enum,
    logical_int,
    logical_json,
    logical_string,
    logical_time,
    logical_timestamp,
    logical_uuid,
    new_data_column,
    new_group,
    new_list_column,
    new_map_column,
    new_root,
)
from .format.dsl import SchemaDefinition, parse_schema_definition  # noqa: F401
from .format.metadata import (  # noqa: F401
    CompressionCodec,
    ConvertedType,
    Encoding,
    FieldRepetitionType,
    PageType,
    Type,
)
from .format.schema import Schema  # noqa: F401
from .io import (  # noqa: F401
    invalidate_source_caches,
    open_byte_source,
    parse_source_uri,
    reset_range_caches,
)
from .io.reader import FileReader  # noqa: F401
from .io.writer import FileWriter  # noqa: F401
from .stats import DecodeStats, collect_stats, trace  # noqa: F401

from .kernels.encode import (  # noqa: F401
    DeviceValues,
    bss_encode_device,
    delta_encode_device,
    pack_u32_device,
    pack_u64_device,
)
from .shard import (  # noqa: F401
    ShardedScan,
    gather_byte_column,
    gather_column,
    make_mesh,
    sharded_dict_decode,
)
from .dataset import DatasetScan, DatasetWriter, compact_dataset  # noqa: F401
