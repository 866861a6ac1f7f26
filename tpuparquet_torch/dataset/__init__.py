"""Partitioned datasets: atomic multi-file writes, manifest-resolved
scans, compaction.

* :class:`DatasetWriter`: a hive-partitioned writer whose commit is a
  CRC-framed, atomically renamed manifest journal; a kill at any byte
  leaves the previous snapshot or a resumable journal, never a torn
  dataset (``dataset/writer.py``).
* :class:`DatasetScan`: reads only through the newest valid manifest
  (or hive directories), with partition-value pruning in front of the
  per-file pruning layers (``dataset/scan.py``).
* :func:`compact_dataset`: small files merged, re-sorted by a column,
  committed through the same protocol; :func:`gc_unreferenced` deletes
  the files no kept snapshot names (``dataset/compact.py``).
* :func:`sweep_orphans`: quarantines, never deletes, the staging
  leftovers of crashed writes (``dataset/manifest.py``).
"""

from .compact import compact_dataset, gc_unreferenced  # noqa: F401
from .manifest import (  # noqa: F401
    resolve_manifest,
    sweep_orphans,
)
from .scan import (  # noqa: F401
    DatasetScan,
    partition_matches,
    split_partition_filter,
)
from .writer import DatasetWriter, target_bytes_default  # noqa: F401

__all__ = [
    "DatasetWriter",
    "DatasetScan",
    "compact_dataset",
    "gc_unreferenced",
    "resolve_manifest",
    "sweep_orphans",
    "split_partition_filter",
    "partition_matches",
    "target_bytes_default",
]
