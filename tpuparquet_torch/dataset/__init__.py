"""Partitioned datasets, read side: :class:`DatasetScan` reads a dataset
through its newest valid manifest (or its hive directories), with
partition-value pruning in front of the per-file pruning layers
(``dataset/scan.py``); :func:`sweep_orphans` quarantines, never deletes,
the staging leftovers of crashed writes (``dataset/manifest.py``).  The
writer and the compaction wait (ROADMAP)."""

from .manifest import (  # noqa: F401
    resolve_manifest,
    sweep_orphans,
)
from .scan import (  # noqa: F401
    DatasetScan,
    partition_matches,
    split_partition_filter,
)

__all__ = [
    "DatasetScan",
    "resolve_manifest",
    "sweep_orphans",
    "split_partition_filter",
    "partition_matches",
]
