"""The sharded scan: (file, row group) units decoded data-parallel over a
mesh of devices, and the gathers that bring a column to every device or
to the one that consumes it (the port of ``tpuparquet/shard``, one
process over its local devices)."""

from .mesh import (  # noqa: F401
    BatchedHybridPlan,
    Mesh,
    assign_units,
    decode_step_spmd,
    local_devices,
    make_mesh,
    resolve_out_sharding,
    sharded_dict_decode,
    stack_hybrid_plans,
)
from .scan import (  # noqa: F401
    ShardedScan,
    gather_byte_column,
    gather_column,
    scan_units,
)
