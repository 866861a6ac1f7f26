"""Device decode and encode: host run-table plans and the hand-written
CUDA kernels.

The row-group decode (``device``) reaches the readers and the filter,
which import this package, so its names load on first use (a module
``__getattr__``) rather than here.  The reference's names whose twins
carry other names (``unpack_u32_pallas``, ``decode_hybrid_device``,
``dict_gather_fixed``, ``dict_gather_bytes``) are listed in ROADMAP.md's
known differences."""

from .bitunpack import pad_to_words, unpack_u32  # noqa: F401
from .encode import (  # noqa: F401
    DeviceValues,
    bss_encode_device,
    delta_encode_device,
    pack_u32_device,
    pack_u64_device,
)
from .decode import (  # noqa: F401
    expand_delta_i32,
    levels_to_validity,
    plan_delta_i32,
    scatter_to_dense,
)
from .hybrid import expand_hybrid, plan_hybrid  # noqa: F401

_LAZY = {
    "DeviceColumn": "device",
    "decode_chunk_device": "device",
    "read_row_group_device": "device",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib

    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
