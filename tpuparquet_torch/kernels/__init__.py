"""Device decode and encode: host run-table plans and the hand-written
CUDA kernels."""

from .encode import (  # noqa: F401
    DeviceValues,
    bss_encode_device,
    delta_encode_device,
    pack_u32_device,
    pack_u64_device,
)
