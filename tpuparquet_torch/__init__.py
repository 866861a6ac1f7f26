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

Entry points run on the current CUDA device unless ``device="cpu"`` is
passed, which runs every kernel's plain PyTorch version instead.
"""

from .kernels.encode import (  # noqa: F401
    DeviceValues,
    bss_encode_device,
    delta_encode_device,
    pack_u32_device,
    pack_u64_device,
)
