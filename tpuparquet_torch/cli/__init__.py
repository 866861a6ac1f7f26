"""The command-line tools: ``parquet_tool`` (inspect, verify, profile,
serve and split Parquet files) and ``csv2parquet``."""

from ..format.metadata import CompressionCodec

#: the ``--compression`` values of both tools
CODECS = {
    "snappy": CompressionCodec.SNAPPY,
    "gzip": CompressionCodec.GZIP,
    "zstd": CompressionCodec.ZSTD,
    "lz4_raw": CompressionCodec.LZ4_RAW,
    "none": CompressionCodec.UNCOMPRESSED,
}
