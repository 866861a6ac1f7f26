"""Pages, column chunks, the file writer and the file reader; the
byte-range sources and their range caches are exported here."""

from .rangecache import (  # noqa: F401
    invalidate_source_caches,
    reset_range_caches,
)
from .source import (  # noqa: F401
    ByteRangeSource,
    EmulatedStoreSource,
    LocalByteRangeSource,
    coalesce_ranges,
    open_byte_source,
    parse_source_uri,
)
