"""Host-side codecs: bit-packing, the RLE/bit-packed hybrid, levels,
dictionaries, the delta encodings, BYTE_STREAM_SPLIT and PLAIN."""

from .bitpack import pack, pack_msb, unpack, unpack_msb  # noqa: F401
from .bss import decode_byte_stream_split, encode_byte_stream_split  # noqa: F401
from .delta import (  # noqa: F401
    decode_delta_binary_packed,
    decode_delta_byte_array,
    decode_delta_length_byte_array,
    encode_delta_binary_packed,
    encode_delta_byte_array,
    encode_delta_length_byte_array,
)
from .dictionary import (  # noqa: F401
    build_dictionary,
    decode_dict_indices,
    encode_dict_indices,
    gather,
)
from .hybrid import (  # noqa: F401
    as_uint32,
    decode_hybrid,
    decode_hybrid_prefixed,
    encode_hybrid,
    encode_hybrid_prefixed,
)
from .levels import (  # noqa: F401
    bit_width,
    decode_levels_bitpacked,
    decode_levels_raw,
    decode_levels_v1,
    encode_levels_v1,
    encode_levels_v2,
    null_mask,
)
from .plain import ByteArrayColumn, decode_plain, encode_plain  # noqa: F401
