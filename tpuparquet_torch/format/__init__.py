"""Host-side Parquet format layer: thrift metadata, footer framing and
schema, with the untrusted-metadata tools: strict validation
(``validate``) and torn-file salvage (``recover``).

The two tools reach the decode layer, which imports this package, so
their names load on first use (a module ``__getattr__``) rather than
here."""

from .compact import CompactReader, CompactWriter, ThriftError  # noqa: F401
from .footer import (  # noqa: F401
    MAGIC,
    FormatError,
    read_file_metadata,
    write_footer,
)
from .metadata import *  # noqa: F401,F403

_LAZY = {
    "Finding": "validate",
    "validate_metadata": "validate",
    "forward_scan": "recover",
    "read_salvage_hint": "recover",
    "recover_file_metadata": "recover",
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
