"""csv2parquet: convert a CSV file to Parquet.

The schema comes from the header row: every column optional, typed by
its ``--typehints`` entry (``col=type``) or else a string.  Each type's
parser checks its range (``int8`` to ``uint64``), an empty field is a
null, and ``--rowgroup-size`` and ``--compression`` set the writer's
row-group bound and codec.  The rows go through the row writer
(:meth:`~tpuparquet_torch.io.writer.FileWriter.add_data`), as the JAX
package's converter writes them: with the same ``--created-by`` the two
write the same bytes.

Run as ``python -m tpuparquet_torch.cli.csv2parquet --input in.csv
--output out.parquet``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import sys

from ..format.metadata import CompressionCodec
from ..io.writer import FileWriter
from . import CODECS as _CODECS

_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _int_parser(bits: int, signed: bool):
    if signed:
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    else:
        lo, hi = 0, (1 << bits) - 1

    def parse(s: str):
        v = int(s)
        if not lo <= v <= hi:
            raise ValueError(f"{v} out of range [{lo}, {hi}]")
        return v

    return parse


def _json_parser(s: str) -> bytes:
    json.loads(s)  # validate
    return s.encode("utf-8")


def _bool_parser(s: str) -> bool:
    t = s.strip().lower()
    if t in ("true", "t", "1", "yes"):
        return True
    if t in ("false", "f", "0", "no"):
        return False
    raise ValueError(f"invalid boolean {s!r}")


# type name -> (DSL leaf type, annotation, value parser)
TYPES = {
    "string": ("binary", "(STRING)", lambda s: s.encode("utf-8")),
    "byte_array": ("binary", "", lambda s: s.encode("utf-8")),
    "boolean": ("boolean", "", _bool_parser),
    "int8": ("int32", "(INT(8, true))", _int_parser(8, True)),
    "uint8": ("int32", "(INT(8, false))", _int_parser(8, False)),
    "int16": ("int32", "(INT(16, true))", _int_parser(16, True)),
    "uint16": ("int32", "(INT(16, false))", _int_parser(16, False)),
    "int32": ("int32", "(INT(32, true))", _int_parser(32, True)),
    "uint32": ("int32", "(INT(32, false))", _int_parser(32, False)),
    "int64": ("int64", "(INT(64, true))", _int_parser(64, True)),
    "uint64": ("int64", "(INT(64, false))", _int_parser(64, False)),
    "int": ("int64", "(INT(64, true))", _int_parser(64, True)),
    "float": ("float", "", float),
    "double": ("double", "", float),
    "json": ("binary", "(JSON)", _json_parser),
}


def parse_type_hints(s: str) -> dict[str, str]:
    """``col=type,col=type`` -> ``{col: type}``."""
    hints = {}
    if not s:
        return hints
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"invalid type hint {part!r}")
        col, typ = (x.strip() for x in part.split("=", 1))
        if typ not in TYPES:
            raise ValueError(
                f"unknown type {typ!r} for column {col!r}; valid: "
                + ", ".join(sorted(TYPES)))
        hints[col] = typ
    return hints


def derive_schema(header: list[str], hints: dict[str, str]) -> str:
    """The DSL schema of ``header``: every column optional, of its hinted
    type or else a string."""
    lines = []
    for col in header:
        typ = hints.get(col, "string")
        leaf, annot, _ = TYPES[typ]
        annot = f" {annot}" if annot else ""
        lines.append(f"  optional {leaf} {col}{annot};")
    return "message msg {\n" + "\n".join(lines) + "\n}"


def convert(in_f, out_f, *, hints=None, codec=CompressionCodec.SNAPPY,
            rowgroup_size=100 * 1024 * 1024, delimiter=",",
            created_by="csv2parquet", verbose=False, log=sys.stderr) -> int:
    """Stream CSV rows into a Parquet file; returns rows written."""
    hints = hints or {}
    if len(delimiter) != 1:
        raise ValueError(f"delimiter must be one character, got "
                         f"{delimiter!r}")
    reader = csv.reader(in_f, delimiter=delimiter)
    try:
        header = next(reader)
    except StopIteration:
        raise ValueError("empty CSV input: no header row")
    seen = set()
    for col in header:
        if not _IDENT.match(col):
            raise ValueError(f"column name {col!r} is not a valid "
                             "identifier")
        if col in seen:
            raise ValueError(f"duplicate column name {col!r} in header")
        seen.add(col)
    for col in hints:
        if col not in header:
            raise ValueError(f"type hint for unknown column {col!r}")
    parsers = [TYPES[hints.get(col, "string")][2] for col in header]
    schema = derive_schema(header, hints)
    if verbose:
        print(f"derived schema:\n{schema}", file=log)

    w = FileWriter(out_f, schema, codec=codec, created_by=created_by,
                   max_row_group_size=rowgroup_size or None)
    n = 0
    for lineno, rec in enumerate(reader, start=2):
        if len(rec) != len(header):
            raise ValueError(
                f"line {lineno}: {len(rec)} fields, header has "
                f"{len(header)}")
        row = {}
        for col, parser, raw in zip(header, parsers, rec):
            if raw == "":
                # an empty field is a null (every column is optional)
                continue
            try:
                row[col] = parser(raw)
            except ValueError as e:
                raise ValueError(f"line {lineno}, column {col!r}: {e}")
        w.add_data(row)
        n += 1
    w.close()
    if verbose:
        print(f"wrote {n} rows", file=log)
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="csv2parquet", description="Convert CSV files to Parquet")
    p.add_argument("--input", required=True, help="CSV file input")
    p.add_argument("--output", required=True, help="output parquet file")
    p.add_argument("--typehints", default="",
                   help="comma-separated col=type hints; valid types: "
                        + ", ".join(sorted(TYPES)))
    p.add_argument("--rowgroup-size", type=int, default=100 * 1024 * 1024,
                   help="row group size in bytes (0 = unbounded)")
    p.add_argument("--compression", default="snappy",
                   choices=sorted(_CODECS))
    p.add_argument("--delimiter", default=",")
    p.add_argument("--created-by", default="csv2parquet")
    p.add_argument("-v", dest="verbose", action="store_true",
                   help="enable verbose logging")
    args = p.parse_args(argv)

    created_output = False
    try:
        hints = parse_type_hints(args.typehints)
        with open(args.input, newline="") as in_f:
            with open(args.output, "wb") as out_f:
                created_output = True
                convert(in_f, out_f, hints=hints,
                        codec=_CODECS[args.compression],
                        rowgroup_size=args.rowgroup_size,
                        delimiter=args.delimiter,
                        created_by=args.created_by,
                        verbose=args.verbose)
    except (OSError, ValueError) as e:
        print(f"csv2parquet: {e}", file=sys.stderr)
        if created_output:
            try:  # don't leave a truncated, footer-less parquet behind
                os.unlink(args.output)
            except OSError:
                pass
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
