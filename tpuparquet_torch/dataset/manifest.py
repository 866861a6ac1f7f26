"""Dataset manifests and commit journals.

A partitioned dataset directory is resolved only through its newest
valid manifest snapshot (``_manifest-<version>.json``), never by listing
its data files: the writer publishes its files first and the snapshot
last, so a snapshot names a complete commit.  Each snapshot, and the
write-ahead journal of a commit in flight (``_commit.json``), is a
versioned JSON envelope with a CRC-32 over its canonical body, written
to a temporary file in the same directory, flushed, fsynced, renamed
over the target and the directory fsynced
(:func:`atomic_write_envelope`), so a kill at any byte leaves the old
artifact or the new one whole; a snapshot that fails its CRC degrades
the resolver to the one before, with a finding.

Layout of a dataset root::

    _manifest-00000001.json   immutable snapshots (newest valid wins)
    _commit.json              journal of an in-flight commit
    _tmp/                     staged data files of a commit
    _quarantine/              swept orphans (never deleted silently)
    key=value/.../part-<sha1>.parquet   published data files

A root with no manifest is read as hive directories (``key=value``, as
pyarrow and hive write them, :func:`discover_hive`).  Fault sites:
``dataset.manifest.write`` before an envelope's write,
``dataset.manifest.load`` on the blob reads (``corrupt`` and
``truncate`` too: the CRC catches them).
"""

from __future__ import annotations

import json
import os
import re
import urllib.parse
import zlib

from ..errors import CorruptManifestError
from ..faults import fault_point, filter_bytes, retry_transient
from ..format.validate import Finding
from ..io.source import open_byte_source, parse_source_uri
from ..stats import current_stats

__all__ = [
    "MANIFEST_FORMAT",
    "JOURNAL_FORMAT",
    "ENVELOPE_VERSION",
    "JOURNAL_NAME",
    "TMP_DIR",
    "QUARANTINE_DIR",
    "HIVE_NULL",
    "split_root",
    "manifest_name",
    "list_manifest_versions",
    "file_uri",
    "atomic_write_envelope",
    "load_envelope",
    "validate_manifest_body",
    "resolve_manifest",
    "journal_path",
    "load_journal",
    "write_journal",
    "clear_journal",
    "write_manifest",
    "manifest_keep_default",
    "prune_manifests",
    "hive_token",
    "parse_hive_token",
    "partition_dir",
    "discover_hive",
    "sweep_orphans",
]

MANIFEST_FORMAT = "tpq-dataset-manifest"
JOURNAL_FORMAT = "tpq-dataset-commit"
ENVELOPE_VERSION = 1

JOURNAL_NAME = "_commit.json"
TMP_DIR = "_tmp"
QUARANTINE_DIR = "_quarantine"

#: hive's conventional token for a null partition value (what pyarrow
#: and hive itself write, so interop round-trips)
HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"

_MANIFEST_RE = re.compile(r"^_manifest-(\d{8})\.json$")


def split_root(root: str) -> tuple:
    """``"emu:///d/ds"`` -> ``("emu", "/d/ds")``; bare paths ->
    ``(None, path)``.  Both known schemes are backed by local
    directories, so the path half always supports listing."""
    parsed = parse_source_uri(root) if isinstance(root, str) else None
    if parsed is None:
        return None, root
    return parsed


def file_uri(root: str, relpath: str) -> str:
    """The source string for a manifest entry: scheme-prefixed when
    the dataset root was, else a bare path (which keeps every
    path-keyed artifact identical to a plain local scan)."""
    scheme, path = split_root(root)
    full = os.path.join(path, relpath)
    return f"{scheme}://{full}" if scheme else full


def manifest_name(version: int) -> str:
    return f"_manifest-{int(version):08d}.json"


def list_manifest_versions(root_path: str) -> list:
    """Snapshot versions present in the root, ascending."""
    out = []
    for name in os.listdir(root_path):
        m = _MANIFEST_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    out.sort()
    return out


def _canonical(obj) -> bytes:
    """Canonical JSON bytes for CRC framing (same form as the durable
    scan cursor: sorted, separator-pinned)."""
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode()


def _fsync_dir(d: str) -> None:
    """Make a rename in ``d`` durable (best effort: some file systems
    refuse a directory fsync)."""
    try:
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def atomic_write_envelope(path: str, fmt: str, body: dict) -> None:
    """Publish a manifest or journal body durably and atomically: the
    CRC-framed envelope goes to ``.<name>.tmp.<pid>`` beside ``path``,
    is flushed and fsynced, renamed over ``path``, and the directory is
    fsynced.  A kill at any byte leaves the previous complete artifact
    or the new one, never a torn one."""
    fault_point("dataset.manifest.write", file=path)
    doc = {"format": fmt,
           "file_version": ENVELOPE_VERSION,
           "crc32": zlib.crc32(_canonical(body)),
           "body": body}
    d = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def _read_blob(src) -> bytes:
    """Whole-file read through the byte-range source layer when the
    source is scheme-prefixed (a dataset can live on ``emu://``),
    plain ``open`` otherwise."""
    bs = open_byte_source(src) if isinstance(src, str) else None
    if bs is not None:
        try:
            return bs.get_range(0, bs.size())
        finally:
            bs.close()
    with open(src, "rb") as f:
        return f.read()


def load_envelope(src, fmt: str, *, display=None) -> dict:
    """Read back a manifest or journal envelope, validating
    format, version, and the CRC32 over the canonical body.  Raises
    :class:`~tpuparquet_torch.errors.CorruptManifestError` on anything that
    is not a complete, untampered artifact (atomic writes mean a torn
    file here is damage, not a crash artifact)."""
    name = display if display is not None else src
    fault_point("dataset.manifest.load", file=name)
    blob = filter_bytes("dataset.manifest.load", _read_blob(src),
                        file=name)
    try:
        doc = json.loads(blob.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CorruptManifestError(
            f"{name!r} is not valid JSON: {e}", file=name) from e
    if not isinstance(doc, dict) or doc.get("format") != fmt:
        raise CorruptManifestError(
            f"{name!r} is not a {fmt} artifact", file=name)
    if doc.get("file_version") != ENVELOPE_VERSION:
        raise CorruptManifestError(
            f"unknown {fmt} file_version "
            f"{doc.get('file_version')!r} in {name!r}", file=name)
    body = doc.get("body")
    if zlib.crc32(_canonical(body)) != doc.get("crc32"):
        raise CorruptManifestError(
            f"{name!r} failed its integrity checksum", file=name)
    return body


def validate_manifest_body(body, *, name="manifest") -> None:
    """Structural validation of a manifest/journal body: the reader
    must never act on a snapshot whose entries could walk outside the
    dataset root or whose accounting fields are unusable."""
    def bad(msg):
        raise CorruptManifestError(f"{name}: {msg}", file=name)

    if not isinstance(body, dict):
        bad("body is not an object")
    if not isinstance(body.get("version"), int) or body["version"] < 0:
        bad(f"bad version {body.get('version')!r}")
    keys = body.get("partition_keys")
    if not isinstance(keys, list) or \
            not all(isinstance(k, str) for k in keys):
        bad("partition_keys is not a list of strings")
    files = body.get("files")
    if not isinstance(files, list):
        bad("files is not a list")
    seen = set()
    for e in files:
        if not isinstance(e, dict):
            bad("file entry is not an object")
        p = e.get("path")
        if not isinstance(p, str) or not p or os.path.isabs(p) \
                or ".." in p.split("/"):
            bad(f"file path {p!r} escapes the dataset root")
        if p in seen:
            bad(f"duplicate file path {p!r}")
        seen.add(p)
        part = e.get("partition")
        if not isinstance(part, dict) or set(part) != set(keys):
            bad(f"file {p!r} partition keys do not match "
                f"{keys!r}")
        for field in ("rows", "bytes"):
            v = e.get(field)
            if v is not None and (not isinstance(v, int) or v < 0):
                bad(f"file {p!r} has bad {field} {v!r}")


def resolve_manifest(root: str, *, quarantine=None):
    """Resolve the dataset to its newest VALID manifest snapshot.

    Returns ``(body, version, findings)``.  A newest snapshot that
    fails its CRC/validation degrades to the one before it — the
    failure is recorded as an error :class:`Finding` (and a
    file-granularity entry in ``quarantine`` when one is passed),
    never silently skipped.  ``(None, None, findings)`` when no valid
    snapshot exists."""
    scheme, root_path = split_root(root)
    findings = []
    for version in reversed(list_manifest_versions(root_path)):
        rel = manifest_name(version)
        src = file_uri(root, rel)
        try:
            body = retry_transient(
                lambda s=src, r=rel: load_envelope(
                    s, MANIFEST_FORMAT, display=r))
            validate_manifest_body(body, name=rel)
            if body["version"] != version:
                raise CorruptManifestError(
                    f"{rel}: body version {body['version']} does not "
                    f"match its filename", file=rel)
        except (CorruptManifestError, OSError) as e:
            findings.append(Finding(
                "error", "dataset.manifest",
                f"snapshot {rel} rejected ({type(e).__name__}: {e}); "
                f"degrading to the previous snapshot"))
            if quarantine is not None:
                quarantine.add_file(file=rel, error=e)
            continue
        return body, version, findings
    return None, None, findings


def journal_path(root_path: str) -> str:
    return os.path.join(root_path, JOURNAL_NAME)


def load_journal(root_path: str):
    """The in-flight commit journal, or None when no commit is
    pending.  A journal that fails its framing raises — it is damage,
    not a crash artifact (the envelope write is atomic)."""
    p = journal_path(root_path)
    if not os.path.exists(p):
        return None
    body = load_envelope(p, JOURNAL_FORMAT, display=JOURNAL_NAME)
    validate_manifest_body(body, name=JOURNAL_NAME)
    return body


def write_journal(root_path: str, body: dict) -> None:
    atomic_write_envelope(journal_path(root_path), JOURNAL_FORMAT, body)


def clear_journal(root_path: str) -> None:
    try:
        os.unlink(journal_path(root_path))
    except FileNotFoundError:
        pass


def write_manifest(root_path: str, body: dict) -> str:
    p = os.path.join(root_path, manifest_name(body["version"]))
    atomic_write_envelope(p, MANIFEST_FORMAT, body)
    return p


def manifest_keep_default() -> int:
    """How many snapshots a commit keeps (``TPQ_DATASET_MANIFEST_KEEP``,
    default 3, at least 1); compaction's GC may then delete the data
    files no kept snapshot names."""
    try:
        v = int(os.environ.get("TPQ_DATASET_MANIFEST_KEEP", ""))
    except ValueError:
        return 3
    return max(v, 1)


def prune_manifests(root_path: str, keep: int | None = None) -> list:
    """Drop all but the newest ``keep`` snapshots; returns the pruned
    versions.  An old snapshot is superseded committed state (readers
    resolve newest first), so its removal is safe."""
    if keep is None:
        keep = manifest_keep_default()
    versions = list_manifest_versions(root_path)
    pruned = versions[:-keep] if keep < len(versions) else []
    for v in pruned:
        try:
            os.unlink(os.path.join(root_path, manifest_name(v)))
        except FileNotFoundError:
            pass
    return pruned


# ----------------------------------------------------------------------
# Hive path tokens
# ----------------------------------------------------------------------

def hive_token(value) -> str:
    """One ``key=value`` path token's value half: hive-escaped so
    pyarrow's ``dataset(..., partitioning="hive")`` parses it back."""
    if value is None:
        return HIVE_NULL
    if isinstance(value, bytes):
        value = value.decode("utf-8")
    return urllib.parse.quote(str(value), safe="")


def parse_hive_token(token: str):
    """Invert :func:`hive_token` (best effort on types: int, then
    float, else string — the manifest, not the path, is authoritative
    for our own readers)."""
    if token == HIVE_NULL:
        return None
    s = urllib.parse.unquote(token)
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


def partition_dir(partition_keys, partition: dict) -> str:
    """``key=value/...`` relative directory for one partition ('' for
    an unpartitioned dataset)."""
    return "/".join(f"{k}={hive_token(partition[k])}"
                    for k in partition_keys)


def discover_hive(root_path: str):
    """Manifest-less fallback: synthesize a version-0 manifest body by
    walking ``key=value`` directories (interop with datasets written
    by pyarrow/hive, which have no tpq manifest).  Returns None when
    the directory holds no parquet files."""
    files = []
    keys = None
    for dirpath, dirnames, filenames in os.walk(root_path):
        dirnames[:] = sorted(
            d for d in dirnames if not d.startswith(("_", ".")))
        rel = os.path.relpath(dirpath, root_path)
        comps = [] if rel == "." else rel.split(os.sep)
        part = {}
        ok = True
        for c in comps:
            if "=" not in c:
                ok = False
                break
            k, _, v = c.partition("=")
            part[k] = parse_hive_token(v)
        if not ok:
            continue
        for name in sorted(filenames):
            if name.startswith(("_", ".")) or \
                    not name.endswith(".parquet"):
                continue
            if keys is None:
                keys = list(part)
            if set(part) != set(keys):
                raise CorruptManifestError(
                    f"inconsistent partition depth under {root_path!r}:"
                    f" {sorted(part)} vs {sorted(keys)}",
                    file=root_path)
            p = os.path.join(*comps, name) if comps else name
            files.append({
                "path": p.replace(os.sep, "/"),
                "partition": dict(part),
                "rows": None,
                "bytes": os.path.getsize(os.path.join(dirpath, name)),
            })
    if not files:
        return None
    return {"version": 0, "partition_keys": keys or [],
            "files": files}


# ----------------------------------------------------------------------
# Orphan sweep
# ----------------------------------------------------------------------

def sweep_orphans(root: str, *, quarantine=None) -> list:
    """Move staging files and stale journals that no live commit
    references into ``_quarantine/`` — NEVER delete them silently
    (they are the only copy of data from a crashed write; the finding
    tells the operator to resume or discard deliberately).

    A staged file is an orphan when it is referenced by neither the
    pending journal nor the newest valid manifest.  Counts
    ``DecodeStats.dataset_orphans_swept``; each sweep records a
    file-granularity quarantine entry when a report is passed.
    Returns the swept relative paths."""
    _, root_path = split_root(root)
    tmp_dir = os.path.join(root_path, TMP_DIR)
    if not os.path.isdir(tmp_dir):
        return []
    referenced = set()
    swept = []
    qdir = os.path.join(root_path, QUARANTINE_DIR)
    try:
        journal = load_journal(root_path)
    except CorruptManifestError as e:
        # a journal that fails its framing is damage: sweep it too,
        # so a later writer does not trip over it
        journal = None
        os.makedirs(qdir, exist_ok=True)
        os.replace(journal_path(root_path),
                   os.path.join(qdir, JOURNAL_NAME))
        swept.append(JOURNAL_NAME)
        if quarantine is not None:
            quarantine.add_file(
                file=JOURNAL_NAME, error=e,
                swept_to=f"{QUARANTINE_DIR}/{JOURNAL_NAME}")
    if journal is not None:
        for e in journal["files"]:
            if e.get("tmp"):
                referenced.add(e["tmp"])
    for name in sorted(os.listdir(tmp_dir)):
        if name in referenced:
            continue
        src = os.path.join(tmp_dir, name)
        if not os.path.isfile(src):
            continue
        os.makedirs(qdir, exist_ok=True)
        os.replace(src, os.path.join(qdir, name))
        swept.append(f"{TMP_DIR}/{name}")
        if quarantine is not None:
            quarantine.add_file(
                file=f"{TMP_DIR}/{name}",
                error=CorruptManifestError(
                    "orphaned staging file from a crashed write "
                    "(no journal or manifest references it); moved "
                    "to _quarantine/", file=f"{TMP_DIR}/{name}"),
                swept_to=f"{QUARANTINE_DIR}/{name}")
    st = current_stats()
    if st is not None and swept:
        st.dataset_orphans_swept += len(swept)
    return swept
