"""First-use builds of the package's C and CUDA sources.

Every native piece of the port ships as source under ``csrc/`` and is
compiled at first use into ``_build/`` beside this file (a directory the
repository ignores).  A library's file name carries a hash of its source
and flags, so an edited source never loads a stale build; compilers
write to a temporary name that is renamed into place, so processes that
race on the same build never see half a file.  All sources passed to
one :func:`build` call compile in parallel, one compiler process each.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from .errors import KernelBuildError

__all__ = ["BUILD_DIR", "CSRC", "KernelBuildError", "build", "find_nvcc"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"


def find_nvcc() -> str | None:
    """``nvcc`` on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    return str(cand) if cand.exists() else None


def _local_includes(source: Path, seen: set) -> None:
    """Add to ``seen`` the files of ``source``'s directory that it
    includes by ``#include "..."``, and theirs."""
    for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                           source.read_text(), re.M):
        dep = source.parent / name
        if dep.exists() and dep not in seen:
            seen.add(dep)
            _local_includes(dep, seen)


def _target(source: Path, cmd: list[str]) -> Path:
    h = hashlib.sha256()
    h.update(source.read_bytes())
    deps = set(source.parent.glob("*.cuh"))
    _local_includes(source, deps)
    for dep in sorted(deps):
        h.update(dep.read_bytes())
    h.update("\0".join(cmd).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(jobs: list[tuple[Path, list[str]]]) -> list[Path]:
    """Compile each ``(source, compiler_argv)`` into a shared library
    (the argv gets ``-o <out> <source>`` appended) and return the
    library paths in order.  Up-to-date libraries are reused (a name
    hashes the source, the ``.cuh`` headers beside it, the sources it
    includes by ``#include "..."`` and the flags); the rest compile
    concurrently.  Raises RuntimeError with the compiler's
    output when a build fails (:class:`KernelBuildError`)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [_target(src, cmd) for src, cmd in jobs]
    procs = []
    for (src, cmd), out in zip(jobs, outs):
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        p = subprocess.Popen(cmd + ["-o", str(tmp), str(src)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        procs.append((p, tmp, out, src))
    errors = []
    for p, tmp, out, src in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{src.name}:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if errors:
        raise KernelBuildError("native build failed:\n"
                               + "\n".join(errors))
    return outs
