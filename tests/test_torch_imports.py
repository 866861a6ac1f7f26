"""tpuparquet_torch stands alone: no JAX, no tpuparquet, and no silent
fallback to the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuparquet_torch.format.metadata import CompressionCodec
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.kernels import device as port_device

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "tpuparquet_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_modules(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_tpuparquet_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "tpuparquet", "tools"), (path, mod)


def _file() -> bytes:
    import io

    buf = io.BytesIO()
    with FileWriter(buf, "message m { required int32 v; }",
                    codec=CompressionCodec.SNAPPY) as w:
        w.write_columns({"v": np.arange(10, dtype=np.int32)})
    return buf.getvalue()


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reader = FileReader(_file())
    with pytest.raises(RuntimeError, match="CUDA"):
        port_device.read_row_groups_device(reader)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_device.read_row_group_device(reader, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_device.read_row_group_device(reader, 0, device="cuda")
    out = dict(port_device.read_row_groups_device(reader, device="cpu"))
    np.testing.assert_array_equal(out[0]["v"].to_numpy()[0], np.arange(10))


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_obs_package_stands_alone():
    """``tpuparquet_torch.obs`` and the modules that hook it import in a
    fresh interpreter without JAX or the JAX package."""
    code = ("import sys\n"
            "import tpuparquet_torch.obs, tpuparquet_torch.shard.scan, "
            "tpuparquet_torch.io.writer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpuparquet')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
