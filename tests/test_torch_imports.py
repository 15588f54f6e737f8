"""The port stands alone: no JAX and nothing of ``repro``; no silent CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.models import MambaLM, TransformerLM
from repro_torch.runtime.server import Server

ROOT = Path(__file__).resolve().parents[1]
PACKAGE_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
PORT_FILES = PACKAGE_FILES + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "examples").glob("*_torch.py"))


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    mods = ["repro_torch"] + sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in PACKAGE_FILES if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_cuda_without_explicit_cpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SMOKE_ARCHS["gemma-2b"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(cfg, batch_size=1, max_seq=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(cfg, device="cuda")
    assert TransformerLM(cfg, device="cpu").device.type == "cpu"
    ssm = SMOKE_ARCHS["mamba2-780m"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MambaLM(ssm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(ssm, batch_size=1, max_seq=8)
    assert MambaLM(ssm, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the script exits non-zero and prints no result; alone,
    without the repository beside it, it cannot start at all."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(lone)], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
