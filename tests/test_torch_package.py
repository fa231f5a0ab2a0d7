"""Package rules of the PyTorch/CUDA port.

- it imports with jax (and the JAX package) unavailable, and no module of
  it or chip_smoke.py imports either;
- its entry points default to the card and raise without one;
- failed native / nvcc builds and unsupported devices raise instead of
  falling back.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import wrenc_tpu_torch
from wrenc_tpu_torch.core.config import EncoderConfig
from wrenc_tpu_torch.search import WavefrontSearch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(wrenc_tpu_torch.__file__).parent


def _modules():
    return sorted(
        "wrenc_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("")
                                      .parts).replace(".__init__", "")
        for p in PKG.rglob("*.py"))


def test_imports_without_jax():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['wrenc_tpu'] = None\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 30


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_no_jax_or_wrenc_tpu_imports(target):
    files = (sorted(PKG.rglob("*.py")) if target == "package"
             else [ROOT / "chip_smoke.py"])
    assert files and all(f.exists() for f in files)
    bad = [(str(f), n) for f in files for n in _imported_names(f)
           if n.split(".")[0] in ("jax", "jaxlib", "wrenc_tpu")]
    assert not bad, bad


def test_search_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        WavefrontSearch(EncoderConfig(width=64, height=64))
    with pytest.raises(RuntimeError, match="CUDA"):
        from wrenc_tpu_torch.encoder import Encoder
        Encoder(EncoderConfig(width=64, height=64))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    from wrenc_tpu_torch.entropy.native import loader
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_SRC", str(bad))
    monkeypatch.setattr(loader, "_BUILD", str(tmp_path))
    monkeypatch.setattr(loader, "_SO", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        loader.available()


def test_nvcc_build_failure_raises(tmp_path, monkeypatch):
    from wrenc_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("dq_scan")


def test_kernel_wrappers_refuse_other_devices():
    from wrenc_tpu_torch.kernels import quantize, trellis
    t = torch.zeros((2, 4, 4), dtype=torch.int32, device="meta")
    lam = np.zeros(1024, np.int32)
    lv = np.zeros(1024, np.float32)
    with pytest.raises(ValueError):
        quantize.greedy_depquant(t, 1, 1, lam, 2, lv)
    with pytest.raises(ValueError):
        trellis.trellis_rate(t, 1, 1, lam, lv, 2)
    with pytest.raises(ValueError):
        trellis.trellis_rate_batch([(t, 1, 1, 2)], lam, lv)
    assert quantize.greedy_depquant.launches == 0
    assert trellis.trellis_rate.launches == 0
    assert trellis.trellis_rate_batch.launches == 0


def test_tf32_off_at_import():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
