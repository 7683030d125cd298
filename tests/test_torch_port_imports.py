"""The port package stands alone: it imports neither jax/flax/optax nor
anything of mrisr_tpu, and its entry points refuse to run without a card
unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mrisr_tpu_torch import resolve_device
from mrisr_tpu_torch.serve import (
    InferenceEngine,
    engine_from_bundle,
    make_bundle_apply,
    quantize_unet,
    save_bundle,
)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mrisr_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "flax", "optax", "mrisr_tpu")


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "import mrisr_tpu_torch, mrisr_tpu_torch.models, mrisr_tpu_torch.ckpt\n"
        "import mrisr_tpu_torch.ops.conv_int8, mrisr_tpu_torch.ops.upconv\n"
        "import mrisr_tpu_torch.serve, mrisr_tpu_torch._build\n"
        "assert not any(m == 'mrisr_tpu' or m.startswith('mrisr_tpu.')\n"
        "               for m in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from mrisr_tpu_torch.ckpt import fold_unet_batchnorm
    from mrisr_tpu_torch.models import UNet

    torch.manual_seed(0)
    folded = fold_unet_batchnorm(UNet(features=4).eval())
    calib = {k: 1.0 for k in (
        [f"{b}/Conv_{i}" for b in ("enc1", "enc2", "enc3", "enc4",
                                   "bottleneck", "dec4", "dec3", "dec2",
                                   "dec1") for i in (0, 1)]
        + ["upconv4", "upconv3", "upconv2", "upconv1", "final"])}
    q = quantize_unet(folded, calib)
    path = save_bundle(str(tmp_path / "b"), q, model_name="unet",
                       quant="int8_fused", base_features=4,
                       image_size=(16, 16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine_from_bundle(path, batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_bundle_apply(q, {"quant": "int8_fused"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(lambda x: x, batch_size=2, input_shape=(4, 4, 2))
    # explicit CPU works
    with engine_from_bundle(path, batch_size=2, device="cpu") as eng:
        y = eng.predict(np.zeros((16, 16, 2), np.float32))
    assert y.shape == (16, 16, 1) and np.isfinite(y).all()
