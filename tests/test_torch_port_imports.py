"""The port package stands alone: it imports neither jax/flax/optax/orbax nor
scikit-learn nor anything of mrisr_tpu, and its entry points refuse to run without a card
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
FORBIDDEN = ("jax", "flax", "optax", "orbax", "sklearn", "mrisr_tpu")


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 'sklearn'):\n"
        "    sys.modules[m] = None\n"
        "import mrisr_tpu_torch, mrisr_tpu_torch.models, mrisr_tpu_torch.ckpt\n"
        "import mrisr_tpu_torch.ops.conv_int8, mrisr_tpu_torch.ops.upconv\n"
        "import mrisr_tpu_torch.serve, mrisr_tpu_torch._build\n"
        "import mrisr_tpu_torch.ops.ssim_fused, mrisr_tpu_torch.data.pipeline\n"
        "import mrisr_tpu_torch.eval.runner, mrisr_tpu_torch.api\n"
        "import mrisr_tpu_torch.cli, mrisr_tpu_torch.ckpt.torch_ckpt\n"
        "import mrisr_tpu_torch.models.diffusion, mrisr_tpu_torch.ops.groupnorm\n"
        "import mrisr_tpu_torch.serve.quant_diffusion\n"
        "import mrisr_tpu_torch.losses, mrisr_tpu_torch.losses.vgg\n"
        "import mrisr_tpu_torch.ops.augment, mrisr_tpu_torch.ckpt.io\n"
        "import mrisr_tpu_torch.models.registry, mrisr_tpu_torch.train\n"
        "import mrisr_tpu_torch.train.device_epoch\n"
        "import mrisr_tpu_torch.train.gan, mrisr_tpu_torch.train.diffusion\n"
        "import mrisr_tpu_torch.models.deepcnn, mrisr_tpu_torch.models.conv\n"
        "import mrisr_tpu_torch.models.discriminator\n"
        "import mrisr_tpu_torch.models.progressive\n"
        "import mrisr_tpu_torch.serve.distill, mrisr_tpu_torch.serve.prune\n"
        "import mrisr_tpu_torch.serve.distill_diffusion\n"
        "import mrisr_tpu_torch.serve.http\n"
        "import mrisr_tpu_torch.data.dicom_lite, mrisr_tpu_torch.data.dicom_fast\n"
        "import mrisr_tpu_torch.data.discovery, mrisr_tpu_torch.data.clean\n"
        "import mrisr_tpu_torch.data.extract, mrisr_tpu_torch.data.export\n"
        "import mrisr_tpu_torch.eval.figures, mrisr_tpu_torch.utils\n"
        "import mrisr_tpu_torch.parallel, mrisr_tpu_torch.parallel.mesh\n"
        "assert 'matplotlib' not in sys.modules\n"
        "from mrisr_tpu_torch.data.split import split_for\n"
        "assert len(split_for([str(i) for i in range(10)], 'test')) == 2\n"
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


def test_parallel_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """The data mesh and data-parallel serving default to the card: with
    none they raise, and the CPU runs only when asked for."""
    from mrisr_tpu_torch.parallel import make_mesh
    from mrisr_tpu_torch.serve import data_parallel_apply

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data_parallel_apply(lambda d: None, 2)
    assert make_mesh(device="cpu").shape == {"data": 1, "model": 1}


def test_eval_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from mrisr_tpu_torch import cli
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.config import DataConfig
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.synthetic import make_synthetic_store
    from mrisr_tpu_torch.eval.metrics import per_sample_metrics
    from mrisr_tpu_torch.eval.runner import evaluate_pair_model_test_set
    from mrisr_tpu_torch.eval.volume_eval import predict_volume

    store = make_synthetic_store(str(tmp_path / "s"), num_patients=8,
                                 slices_per_volume=5, height=16, width=16)
    cfg = DataConfig(image_size=(16, 16))
    x = np.zeros((2, 16, 16), np.float32)
    for call in (
        lambda: build_loader(store, "test", cfg),
        lambda: per_sample_metrics(x, x),
        lambda: predict_volume(lambda b: b[..., :1], np.zeros((5, 16, 16))),
        lambda: evaluate_pair_model_test_set(lambda b: b[..., :1], store, cfg),
        lambda: load_model("unet", str(tmp_path)),
        lambda: cli.main(["eval", "--model", "unet", "--data", store.root,
                          "--allow-fresh", "--checkpoint-dir",
                          str(tmp_path)]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # explicit CPU works
    assert per_sample_metrics(x + 1, x, device="cpu")["num_samples"] == 2


def test_diffusion_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.config import ModelConfig
    from mrisr_tpu_torch.models.diffusion import FastDDPMUNet
    from mrisr_tpu_torch.serve.bundle import export_serving_bundle
    from mrisr_tpu_torch.serve.quant_diffusion import FastDDPMForward

    torch.manual_seed(0)
    params = fastddpm_flax_params(FastDDPMUNet(base_features=4, time_dim=8))
    mcfg = ModelConfig(name="fastddpm", base_features=4, time_dim=8)
    for call in (
        lambda: load_model("fastddpm", str(tmp_path), cfg=mcfg),
        lambda: FastDDPMForward(params),
        lambda: export_serving_bundle(str(tmp_path / "b"), "fastddpm",
                                      str(tmp_path), quant="none", cfg=mcfg),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # explicit CPU works: fresh seeded weights, the 10-step chain
    loaded = load_model("fastddpm", str(tmp_path), cfg=mcfg, device="cpu")
    assert loaded.kind == "diffusion"
    assert loaded.schedule.num_inference_steps == 10
    y = loaded(np.zeros((1, 2, 8, 8), np.float32))
    assert y.shape == (1, 1, 8, 8) and torch.isfinite(y).all()


def test_train_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from mrisr_tpu_torch import cli
    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.data.synthetic import make_synthetic_store
    from mrisr_tpu_torch.train import SupervisedTrainer

    store = make_synthetic_store(str(tmp_path / "s"), num_patients=8,
                                 slices_per_volume=5, height=16, width=16)
    for call in (
        lambda: SupervisedTrainer(PRESETS["unet"]),
        lambda: cli.main(["train", "--preset", "unet", "--data", store.root,
                          "--features", "4", "--image-size", "16",
                          "--checkpoint-dir", str(tmp_path / "m")]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "m").exists()


def test_distill_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """The distillation slice's entry points: the trainer, the teacher,
    a step-distilled student's load, the HTTP front end and the three
    commands."""
    import json

    from mrisr_tpu_torch import cli
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
    from mrisr_tpu_torch.config import ModelConfig, PRESETS
    from mrisr_tpu_torch.data.synthetic import make_synthetic_store
    from mrisr_tpu_torch.models.diffusion import FastDDPMUNet
    from mrisr_tpu_torch.serve.distill import (
        DistillationTrainer,
        make_teacher_fn,
    )
    from mrisr_tpu_torch.serve.http import serve_bundle

    store = make_synthetic_store(str(tmp_path / "s"), num_patients=8,
                                 slices_per_volume=5, height=16, width=16)
    torch.manual_seed(0)
    torch.save(reference_checkpoint(FastDDPMUNet(base_features=4,
                                                 time_dim=8), "fastddpm"),
               tmp_path / "fastddpm_steps3_best.pt")
    (tmp_path / "fastddpm_steps3_grid.json").write_text(json.dumps(
        {"base": "fastddpm", "factor": 2, "timesteps": [1, 5, 9]}))
    common = ["--data", store.root, "--features", "4", "--image-size", "16",
              "--checkpoint-dir", str(tmp_path / "m")]
    for call in (
        lambda: DistillationTrainer(PRESETS["unet_distilled"],
                                    teacher_fn=lambda x: x[..., :1]),
        lambda: make_teacher_fn("unet", str(tmp_path)),
        lambda: load_model("fastddpm_steps3", str(tmp_path),
                           cfg=ModelConfig(name="fastddpm", base_features=4,
                                           time_dim=8)),
        lambda: serve_bundle(str(tmp_path / "b"), port=0),
        lambda: cli.main(["distill", *common]),
        lambda: cli.main(["distill-steps", *common]),
        lambda: cli.main(["serve", "--bundle", str(tmp_path / "b"),
                          "--port", "0"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "m").exists()


def test_ingest_and_compare_entry_points(no_cuda, tmp_path, capsys):
    """The DICOM commands run on the host and need no card; predict-volume
    (with --export-dicom), compare and triplet-figure default to the card
    and refuse without one, writing nothing."""
    from mrisr_tpu_torch import cli
    from mrisr_tpu_torch.data.dicom_lite import write_dicom
    from mrisr_tpu_torch.data.synthetic import make_synthetic_store

    series = tmp_path / "dicom" / "Prostate-MRI-US-Biopsy-0001" / "s" / "t2"
    for z in range(3):
        write_dicom(str(series / f"{z}.dcm"), np.full((4, 4), z, np.uint16))
    cli.main(["clean", str(tmp_path / "dicom"), "--yes"])
    cli.main(["pack", str(tmp_path / "dicom"), str(tmp_path / "p"),
              "--slices", "3"])
    assert "packed 1 series" in capsys.readouterr().out
    store = make_synthetic_store(str(tmp_path / "s"), num_patients=8,
                                 slices_per_volume=8, height=16, width=16)
    common = ["--model", "unet", "--data", store.root, "--allow-fresh",
              "--features", "4", "--image-size", "16", "--checkpoint-dir",
              str(tmp_path / "m"), "--results-dir", str(tmp_path / "r")]
    for argv in (
        ["predict-volume", *common, "--export-dicom", str(tmp_path / "d")],
        ["compare", *common],
        ["triplet-figure", *common, "--figure", str(tmp_path / "t.png")],
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert not any((tmp_path / n).exists() for n in ("d", "r", "t.png"))
