"""Port API and CLI against mrisr_tpu's (CPU): load_model on the
reference's three torch checkpoint layouts, its refusals, and the
synth / eval / predict-volume commands on the same store and checkpoint."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mrisr_tpu import cli as jax_cli
from mrisr_tpu.api import load_model as jax_load_model
from mrisr_tpu.config import ModelConfig as JaxModelConfig
from mrisr_tpu_torch import cli
from mrisr_tpu_torch.api import load_model
from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
from mrisr_tpu_torch.config import ModelConfig
from mrisr_tpu_torch.models import UNet
from torch_port_util import noise

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
F = 4
HW = 32


def seeded_port_unet(use_bias: bool, seed: int = 0) -> UNet:
    """A port UNet: torch's default conv init from ``seed``, then non-trivial
    BN statistics and biases (flax-style 1/0/0/1 would hide a BN mix-up)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = UNet(features=F, use_bias=use_bias)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.weight.copy_(1 + 0.2 * torch.randn_like(m.weight))
                    m.bias.copy_(0.1 * torch.randn_like(m.bias))
                    m.running_mean.copy_(0.1 * torch.randn_like(m.bias))
                    m.running_var.copy_(0.5 + torch.rand_like(m.bias))
                elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                    m.bias.copy_(0.05 * torch.randn_like(m.bias))
    return model.eval()


def write_checkpoint(path, name, layout, seed=0):
    """The reference's file for ``name`` in one of its three layouts."""
    ckpt = reference_checkpoint(seeded_port_unet(name != "unet_gan", seed),
                                name, epoch=3, val_loss=0.25)
    if layout == "generator_state_dict":
        ckpt = {"epoch": 3, "generator_state_dict": ckpt["model_state_dict"]}
    elif layout == "raw":
        ckpt = ckpt["model_state_dict"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(ckpt, path)
    return path


@pytest.mark.parametrize("name,layout", [
    ("unet", "model_state_dict"), ("unet_combined", "raw"),
    ("unet_gan", "generator_state_dict")])
def test_load_model_reads_reference_layouts(tmp_path, name, layout):
    """The port and the JAX package load the same file and agree."""
    fname = {"unet": "unet_best.pt", "unet_combined": "unet_combined_best.pt",
             "unet_gan": "unet_gan_best.pt"}[name]
    write_checkpoint(str(tmp_path / fname), name, layout)
    mcfg = ModelConfig(name=name, base_features=F)
    got_model = load_model(name, str(tmp_path), checkpoint="required",
                           cfg=mcfg, device="cpu")
    want_model = jax_load_model(name, str(tmp_path), checkpoint="required",
                                cfg=JaxModelConfig(name=name,
                                                   base_features=F),
                                image_size=(HW, HW))
    x = noise((2, HW, HW, 2), seed=1)
    got = got_model.predict_nhwc(torch.from_numpy(x)).numpy()
    want = np.asarray(want_model.predict_nhwc(x))
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the NCHW contract and the BN-folded model give the same answer
    nchw = got_model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(nchw.transpose(0, 2, 3, 1), got, atol=0)
    folded = load_model(name, str(tmp_path), cfg=mcfg, fold_bn=True,
                        device="cpu")
    assert not folded.module.use_bn
    np.testing.assert_allclose(
        folded.predict_nhwc(torch.from_numpy(x)).numpy(), got, atol=1e-4)


def test_load_model_refusals(tmp_path):
    mcfg = ModelConfig(base_features=F)
    with pytest.raises(FileNotFoundError, match="Checkpoint not found"):
        load_model("unet", str(tmp_path), checkpoint="required", cfg=mcfg,
                   device="cpu")
    with pytest.raises(FileNotFoundError, match="not found"):
        load_model("unet", str(tmp_path), checkpoint=str(tmp_path / "x.pt"),
                   cfg=mcfg, device="cpu")
    # an Orbax dir is found first and is read only through its conversion:
    # a port-trained unet_best.pt beside it is not one, and never fresh
    # weights
    write_checkpoint(str(tmp_path / "unet_best.pt"), "unet", "raw")
    (tmp_path / "unet_best").mkdir()
    for kw in ({}, {"checkpoint": "required"},
               {"checkpoint": str(tmp_path / "unet_best")}):
        with pytest.raises(NotImplementedError,
                           match="tools/orbax_to_torch.py"):
            load_model("unet", str(tmp_path), cfg=mcfg, device="cpu", **kw)
    # every registry family loads (fresh weights here); the discriminator
    # is not an eval model
    assert load_model("progressive_unet", str(tmp_path / "empty"),
                      device="cpu").kind == "window"
    with pytest.raises(ValueError, match="discriminator"):
        load_model("patchgan", str(tmp_path), device="cpu")
    # a step-distilled student needs its checkpoint and grid sidecar
    with pytest.raises(FileNotFoundError, match="distill-steps"):
        load_model("fastddpm_steps5", str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="Unknown model"):
        load_model("nope", str(tmp_path), device="cpu")
    # no checkpoint anywhere: seeded fresh weights, the same each time
    a = load_model("unet", str(tmp_path / "empty"), cfg=mcfg, device="cpu")
    b = load_model("unet", str(tmp_path / "empty"), cfg=mcfg, device="cpu")
    for (k, va), vb in zip(a.module.state_dict().items(),
                           b.module.state_dict().values()):
        assert torch.equal(va, vb), k


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A store made by the port's CLI in a subprocess (python -m), equal
    to the JAX CLI's, and a reference-layout unet_best.pt."""
    w = tmp_path_factory.mktemp("cli")
    r = subprocess.run(
        [sys.executable, "-m", "mrisr_tpu_torch", "synth", str(w / "store"),
         "--patients", "8", "--slices", "8", "--size", str(HW)],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "packed 8 synthetic series" in r.stdout
    jax_cli.main(["synth", str(w / "jax_store"), "--patients", "8",
                  "--slices", "8", "--size", str(HW)])
    for f in sorted(os.listdir(w / "jax_store")):
        assert (w / "store" / f).read_bytes() == (
            w / "jax_store" / f).read_bytes(), f
    write_checkpoint(str(w / "models" / "unet_best.pt"), "unet",
                     "model_state_dict", seed=5)
    return w


def common(w, results):
    return ["--model", "unet", "--data", str(w / "store"), "--image-size",
            str(HW), "--features", str(F), "--batch-size", "4",
            "--checkpoint-dir", str(w / "models"), "--results-dir",
            str(w / results)]


def test_cli_eval_matches_jax(workdir, capsys):
    jax_cli.main(["eval", *common(workdir, "jax_results")])
    cli.main(["eval", *common(workdir, "results"), "--device", "cpu"])
    out = capsys.readouterr().out
    got = json.loads((workdir / "results" / "unet_test_metrics.json")
                     .read_text())
    want = json.loads((workdir / "jax_results" / "unet_test_metrics.json")
                      .read_text())
    assert '"3mm"' in out and set(got) == set(want) == {"3mm", "6mm"}
    for label in want:
        for k, w in want[label].items():
            tol = 3e-5 if k.startswith("ssim") else 1e-3
            assert got[label][k] == pytest.approx(w, abs=tol), (label, k)


def _predicted_only(out):
    """(SSIM, PSNR, MAE) of predict-volume's 'predicted slices only' line."""
    m = re.search(r"predicted slices only: SSIM (\S+) PSNR (\S+) MAE (\S+)",
                  out)
    return np.array([float(v) for v in m.groups()])


@pytest.mark.parametrize("hierarchical", [False, True])
def test_cli_predict_volume_matches_jax(workdir, capsys, hierarchical):
    flag = ["--hierarchical"] if hierarchical else []
    args = ["predict-volume", *common(workdir, "r"), *flag]
    jax_cli.main(args)
    want = _predicted_only(capsys.readouterr().out)
    cli.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("unet: SSIM ")
    # printed to 4, 2 and 4 decimals: one unit in the last place apart
    assert np.all(np.abs(_predicted_only(out) - want)
                  <= np.array([1.1e-4, 1.1e-2, 1.1e-4])), (out, want)


def test_cli_unported_flags_raise(workdir):
    """``--figure`` (once refused, ROADMAP item 10) renders the comparison
    figure and ``--export-dicom`` writes each model's predicted series;
    ``eval --bf16`` runs and writes the metrics ``eval`` writes without the
    flag, as in the JAX CLI, where only the trainers read
    ``compute_dtype``."""
    import matplotlib.image as mpimg

    from mrisr_tpu_torch.data.discovery import check_z_spacing, count_slices

    png, dcm = workdir / "f.png", workdir / "flags_dicom"
    cli.main(["predict-volume", *common(workdir, "r"), "--device", "cpu",
              "--figure", str(png), "--export-dicom", str(dcm)])
    assert mpimg.imread(str(png)).shape[0] > 100
    assert count_slices(str(dcm / "unet")) == 8
    assert check_z_spacing(str(dcm / "unet")) == pytest.approx(1.5)
    metrics = {}
    for flag in ([], ["--bf16"]):
        results = "bf16_on" if flag else "bf16_off"
        cli.main(["eval", *common(workdir, results), "--device", "cpu",
                  *flag])
        metrics[results] = json.loads(
            (workdir / results / "unet_test_metrics.json").read_text())
    assert metrics["bf16_on"] == metrics["bf16_off"]


def test_load_model_reads_numpy_values(workdir, capsys):
    """A reference-layout checkpoint that carries numpy values beside the
    state dict (a scalar, a history array, a list of np.float32) loads
    weights-only, through load_model and the eval command."""
    ckpt = reference_checkpoint(seeded_port_unet(True, seed=5), "unet",
                                epoch=3)
    ckpt.update(val_loss=np.float64(0.5),
                history=np.linspace(1.0, 0.5, 4, dtype=np.float32),
                train_losses=[np.float32(0.9), np.float32(0.7)])
    models = workdir / "np_models"
    models.mkdir()
    torch.save(ckpt, models / "unet_best.pt")
    with pytest.raises(Exception, match="[Ww]eights only"):
        torch.load(models / "unet_best.pt", weights_only=True)
    loaded = load_model("unet", str(models), checkpoint="required",
                        cfg=ModelConfig(base_features=F), device="cpu")
    sd = {k.replace("final_conv.", "final."): v
          for k, v in ckpt["model_state_dict"].items()}
    for k, v in loaded.module.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k
    cli.main(["eval", "--model", "unet", "--data", str(workdir / "store"),
              "--image-size", str(HW), "--features", str(F), "--batch-size",
              "4", "--checkpoint-dir", str(models), "--results-dir",
              str(workdir / "np_results"), "--device", "cpu"])
    got = json.loads((workdir / "np_results" / "unet_test_metrics.json")
                     .read_text())
    assert set(got) == {"3mm", "6mm"}
    assert all(np.isfinite(got[s]["ssim_mean"]) for s in got)


def train_args(w, *extra):
    return ["train", "--preset", "unet", "--data", str(w / "store"),
            "--device", "cpu", "--features", str(F), "--image-size", str(HW),
            "--batch-size", "4", "--checkpoint-dir", str(w / "train_models"),
            "--results-dir", str(w / "train_results"), *extra]


def test_cli_train_resume_then_eval(workdir, capsys):
    trainer = cli.main(train_args(workdir, "--epochs", "2"))
    out = capsys.readouterr().out
    assert "Epoch 2/2" in out and "best val loss" in out
    losses = trainer.history.series["train_loss"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    models = workdir / "train_models"
    assert sorted(os.listdir(models)) == [
        f"unet_{s}.pt" for s in ("best", "epoch_1", "epoch_2", "latest")]
    trainer = cli.main(train_args(workdir, "--epochs", "3", "--resume"))
    out = capsys.readouterr().out
    assert "resumed from epoch 2" in out and "Epoch 3/3" in out
    hist = json.loads((workdir / "train_results" / "unet_history.json")
                      .read_text())
    assert hist["epoch"] == [1.0, 2.0, 3.0]
    assert hist["train_loss"][:2] == losses
    assert {"train_loss", "val_loss", "epoch_time_s", "best_val_loss",
            "config", "timestamp"} <= set(hist)
    assert hist["config"]["preset"] == "unet"
    assert (models / "unet_epoch_3.pt").exists()
    cli.main(["eval", "--model", "unet", "--data", str(workdir / "store"),
              "--image-size", str(HW), "--features", str(F), "--batch-size",
              "4", "--checkpoint-dir", str(models), "--results-dir",
              str(workdir / "train_results"), "--device", "cpu"])
    metrics = json.loads((workdir / "train_results" / "unet_test_metrics.json")
                         .read_text())
    assert all(np.isfinite(metrics[s]["ssim_mean"]) for s in ("3mm", "6mm"))


@pytest.mark.parametrize("preset,item", [
    ("unet_gan", "item 11"), ("deepcnn", "item 11"),
    ("progressive_unet", "item 11"), ("fastddpm", "item 12"),
    ("fastddpm_simple", "item 12")])
def test_cli_train_unported_presets_raise(workdir, preset, item):
    """The presets once refused (citing ROADMAP ``item`` 11 or 12) now
    train: one epoch on the CPU writes ``<preset>_best.pt``, which
    ``load_model`` reads back."""
    args = train_args(workdir, "--epochs", "1")
    args[2] = preset
    args[args.index("--checkpoint-dir") + 1] = str(workdir / preset)
    trainer = cli.main(args)
    assert all(np.isfinite(trainer.history.series["train_loss"]))
    assert (workdir / preset / f"{preset}_best.pt").exists()
    loaded = load_model(preset, str(workdir / preset), checkpoint="required",
                        cfg=trainer.config.model, device="cpu")
    assert loaded.kind == {"progressive_unet": "window", "fastddpm":
                           "diffusion", "fastddpm_simple": "diffusion"}.get(
                               preset, "pair")


def test_cli_train_unported_flags_raise(workdir):
    """``--mesh-data 2`` with one rank (the JAX CLI's refusal with one
    visible device; data parallelism runs under torchrun,
    ``tests/test_torch_port_parallel.py``) and ``--scan-epochs`` without a
    device bank refuse, and the distillation preset points at the distill
    command, as in the JAX CLI; ``--bf16`` trains in bf16 compute with
    float32 parameters and checkpoints."""
    args = train_args(workdir, "--bf16", "--epochs", "1")
    args[args.index("--checkpoint-dir") + 1] = str(workdir / "bf16_models")
    trainer = cli.main(args)
    assert trainer.config.train.compute_dtype == "bfloat16"
    assert trainer.state.module.final.compute_dtype == torch.bfloat16
    assert all(np.isfinite(trainer.history.series["train_loss"]))
    ckpt = torch.load(workdir / "bf16_models" / "unet_best.pt",
                      weights_only=True)
    assert all(v.dtype == torch.float32 for k, v in
               ckpt["model_state_dict"].items() if "num_batches" not in k)
    with pytest.raises(SystemExit, match="requests 2x1 devices but only 1 "
                                         "is visible"):
        cli.main(train_args(workdir, "--mesh-data", "2"))
    args = train_args(workdir)
    args[2] = "unet_distilled"
    with pytest.raises(SystemExit, match="distill"):
        cli.main(args)
    with pytest.raises(SystemExit, match="--backend device"):
        cli.main(train_args(workdir, "--scan-epochs"))


@pytest.mark.parametrize("preset,beta", [("fastddpm_cosine128", "cosine"),
                                         ("fastddpm_large", "linear")])
def test_cli_train_base128_fastddpm_presets(workdir, preset, beta):
    """The base-128 Fast-DDPM presets train through the same trainer as
    'fastddpm': their time_dim 256 and beta schedule come from the preset
    (the width from --features here)."""
    args = train_args(workdir, "--epochs", "1")
    args[2] = preset
    args[args.index("--checkpoint-dir") + 1] = str(workdir / preset)
    trainer = cli.main(args)
    assert trainer.state.module.time_dim == 256
    assert trainer.config.model.beta_schedule == beta
    assert all(np.isfinite(trainer.history.series["train_loss"]))
    assert (workdir / preset / f"{preset}_best.pt").exists()


def _parsed(argv, command, monkeypatch):
    """The namespace the port CLI hands ``command``'s function."""
    seen = {}
    monkeypatch.setattr(cli, command, lambda args: seen.setdefault("a", args))
    cli.main(argv)
    return vars(seen["a"])


def _jax_flags(capsys, command):
    with pytest.raises(SystemExit):
        jax_cli.main([command, "--help"])
    return set(re.findall(r"(--[a-z][a-z0-9-]*)", capsys.readouterr().out))


_COMMON = {"epochs": None, "lr": None, "lr_schedule": None,
           "patience": None, "train_seed": None, "light_checkpoints": False,
           "resume": False, "mesh_data": None, "mesh_model": None,
           "shard_hosts": False, "allow_fresh": False, "backend": "host"}


@pytest.mark.parametrize("command,fn,argv,defaults", [
    ("distill", "cmd_distill", ["--data", "d"], {
        "preset": "unet_distilled", "teacher": "unet", "teacher_dir": None,
        "teacher_features": None, "distill_alpha": None,
        "distill_lambda_ssim": None, "ema": None, "teacher_quant": "none",
        "init_from_teacher": False, "config": None, "scan_epochs": False,
        **_COMMON}),
    ("distill-steps", "cmd_distill_steps", ["--data", "d"], {
        "teacher": "fastddpm", "teacher_dir": None, "factor": 2,
        "rounds": 2, "no_eval": False, "max_eval_batches": None,
        "config": None, **_COMMON}),
    ("serve", "cmd_serve", ["--bundle", "b"], {
        "bundle": "b", "host": "127.0.0.1", "port": 8000, "batch_size": 128,
        "max_delay_ms": 2.0}),
    ("train", "cmd_train", ["--preset", "unet", "--data", "d"], {
        "config": None, "scan_epochs": False, **_COMMON}),
    ("eval", "cmd_eval", ["--model", "unet", "--data", "d"], {
        "metric_mode": "minmax-each", "max_batches": None, **_COMMON}),
    ("predict-volume", "cmd_predict_volume", ["--model", "unet", "--data",
                                              "d"], {
        "seed": 42, "hierarchical": False, "figure": None,
        "view": "parallel", "view_index": None, "export_dicom": None,
        **_COMMON}),
    ("compare", "cmd_compare", ["--model", "unet"], {
        "metric_mode": "minmax-each", "max_batches": None,
        "from_results": False, "data": None, **_COMMON}),
    ("triplet-figure", "cmd_triplet_figure", ["--model", "unet", "--data",
                                              "d"], {
        "seed": 42, "figure": "results/single_triplet.png", **_COMMON}),
    ("export-serving", "cmd_export_serving", ["--out", "o", "--data", "d"], {
        "model": "unet", "quant": "int8_fused", "calib_batches": 4,
        "percentile": None, **_COMMON}),
    ("extract", "cmd_extract", ["z", "o"], {"zip": "z", "out": "o"}),
    ("clean", "cmd_clean", ["r"], {"root": "r", "yes": False,
                                   "dry_run": False}),
    ("pack", "cmd_pack", ["r", "o"], {"root": "r", "out": "o",
                                      "slices": 60}),
    ("synth", "cmd_synth", ["o"], {"out": "o", "patients": 8, "slices": 60,
                                   "size": 256, "seed": 0}),
])
def test_cli_distill_commands_take_jax_flags(command, fn, argv, defaults,
                                             capsys, monkeypatch):
    """Every subcommand takes every flag of the JAX CLI's same command
    with the same defaults (the common training flags included, which
    the commands that do not train ignore, as the JAX CLI does); the only
    flag the port adds is ``--device``."""
    args = _parsed([command, *argv], fn, monkeypatch)
    for k, v in defaults.items():
        assert args[k] == v, k
    assert args.get("device") is None
    want = _jax_flags(capsys, command)
    with pytest.raises(SystemExit):
        cli.main([command, "--help"])
    got = set(re.findall(r"(--[a-z][a-z0-9-]*)", capsys.readouterr().out))
    assert want <= got, want - got
    assert got - want <= {"--device"}, got - want


def test_cli_eval_ignores_training_flags(workdir, capsys):
    """The JAX CLI's eval takes the training flags and ignores them
    (``eval ... --epochs 5 --train-seed 3``); so does the port's, and it
    writes the metrics JSON, as the JAX CLI does on the same input."""
    argv = ["eval", "--model", "unet", "--image-size", str(HW),
            "--features", str(F), "--allow-fresh", "--max-batches", "1",
            "--epochs", "5", "--train-seed", "3"]
    jax_dir, port_dir = workdir / "q3_jax", workdir / "q3_port"
    jax_cli.main([*argv, "--data", str(workdir / "jax_store"),
                  "--checkpoint-dir", str(workdir / "q3_models"),
                  "--results-dir", str(jax_dir)])
    cli.main([*argv, "--data", str(workdir / "store"), "--checkpoint-dir",
              str(workdir / "q3_models"), "--results-dir", str(port_dir),
              "--device", "cpu"])
    for d in (jax_dir, port_dir):
        metrics = json.loads((d / "unet_test_metrics.json").read_text())
        assert all(np.isfinite(metrics[s]["ssim_mean"])
                   for s in ("3mm", "6mm"))


def test_cli_distill_resume_eval(workdir, capsys):
    """cli distill on the CPU from the width-4 teacher checkpoint: the
    int8_fused teacher, the pruned init at width 2, the EMA and the SSIM
    term, one epoch, then --resume to 2; eval --model unet_distilled reads
    the served (averaged) weights."""
    models, results = workdir / "distill_models", workdir / "distill_results"
    args = ["distill", "--teacher", "unet", "--teacher-dir",
            str(workdir / "models"), "--teacher-features", str(F),
            "--teacher-quant", "int8_fused", "--init-from-teacher", "--ema",
            "0.9", "--distill-lambda-ssim", "0.1", "--data",
            str(workdir / "store"), "--features", "2", "--image-size",
            str(HW), "--batch-size", "4", "--checkpoint-dir", str(models),
            "--results-dir", str(results), "--device", "cpu"]
    tr = cli.main([*args, "--epochs", "1"])
    assert tr.state.module.features == 2
    assert tr.config.train.compute_dtype == "bfloat16"  # the preset's
    tr = cli.main([*args, "--epochs", "2", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out and "Epoch 2/2" in out
    hist = json.loads((results / "unet_distilled_history.json").read_text())
    assert hist["epoch"] == [1.0, 2.0]
    for k in ("train_teacher_mse", "train_gt_mse", "train_ssim_loss",
              "val_ssim_loss"):
        assert len(hist[k]) == 2 and all(np.isfinite(hist[k])), k
    ckpt = torch.load(models / "unet_distilled_latest.pt", weights_only=True)
    assert {"model_state_dict", "live_params"} <= set(ckpt)
    cli.main(["eval", "--model", "unet_distilled", "--data",
              str(workdir / "store"), "--image-size", str(HW), "--features",
              "2", "--checkpoint-dir", str(models), "--results-dir",
              str(results), "--device", "cpu", "--max-batches", "1"])
    metrics = json.loads((results / "unet_distilled_test_metrics.json")
                         .read_text())
    assert all(np.isfinite(metrics[s]["ssim_mean"]) for s in ("3mm", "6mm"))


def test_cli_distill_steps_eval_export_serve(workdir, capsys, monkeypatch):
    """cli distill-steps on the CPU (10 -> 5 -> 3, one epoch a round), its
    files and per-round report, eval --model fastddpm_steps3,
    export-serving --model fastddpm_steps5 --quant int8_deep (a ddim_grid
    bundle) and cli serve answering one HTTP request."""
    import io
    import urllib.request

    from mrisr_tpu.ckpt import convert_torch_checkpoint
    from mrisr_tpu_torch.models.diffusion import FastDDPMUNet
    from mrisr_tpu_torch.serve.http import ServingServer

    models, results = workdir / "steps_models", workdir / "steps_results"
    os.makedirs(models)
    torch.manual_seed(7)
    torch.save(reference_checkpoint(FastDDPMUNet(base_features=F),
                                    "fastddpm"), models / "fastddpm_best.pt")
    common = ["--data", str(workdir / "store"), "--image-size", str(HW),
              "--features", str(F), "--batch-size", "4", "--checkpoint-dir",
              str(models), "--results-dir", str(results), "--device", "cpu"]
    report = cli.main(["distill-steps", "--teacher", "fastddpm", *common,
                       "--epochs", "1", "--max-eval-batches", "1"])
    assert set(report) == {"teacher", "fastddpm_steps5", "fastddpm_steps3"}
    for n, grid in ((5, [175, 525, 749, 849, 949]),
                    (3, [175, 749, 949])):
        entry = report[f"fastddpm_steps{n}"]
        assert set(entry) == {"history", "eval", "ssim_delta_vs_teacher_3mm",
                              "ssim_delta_vs_teacher_6mm"}
        assert len(entry["history"]["train_loss"]) == 1
        sidecar = json.loads((models / f"fastddpm_steps{n}_grid.json")
                             .read_text())
        assert sidecar == {"base": "fastddpm", "factor": 2,
                           "timesteps": grid}
        # the JAX package's converter reads the student's weights
        convert_torch_checkpoint("fastddpm", torch.load(
            models / f"fastddpm_steps{n}_best.pt", weights_only=True))
    assert json.loads((results / "fastddpm_stepdistill.json").read_text()
                      ) == json.loads(json.dumps(report))
    cli.main(["eval", "--model", "fastddpm_steps3", *common,
              "--max-batches", "1"])
    metrics = json.loads((results / "fastddpm_steps3_test_metrics.json")
                         .read_text())
    assert all(np.isfinite(metrics[s]["ssim_mean"]) for s in ("3mm", "6mm"))
    bundle = str(workdir / "steps5_bundle")
    cli.main(["export-serving", "--model", "fastddpm_steps5", *common,
              "--quant", "int8_deep", "--calib-batches", "1", "--out",
              bundle])
    assert json.loads(open(os.path.join(bundle, "meta.json")).read())[
        "sampler"] == "ddim_grid"

    answers = []

    def serve_one(server):
        """In place of the blocking loop: serve in the background, answer
        one request, then stop as Ctrl-C would."""
        server.start_background()
        buf = io.BytesIO()
        np.save(buf, noise((HW, HW, 2), 8))
        req = urllib.request.Request(
            f"http://{server.host}:{server.port}/predict",
            data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=60) as resp:
            answers.append(np.load(io.BytesIO(resp.read())))
        raise KeyboardInterrupt

    monkeypatch.setattr(ServingServer, "serve_forever", serve_one)
    cli.main(["serve", "--bundle", bundle, "--port", "0", "--batch-size",
              "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "shutting down" in out
    assert answers[0].shape == (HW, HW, 1) and np.isfinite(answers[0]).all()


# ---------------------------------------------------------------- slice 10:
# DICOM ingest and export, compare, triplet-figure, progressive
# predict-volume


def write_dicom_tree(root, n_patients=3, slices=8, hw=HW):
    """The dataset's layout at test size: one T2 series a patient, written
    by the port's writer from seeded arrays, plus decoys (an ultrasound and
    a 3D-rendering series, and a series one slice short)."""
    from mrisr_tpu_torch.data.dicom_lite import write_dicom

    rng = np.random.default_rng(11)
    truth = {}

    def series(folder, n, **kw):
        vols = (rng.random((n, hw, hw)) * 3000).astype(np.uint16)
        for z in range(n):
            write_dicom(str(folder / f"1-{z + 1:02d}.dcm"), vols[z],
                        instance_number=z + 1,
                        image_position=(0.0, 0.0, 1.5 * z), **kw)
        return vols

    for p in range(1, n_patients + 1):
        pid = f"Prostate-MRI-US-Biopsy-{p:04d}"
        study = root / pid / "1.3.6.1-MRI PROSTATE"
        truth[pid] = series(study / "3.000-t2 ax", slices,
                            series_description="t2 ax", patient_id=pid)
    series(root / "Prostate-MRI-US-Biopsy-0001" / "us" / "1.0-US", slices,
           modality="US")
    series(root / "Prostate-MRI-US-Biopsy-0002" / "s" / "9.0-3D", slices,
           series_description="T2 3D RENDERING")
    series(root / "Prostate-MRI-US-Biopsy-0003" / "s" / "5.0-short",
           slices - 1)
    return truth


def test_cli_extract_clean_pack_matches_jax(tmp_path, capsys, monkeypatch):
    """extract -> clean (--dry-run, a declined prompt, --yes) -> pack on a
    zipped DICOM tree: the same messages and the same store (manifest but
    its source path, volumes bit for bit) as the JAX CLI's, each packed
    volume equal to the array written."""
    import zipfile

    tree = tmp_path / "tree"
    truth = write_dicom_tree(tree / "Prostate-MRI-US-Biopsy")
    zpath = tmp_path / "dataset.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        for f in sorted(tree.rglob("*.dcm")):
            zf.write(f, f.relative_to(tree))
    outs = {}
    for who, main in (("port", cli.main), ("jax", jax_cli.main)):
        out = tmp_path / who
        main(["extract", str(zpath), str(out)])
        root = str(out / "Prostate-MRI-US-Biopsy")
        main(["clean", root, "--dry-run"])
        monkeypatch.setattr("builtins.input", lambda prompt: "no")
        main(["clean", root])
        main(["clean", root, "--yes"])
        main(["pack", root, str(out / "store"), "--slices", "8"])
        outs[who] = capsys.readouterr().out.replace(str(out), "<out>")
    assert outs["port"] == outs["jax"]
    assert "extracted 47 members, 0 failed" in outs["port"]
    assert "total series: 6; to delete: 2" in outs["port"]
    assert "dry run: nothing deleted" in outs["port"]
    assert "cancelled" in outs["port"]
    assert "removed 2 series; kept 4" in outs["port"]
    assert "packed 3 series" in outs["port"]
    got = json.loads((tmp_path / "port" / "store" / "manifest.json")
                     .read_text())
    want = json.loads((tmp_path / "jax" / "store" / "manifest.json")
                      .read_text())
    assert got["meta"]["source"] != want["meta"]["source"]
    got["meta"] = want["meta"] = None
    assert got == want
    for e in got["series"]:
        port_npy = tmp_path / "port" / "store" / e["file"]
        assert port_npy.read_bytes() == (
            tmp_path / "jax" / "store" / e["file"]).read_bytes()
        np.testing.assert_array_equal(
            np.load(port_npy), truth[e["patient_id"]].astype(np.float32))


def test_cli_predict_volume_export_dicom_matches_jax(workdir, capsys):
    """predict-volume --export-dicom from the same checkpoint: each exported
    voxel within one uint16 code of the JAX CLI's, the same headers, Z
    1.5 mm apart."""
    from mrisr_tpu_torch.data.dicom_lite import read_dicom
    from mrisr_tpu_torch.data.discovery import (
        check_z_spacing,
        read_series_volume,
    )

    args = ["predict-volume", *common(workdir, "r")]
    jax_cli.main([*args, "--export-dicom", str(workdir / "jax_dicom")])
    want_out = capsys.readouterr().out
    results = cli.main([*args, "--export-dicom", str(workdir / "dicom"),
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.replace(str(workdir / "dicom"), "D").splitlines()[2] == \
        want_out.replace(str(workdir / "jax_dicom"), "D").splitlines()[2]
    got_dir, want_dir = workdir / "dicom" / "unet", workdir / "jax_dicom" / "unet"
    got = read_series_volume(str(got_dir))
    want = read_series_volume(str(want_dir))
    assert got.shape == want.shape == (8, HW, HW)
    assert np.abs(got - want).max() <= 1
    # the uint16 map of the prediction the command returned
    vol = results["unet"]["volume_predicted"]
    lo, hi = float(vol.min()), float(vol.max())
    codes = ((vol - lo) * (65535.0 / (hi - lo + 1e-8))).astype(np.uint16)
    np.testing.assert_array_equal(got, codes.astype(np.float32))
    assert check_z_spacing(str(got_dir)) == pytest.approx(1.5)
    for f in sorted(os.listdir(got_dir)):
        h = read_dicom(str(got_dir / f), pixels=False).fields
        assert h == read_dicom(str(want_dir / f), pixels=False).fields
        assert h["SeriesDescription"] == "mrisr-tpu unet predicted"


@pytest.fixture(scope="module")
def family_models(workdir):
    """Seeded checkpoints of a pair UNet, DeepCNN and the Progressive UNet
    in the reference's layout, which both packages load."""
    from mrisr_tpu_torch.models.registry import init_model

    models = workdir / "family_models"
    models.mkdir()
    write_checkpoint(str(models / "unet_best.pt"), "unet",
                     "model_state_dict", seed=5)
    for seed, name in enumerate(("deepcnn", "progressive_unet")):
        module, _ = init_model(name, ModelConfig(name=name, base_features=F),
                               seed=seed + 1)
        torch.save(reference_checkpoint(module, name),
                   models / f"{name}_best.pt")
    return models


def family_args(workdir, family_models, results="family_results"):
    return ["--data", str(workdir / "store"), "--image-size", str(HW),
            "--features", str(F), "--batch-size", "4", "--checkpoint-dir",
            str(family_models), "--results-dir", str(workdir / results)]


def test_cli_predict_volume_progressive_matches_jax(workdir, family_models,
                                                    monkeypatch):
    """predict-volume routes the window model through
    predict_volume_progressive, as the JAX CLI does: the metrics within
    1e-4 of the JAX CLI's from the same checkpoint."""
    from mrisr_tpu.eval import volume_eval as jax_volume_eval

    seen = {}
    real = jax_volume_eval.predict_volume_progressive

    def keep(*a, **kw):
        seen["res"] = real(*a, **kw)
        return seen["res"]

    monkeypatch.setattr(jax_volume_eval, "predict_volume_progressive", keep)
    args = ["predict-volume", "--model", "progressive_unet",
            *family_args(workdir, family_models)]
    jax_cli.main(args)
    got = cli.main([*args, "--device", "cpu"])["progressive_unet"]
    want = seen["res"]
    assert got["predicted_indices"] == [int(i) for i in
                                        want["predicted_indices"]]
    for k, v in want["metrics"].items():  # PSNR inf where a slice is kept
        np.testing.assert_allclose(got["metrics"][k], v, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got["volume_predicted"],
                               np.asarray(want["volume_predicted"]),
                               atol=1e-4)


def test_cli_triplet_figure_matches_jax(workdir, family_models, capsys,
                                        monkeypatch):
    """triplet-figure: the same seeded triplet, each pair model's
    prediction within 1e-4 of the JAX CLI's, the window model skipped, the
    figure written."""
    import matplotlib.image as mpimg

    from mrisr_tpu.eval import figures as jax_figures

    seen = {}
    monkeypatch.setattr(jax_figures, "triplet_grid_figure",
                        lambda pre, post, gt, preds, save_path: seen.update(
                            preds=preds, pre=pre, gt=gt))
    args = ["triplet-figure", "--model", "unet", "deepcnn",
            "progressive_unet", "--seed", "3",
            *family_args(workdir, family_models)]
    jax_cli.main([*args, "--figure", str(workdir / "jax_t.png")])
    png = workdir / "t.png"
    got = cli.main([*args, "--figure", str(png), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("skipping progressive_unet") == 2
    assert set(got) == set(seen["preds"]) == {"unet", "deepcnn"}
    for name, pred in got.items():
        assert pred.shape == (HW, HW)
        np.testing.assert_allclose(pred, np.asarray(seen["preds"][name]),
                                   atol=1e-4)
    assert mpimg.imread(str(png)).shape[0] > 100


def test_cli_compare_matches_jax(workdir, family_models, capsys):
    """compare, live (two batches a spacing) on a pair UNet, DeepCNN and
    the Progressive UNet: the rows within 1e-4 of the JAX CLI's (PSNR
    relative); then --from-results, given the same metric files (with a
    partial one and a missing one), prints the same text and writes the
    same CSV bytes."""
    import csv

    args = ["compare", "--model", "unet", "deepcnn", "progressive_unet",
            "--max-batches", "2", *family_args(workdir, family_models)]
    jax_cli.main([*args[:-1], str(workdir / "jax_compare")])
    want_out = capsys.readouterr().out
    rows = cli.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    assert [r[0] for r in rows] == ["unet", "deepcnn", "progressive_unet"]
    with open(workdir / "jax_compare" / "comparison_metrics.csv") as f:
        want_rows = list(csv.reader(f))[1:]
    for r, w in zip(rows, want_rows):
        assert r[0] == w[0]
        for i in (1, 3):  # SSIM
            assert r[i] == pytest.approx(float(w[i]), abs=1e-4), (r, w)
        for i in (2, 4):  # PSNR, dB
            assert r[i] == pytest.approx(float(w[i]), rel=1e-4), (r, w)
    assert out.splitlines()[:2] == want_out.splitlines()[:2]

    results = workdir / "from_results"
    results.mkdir()
    m = lambda s, p: {"ssim_mean": s, "psnr_mean": p}  # noqa: E731
    files = {"unet": {"3mm": m(0.81234, 29.876), "6mm": m(0.7012, 27.5)},
             "progressive_unet": {"i1": m(0.8, 30.0), "i2": m(0.7, 28.0),
                                  "i3": m(0.9, 31.0)},
             "partial": {"3mm": m(0.5, 20.0), "i1": m(0.1, 1.0)}}
    for name, metrics in files.items():
        (results / f"{name}_test_metrics.json").write_text(json.dumps(metrics))
    texts, csvs = [], []
    for main in (jax_cli.main, cli.main):
        main(["compare", "--from-results", "--model", "unet",
              "progressive_unet", "partial", "missing", "--results-dir",
              str(results)])
        texts.append(capsys.readouterr().out)
        csvs.append((results / "comparison_metrics.csv").read_bytes())
    assert texts[0] == texts[1] and csvs[0] == csvs[1]
    assert "| unet | 0.8123 | 29.88 | 0.7012 | 27.50 |" in texts[1]
    assert "| progressive_unet | 0.8500 | 30.50 | 0.7000 | 28.00 |" in \
        texts[1]
    assert "| partial | 0.5000 | 20.00 | n/a | n/a |" in texts[1]
    assert "skipping missing" in texts[1]
    with pytest.raises(SystemExit, match="--data"):
        cli.main(["compare", "--model", "unet"])
