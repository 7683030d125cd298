"""bf16 compute (flax's ``dtype=jnp.bfloat16``) in the port against
mrisr_tpu's (CPU, FEAT = 4, 32^2, batch 4).

The JAX side runs compiled with XLA's excess precision off
(``torch_port_util.jit_exact``), so each of its ops rounds as the flax
module writes it; plain ``jax.jit`` on the CPU keeps fused bf16
intermediates in float32 (the UNet's bf16 forward then moves 0.85 % rel-L2).

- Rounding points, block by block: a bf16 block of the port and the flax
  block with ``dtype=bfloat16`` on the same bf16 input and weights give the
  same bf16 values but for rare single roundings, which come from float32
  sums taken in another order (norm statistics, conv accumulation).  The
  same block rounding where ``torch.autocast`` would (the norms returning
  float32, the ops after them in float32) differs in a tenth or more of
  its elements where a residual add or a SiLU follows a norm.
- Each family's bf16 eval forward against the flax module built with
  ``dtype=bfloat16``, measured against the same module's float32 forward.
- ``cli train --bf16`` for every preset, and a bf16 run resumed.

One bf16 train step of each family against the JAX package's is
``tests/test_torch_port_bf16_steps.py``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.config import PRESETS as JAX_PRESETS
from mrisr_tpu.models import diffusion as jd
from mrisr_tpu.models.blocks import DoubleConv as JaxDoubleConv
from mrisr_tpu.models.deepcnn import ResidualBlock as JaxResidualBlock
from mrisr_tpu.models.registry import create_model as jax_create_model
from mrisr_tpu_torch import cli
from mrisr_tpu_torch.api import load_model
from mrisr_tpu_torch.ckpt.from_jax import (
    deepcnn_state_dict_from_flax,
    fastddpm_state_dict_from_flax,
    patchgan_state_dict_from_flax,
    progressive_state_dict_from_flax,
    simple_diffusion_state_dict_from_flax,
    state_dict_from_layers,
    unet_state_dict_from_flax,
)
from mrisr_tpu_torch.config import ModelConfig
from mrisr_tpu_torch.data.synthetic import make_synthetic_store
from mrisr_tpu_torch.models import blocks, diffusion
from mrisr_tpu_torch.models.blocks import DoubleConv, set_compute_dtype
from mrisr_tpu_torch.models.deepcnn import ResidualBlock
from mrisr_tpu_torch.models.diffusion import DiffResBlock
from mrisr_tpu_torch.models.registry import create_model
from torch_port_util import jax_init, jit_exact, rel_l2

torch.set_num_threads(2)

FEAT, HW, B, TDIM = 4, 32, 4, 16
BF16 = torch.bfloat16
CARRY = {"unet_combined": unet_state_dict_from_flax,
         "unet_gan": unet_state_dict_from_flax,
         "patchgan": patchgan_state_dict_from_flax,
         "deepcnn": deepcnn_state_dict_from_flax,
         "progressive_unet": progressive_state_dict_from_flax,
         "fastddpm": fastddpm_state_dict_from_flax,
         "fastddpm_simple": simple_diffusion_state_dict_from_flax}
CHANNELS = {"patchgan": 3, "progressive_unet": 5, "fastddpm": 3,
            "fastddpm_simple": 3}


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def bf16_values(a: np.ndarray) -> np.ndarray:
    """float32 numpy rounded to bf16's values."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


# ------------------------------------------------------------ rounding points

# per block: bf16 elements that may differ from flax's (rare roundings of
# float32 sums taken in another order) and the rel-L2 they may add up to
MISMATCH_FRAC, BLOCK_RTOL = 2e-3, 1e-4


def _block_case(case):
    """(port block in bf16 compute, its args, train mode, flax bf16 output,
    flax float32 output) of one block on the same seeded input and
    weights; the flax outputs NHWC float32."""
    rng = np.random.default_rng(3)
    x = bf16_values(rng.standard_normal((2, 16, 16, 8)).astype(np.float32))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16)
    if case == "DiffResBlock":
        temb = bf16_values(rng.standard_normal((2, 16)).astype(np.float32))
        v = jax_init(jd.DiffResBlock(16), jnp.asarray(x), jnp.asarray(temb),
                     seed=3)
        want = jit_exact(jd.DiffResBlock(16, dtype=jnp.bfloat16).apply)(
            v, xb, jnp.asarray(temb).astype(jnp.bfloat16))
        ref = jd.DiffResBlock(16).apply(v, jnp.asarray(x), jnp.asarray(temb))
        port = DiffResBlock(8, 16, 16)
        port.load_state_dict(state_dict_from_layers(v, [
            ("gn", ("norm1",), "norm1"), ("conv", ("conv1",), "conv1"),
            ("dense", ("time_fc",), "time_fc"), ("gn", ("norm2",), "norm2"),
            ("conv", ("conv2",), "conv2"), ("conv", ("skip",), "skip")]))
        args = (xt, torch.from_numpy(temb).to(BF16))
        train = False
    else:
        train = case.endswith("train")
        if case.startswith("ResidualBlock"):
            jax_block, port = JaxResidualBlock, ResidualBlock(8, 16)
            layers = [(k, (f,), t) for k, f, t in (
                ("conv", "conv1", "conv1"), ("bn", "bn1", "bn1"),
                ("conv", "conv2", "conv2"), ("bn", "bn2", "bn2"),
                ("conv", "downsample_conv", "downsample.0"),
                ("bn", "downsample_bn", "downsample.1"))]
        else:
            jax_block, port = JaxDoubleConv, DoubleConv(8, 16)
            layers = [(k, (f,), t) for k, f, t in (
                ("conv", "Conv_0", "conv.0"), ("bn", "BatchNorm_0", "conv.1"),
                ("conv", "Conv_1", "conv.3"), ("bn", "BatchNorm_1", "conv.4"))]
        v = jax_init(jax_block(16), jnp.asarray(x), seed=4, train=False)
        want = jit_exact(lambda v, x: jax_block(16, dtype=jnp.bfloat16).apply(
            v, x, train=train, mutable=["batch_stats"])[0])(v, xb)
        ref = jax_block(16).apply(v, jnp.asarray(x), train=train,
                                  mutable=["batch_stats"])[0]
        port.load_state_dict(state_dict_from_layers(v, layers))
        args = (xt,)
    set_compute_dtype(port, BF16)
    return (port.train(train), args, np.asarray(want.astype(jnp.float32)),
            np.asarray(ref))


def _run(port, args) -> np.ndarray:
    """The block's output rounded to bf16 (where the next conv of an
    autocast program would round a float32 one), NHWC float32."""
    with torch.no_grad():
        return nhwc(port(*args).to(BF16))


# whether autocast's rounding points move the block's bf16 output: BN ->
# ReLU -> conv does not (rounding commutes with ReLU, and the conv rounds
# its input), a sum or a SiLU after a norm does
AUTOCAST_DIFFERS = {"DoubleConv-train": False, "ResidualBlock-eval": True,
                    "ResidualBlock-train": True, "DiffResBlock": True}


@pytest.mark.parametrize("case", list(AUTOCAST_DIFFERS))
def test_block_rounds_where_flax_does(case, monkeypatch):
    """BN -> ReLU (UNet), BN -> residual add (DeepCNN), GroupNorm -> SiLU
    and the time-embedding add (Fast-DDPM): at most 0.2 % of the bf16
    outputs differ from flax's, rel-L2 <= 1e-4, while the block's bf16
    output is 1e-3 or more from its float32 output.  The same block with
    autocast's rounding points (the norms return float32, SiLU and the adds
    after them run in float32, each conv rounds its input) differs from
    flax's in at least a tenth of its outputs where a sum or a SiLU
    follows a norm, and agrees as the port does in the BN -> ReLU block."""
    port, args, want, ref = _block_case(case)
    got = _run(port, args)
    assert got.shape == want.shape
    assert np.mean(got != want) <= MISMATCH_FRAC
    assert rel_l2(got, want) <= BLOCK_RTOL
    assert rel_l2(want, ref) >= 1e-3
    monkeypatch.setattr(blocks.BatchNorm2d, "forward",
                        lambda self, x: self._forward(x.float()))
    monkeypatch.setattr(blocks.GroupNorm, "forward",
                        lambda self, x: torch.nn.GroupNorm.forward(
                            self, x.float()))
    monkeypatch.setattr(diffusion, "silu", torch.nn.functional.silu)
    autocast_like = np.mean(_run(port, args) != want)
    if AUTOCAST_DIFFERS[case]:
        assert autocast_like >= 0.1
    else:
        assert autocast_like <= MISMATCH_FRAC


# ------------------------------------------------------------- eval forwards

# port-vs-flax rel-L2 of the bf16 eval forward, as a fraction of the flax
# module's own bf16-vs-float32 distance.  The BatchNorm models run their
# running statistics (no sums to reorder): the UNets, PatchGAN and the
# simple Fast-DDPM UNet give flax's bits; DeepCNN (measured 0.021) and the
# progressive stage-2 output (0.21) differ where a conv's float32
# accumulation order flips one rounding, which then travels.  Fast-DDPM's
# GroupNorms take batch statistics, whose float32 sums flip a few
# roundings in the first block that every later GroupNorm spreads
# (measured 0.60; rounding GroupNorm -> SiLU as autocast does: 0.89).
FWD_FRACTION = {"unet_combined": 0.05, "unet_gan": 0.05, "patchgan": 0.05,
                "fastddpm_simple": 0.05, "deepcnn": 0.1,
                "progressive_unet": 0.4, "fastddpm": 0.75}


def jax_model_cfg(name):
    base = JAX_PRESETS[name].model if name in JAX_PRESETS else (
        JAX_PRESETS["unet_gan"].model)
    return dataclasses.replace(base, base_features=FEAT,
                               **({"time_dim": TDIM} if name == "fastddpm"
                                  else {}))


def port_model_cfg(name) -> ModelConfig:
    return ModelConfig(**json.loads(json.dumps(dataclasses.asdict(
        jax_model_cfg(name)))))


@pytest.mark.parametrize("name", list(FWD_FRACTION))
def test_bf16_forward_matches_jax(name):
    jcfg = jax_model_cfg(name)
    j16 = jax_create_model(name, jcfg, jnp.bfloat16)[0]
    j32 = jax_create_model(name, jcfg)[0]
    x = np.random.default_rng(5).standard_normal(
        (2, HW, HW, CHANNELS.get(name, 2))).astype(np.float32)
    diffusion = name.startswith("fastddpm")
    t = np.array([3, 7] if name == "fastddpm_simple" else [3, 700], np.int32)
    args = (jnp.asarray(x), jnp.asarray(t)) if diffusion else (jnp.asarray(x),)
    kw = {} if diffusion else {"train": False}
    v = jax_init(j32, *args, seed=1, **kw)

    def outs(y):
        return [np.asarray(a) for a in (y if isinstance(y, tuple) else (y,))]

    want = outs(jit_exact(lambda v, *a: j16.apply(v, *a, **kw))(v, *args))
    ref = outs(jax.jit(lambda v, *a: j32.apply(v, *a, **kw))(v, *args))
    port = create_model(name, port_model_cfg(name), BF16)
    port.load_state_dict(CARRY[name](v), strict=True)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    targs = ((torch.from_numpy(x), torch.from_numpy(t).long()) if diffusion
             else (torch.from_numpy(x),))
    with torch.no_grad():
        got = port.eval()(*targs)
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    for g, w, r in zip(got, want, ref):
        assert g.shape == w.shape and g.dtype == np.float32
        bf16_dist = rel_l2(w, r)
        assert bf16_dist >= 1e-3
        assert rel_l2(g, w) <= FWD_FRACTION[name] * bf16_dist, name


# ----------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("bf16store")
    make_synthetic_store(str(d), num_patients=8, slices_per_volume=10,
                         height=HW, width=HW)
    return d


def cli_train(store, workdir, preset, *extra):
    return ["train", "--preset", preset, "--data", str(store), "--device",
            "cpu", "--features", str(FEAT), "--image-size", str(HW),
            "--batch-size", str(B), "--checkpoint-dir",
            str(workdir / "models"), "--results-dir",
            str(workdir / "results"), "--bf16", *extra]


@pytest.mark.parametrize("preset", ["unet_combined", "unet_gan", "deepcnn",
                                    "progressive_unet", "fastddpm",
                                    "fastddpm_simple"])
def test_cli_train_bf16_every_family(store, tmp_path, preset):
    """``train --bf16`` builds the preset's models in bf16 compute: one
    epoch on the CPU, finite losses, a float32 checkpoint that
    ``load_model`` reads (its eval forward is the float32 one, as in the
    JAX package)."""
    trainer = cli.main(cli_train(store, tmp_path, preset, "--epochs", "1"))
    assert trainer.config.train.compute_dtype == "bfloat16"
    states = ([trainer.g_state, trainer.d_state] if preset == "unet_gan"
              else [trainer.state])
    for st in states:
        convs = [m for m in st.module.modules()
                 if isinstance(m, torch.nn.Conv2d)]
        assert convs and all(m.compute_dtype == BF16 for m in convs)
    assert all(np.isfinite(trainer.history.series["train_loss"]))
    ckpt = torch.load(tmp_path / "models" / f"{preset}_best.pt",
                      weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt.get("generator_state_dict"))
    assert all(v.dtype == torch.float32 for k, v in sd.items()
               if "num_batches" not in k)
    loaded = load_model(preset, str(tmp_path / "models"),
                        checkpoint="required", cfg=trainer.config.model,
                        device="cpu")
    assert all(getattr(m, "compute_dtype", None) is None
               for m in loaded.module.modules())


def test_cli_train_bf16_resume(store, tmp_path, capsys):
    """Two bf16 epochs, then ``--resume`` to three: the resumed run starts
    at epoch 3 from the bf16 run's float32 state and keeps its history."""
    first = cli.main(cli_train(store, tmp_path, "unet_combined",
                               "--epochs", "2"))
    losses = first.history.series["train_loss"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    capsys.readouterr()
    again = cli.main(cli_train(store, tmp_path, "unet_combined",
                               "--epochs", "3", "--resume"))
    assert "resumed from epoch 2" in capsys.readouterr().out
    assert again.start_epoch == 3
    assert again.state.module.final.compute_dtype == BF16
    hist = json.loads((tmp_path / "results" / "unet_combined_history.json")
                      .read_text())
    assert hist["epoch"] == [1.0, 2.0, 3.0]
    assert hist["train_loss"][:2] == losses
    assert hist["config"]["train"]["compute_dtype"] == "bfloat16"
