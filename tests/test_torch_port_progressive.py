"""The port's DeepCNN and Progressive UNet against mrisr_tpu's (CPU,
FEAT = 4, 32^2, batch 4): parameter counts at the presets' width, the eval
forward from the same weights, one train step against the JAX package's
unjitted step (loss, gradients, parameters, BatchNorm running statistics),
DeepCNN's kaiming fan-out initialization, and the trained checkpoint read
back by the JAX package's converter and by ``load_model``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.ckpt import convert_torch_checkpoint
from mrisr_tpu.config import PRESETS as JAX_PRESETS
from mrisr_tpu.losses import mse as jax_mse
from mrisr_tpu.losses import progressive_loss as jax_progressive_loss
from mrisr_tpu.models.registry import create_model as jax_create_model
from mrisr_tpu.train.state import create_train_state as jax_train_state
from mrisr_tpu.train.state import make_optimizer as jax_make_optimizer
from mrisr_tpu.train.steps import make_progressive_steps as jax_prog_steps
from mrisr_tpu.train.steps import make_supervised_steps as jax_sup_steps
from mrisr_tpu_torch.api import load_model
from mrisr_tpu_torch.ckpt.from_jax import (
    deepcnn_state_dict_from_flax,
    progressive_state_dict_from_flax,
)
from mrisr_tpu_torch.config import Config
from mrisr_tpu_torch.data.pipeline import build_loader
from mrisr_tpu_torch.data.synthetic import make_synthetic_store
from mrisr_tpu_torch.models.deepcnn import DeepCNN
from mrisr_tpu_torch.models.progressive import ProgressiveUNet
from mrisr_tpu_torch.models.registry import init_model
from mrisr_tpu_torch.train import SupervisedTrainer
from torch_port_util import adam_mu, check_updated, jax_init, rel_l2

torch.set_num_threads(2)

FEAT, HW, B = 4, 32, 4
CARRY = {"deepcnn": deepcnn_state_dict_from_flax,
         "progressive_unet": progressive_state_dict_from_flax}
CHANNELS = {"deepcnn": 2, "progressive_unet": 5}


def jax_config(preset):
    base = JAX_PRESETS[preset]
    return dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, image_size=(HW, HW), batch_size=B,
                                 augment=False),
        model=dataclasses.replace(base.model, base_features=FEAT))


def port_config(jcfg, tmp) -> Config:
    import json

    cfg = Config.from_dict(json.loads(jcfg.to_json()))
    return cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=os.path.join(tmp, "models"),
        results_dir=os.path.join(tmp, "results")))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("store")
    return make_synthetic_store(str(d), num_patients=8, slices_per_volume=10,
                                height=HW, width=HW)


@pytest.fixture(scope="module", params=["deepcnn", "progressive_unet"])
def family(request):
    """The JAX model at FEAT 4 with seeded, perturbed variables and the
    port module carrying them."""
    preset = request.param
    jcfg = jax_config(preset)
    model, kind = jax_create_model(preset, jcfg.model)
    x0 = jnp.zeros((1, HW, HW, CHANNELS[preset]))
    v = jax_init(model, x0, seed=1, train=False)
    return {"preset": preset, "jcfg": jcfg, "model": model, "kind": kind,
            "v": v, "carry": CARRY[preset]}


def batch_for(preset, seed=0):
    c = 3 if preset == "deepcnn" else 5
    return np.random.default_rng(seed).standard_normal(
        (B, HW, HW, c)).astype(np.float32)


@pytest.mark.parametrize("name,module,want", [
    ("deepcnn", lambda: DeepCNN(), 11_173_889),
    ("progressive_unet", lambda: ProgressiveUNet(), 93_111_171)])
def test_param_count_at_preset_width(name, module, want):
    """The JAX package's counts (``tests/test_models.py`` pins them), from
    the modules as built."""
    assert sum(p.numel() for p in module().parameters()) == want
    assert init_model(name)[0].state_dict().keys() == module(
        ).state_dict().keys()


def test_eval_forward_matches_jax(family):
    port = init_model(family["preset"], port_config(
        family["jcfg"], "/nonexistent").model)[0]
    port.load_state_dict(family["carry"](family["v"]), strict=True)
    x = batch_for(family["preset"], seed=2)
    x = x[..., :2] if family["preset"] == "deepcnn" else x
    want = family["model"].apply(family["v"], jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.eval()(torch.tensor(x))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape
        assert rel_l2(g.numpy(), w) <= 1e-5


def test_one_train_step_matches_jax(family, store, tmp_path):
    """One train step on a store batch from the same weights.  DeepCNN's
    runs in float64 on both sides: at FEAT 4 its loss starts near 113
    (kaiming fan-out init), and float32 rounding alone then moves its
    shallow BatchNorm gradients by up to 6.5e-4 rel-L2, in either framework
    (each float32 step against the port's float64 step), past the 1e-4
    bound; in float64 the two agree to 1e-7."""
    preset, jcfg = family["preset"], family["jcfg"]
    dtype = np.float64 if preset == "deepcnn" else np.float32
    kind = "window" if family["kind"] == "window" else "triplet"
    batch = next(iter(build_loader(store, "train", port_config(
        jcfg, str(tmp_path)).data, kind=kind, device="cpu"))).numpy()
    with jax.enable_x64(dtype == np.float64):
        model, _ = jax_create_model(preset, jcfg.model, dtype=dtype)
        if family["kind"] == "window":
            lc = jcfg.loss
            raw, _ = jax_prog_steps(lambda p, w: jax_progressive_loss(
                p, w, lc.w_i1, lc.w_i2, lc.w_i3), jit_steps=False)
        else:
            raw, _ = jax_sup_steps(lambda p, t: (jax_mse(p, t), {}),
                                   jit_steps=False)
        v = jax.tree.map(lambda a: jnp.asarray(a, dtype), family["v"])
        state = jax_train_state(model, v, jax_make_optimizer(jcfg.train))
        state1, metrics = jax.jit(raw)(state, jnp.asarray(batch, dtype))
        new = jax.tree.map(np.asarray, {"params": state1.params,
                                        "batch_stats": state1.batch_stats})
        grads = {"params": jax.tree.map(lambda m: np.asarray(m) / 0.1,
                                        adam_mu(state1.opt_state)),
                 "batch_stats": new["batch_stats"]}
        metrics = {k: float(v) for k, v in metrics.items()}

    tr = SupervisedTrainer(port_config(jcfg, str(tmp_path)), device="cpu")
    module = tr.state.module
    module.load_state_dict(family["carry"](family["v"]), strict=True)
    if dtype == np.float64:
        module.double()
    x = torch.tensor(batch).to(next(module.parameters()).dtype)
    _, got = tr.train_step(tr.state, x)
    for k, want in metrics.items():
        assert float(got[k]) == pytest.approx(want, rel=1e-5), k
    check_updated(module, family["carry"](grads), family["carry"](new),
                  jcfg.train.learning_rate)


def test_checkpoint_converts_and_loads(family, tmp_path):
    """The port trainer's ``<preset>_best.pt`` through the JAX package's
    torch converter gives the JAX forward the port's forward, and
    ``load_model`` reads it back weights-only."""
    preset = family["preset"]
    cfg = port_config(family["jcfg"], str(tmp_path))
    tr = SupervisedTrainer(cfg, device="cpu")
    tr.state.module.load_state_dict(family["carry"](family["v"]), strict=True)
    path = os.path.join(cfg.train.checkpoint_dir, f"{preset}_best.pt")
    tr.save(path, epoch=1, best_loss=0.5, val_loss=0.5)
    ckpt = torch.load(path, weights_only=True)
    jv = convert_torch_checkpoint(preset, ckpt)
    x = batch_for(preset, seed=3)
    x = x[..., :2] if preset == "deepcnn" else x
    want = family["model"].apply(jax.tree.map(jnp.asarray, jv),
                                 jnp.asarray(x), train=False)
    got = tr.predict(torch.tensor(x))
    loaded = load_model(preset, cfg.train.checkpoint_dir,
                        checkpoint="required", cfg=cfg.model, device="cpu")
    again = loaded.predict_nhwc(torch.tensor(x))
    for g, w, a in zip(*(o if isinstance(o, tuple) else (o,)
                         for o in (got, want, again))):
        assert rel_l2(g.numpy(), w) <= 1e-5
        torch.testing.assert_close(a, g, rtol=0, atol=0)
    assert loaded.kind == family["kind"]


def test_deepcnn_init_is_kaiming_fan_out():
    """DeepCNN's convs: a plain normal of variance 2 / (kh kw C_out),
    biases 0; BatchNorm at scale 1, shift 0, statistics 0 / 1."""
    model, kind = init_model("deepcnn", Config().model.__class__(
        name="deepcnn", base_features=16), seed=5)
    assert kind == "pair"
    checked = 0
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert torch.all(m.weight == 1) and torch.all(m.bias == 0), name
            continue
        if not isinstance(m, torch.nn.Conv2d):
            continue
        w = m.weight.detach().double()
        fan_out = w.shape[0] * w.shape[2] * w.shape[3]
        if m.bias is not None:
            assert torch.all(m.bias == 0), name
        if w.numel() >= 4096:
            assert float(w.var()) == pytest.approx(2.0 / fan_out, rel=0.1), name
            # untruncated: a normal reaches past 2 sigma
            assert float(w.abs().max()) > 2.5 * (2.0 / fan_out) ** 0.5, name
            checked += 1
    assert checked >= 8
