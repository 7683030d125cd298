"""The JAX package's Orbax checkpoints in the port (CPU): written with
``mrisr_tpu.ckpt.save_checkpoint`` from seeded flax variables for every
eval family (the GAN's two-network layout and a step-distilled student
with its grid among them) and by a tiny JAX ``cli train`` run, converted by
``tools/orbax_to_torch.py``, then loaded by both packages' ``load_model``
and evaluated by both CLIs.  A missing or stale conversion raises naming
the tool."""

import contextlib
import importlib.util
import io
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu import cli as jax_cli
from mrisr_tpu.api import load_model as jax_load_model
from mrisr_tpu.ckpt import save_checkpoint
from mrisr_tpu.config import ModelConfig as JaxModelConfig
from mrisr_tpu.models.registry import create_model as jax_create_model
from mrisr_tpu_torch import cli
from mrisr_tpu_torch.api import load_model
from mrisr_tpu_torch.ckpt.torch_ckpt import orbax_record, reference_checkpoint
from mrisr_tpu_torch.config import ModelConfig
from mrisr_tpu_torch.data.synthetic import make_synthetic_store
from mrisr_tpu_torch.models import UNet
from torch_port_util import jax_init_model_jitted, jax_seeded_variables, noise

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TOOL = ROOT / "tools" / "orbax_to_torch.py"
_spec = importlib.util.spec_from_file_location("orbax_to_torch", TOOL)
orbax_to_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(orbax_to_torch)
F, HW, CLI_HW = 8, 32, 16
GRID = [0, 199, 499, 799, 999]
# load_model name -> its flax family (what the directory's weights are)
FAMILY = {"unet": "unet", "unet_gan": "unet_gan", "deepcnn": "deepcnn",
          "progressive_unet": "progressive_unet", "fastddpm": "fastddpm",
          "fastddpm_simple": "fastddpm_simple", "fastddpm_steps5": "fastddpm"}
# the port's forward against the JAX package's on the same weights: the
# forward-parity bound (tests/test_torch_port_unet.py), rel 1e-5 beside it
RTOL, ATOL = 1e-5, 1e-4


def _jax_inputs(family, batch=1, seed=0):
    channels = {"progressive_unet": 5, "fastddpm": 3, "fastddpm_simple": 3,
                "patchgan": 3}.get(family, 2)
    x = noise((batch, HW, HW, channels), seed=seed)
    if family.startswith("fastddpm"):
        return [x, (np.arange(batch, dtype=np.int32) * 97 + 3) % 1000]
    return [x]


def _flax_model(family, feat=F):
    return jax_create_model(family, JaxModelConfig(name=family,
                                                   base_features=feat))[0]


def _init_kw(family):
    return {} if family.startswith("fastddpm") else {"train": False}


def _variables(family, seed):
    """Seeded flax variables of ``family`` at width F as numpy."""
    return jax_seeded_variables(
        _flax_model(family), *(jnp.asarray(a) for a in _jax_inputs(family)),
        seed=seed, **_init_kw(family))


def jax_init_model_abstract(name, cfg=None, dtype=jnp.float32,
                            image_size=(256, 256), seed: int = 0):
    """The JAX ``load_model``'s init, abstract: it reads a checkpoint over
    the variables it inits, so only their shapes are needed."""
    del dtype, image_size, seed
    model, kind = jax_create_model(name, cfg)
    shapes = jax.eval_shape(lambda *x: model.init(
        jax.random.PRNGKey(0), *x, **_init_kw(name)),
        *(jnp.asarray(a) for a in _jax_inputs(name)))
    return model, shapes, kind


def _save(models_dir, name, seed):
    """``<name>_best`` as the JAX trainers lay it out (the GAN's under
    'generator' beside its discriminator)."""
    state = {**_variables(FAMILY[name], seed), "epoch": 3}
    if name == "unet_gan":
        state = {"generator": state,
                 "discriminator": {**_variables("patchgan", seed + 50),
                                   "epoch": 3}}
    save_checkpoint(str(models_dir / f"{name}_best"), state)


@pytest.fixture(scope="module", autouse=True)
def quick_jax_init():
    """The JAX package's ``load_model`` and trainer init with its
    registry's ``init_model`` (eager, half a minute on the CPU): the
    trainer's jitted here (the same variables), ``load_model``'s abstract
    (it loads a checkpoint over them)."""
    import mrisr_tpu.api as japi
    import mrisr_tpu.train.trainer as jtrainer

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "init_model", jax_init_model_abstract)
        mp.setattr(jtrainer, "init_model", jax_init_model_jitted)
        yield


@pytest.fixture(scope="module")
def orbax(tmp_path_factory):
    """Orbax checkpoints of every eval family and a step-distilled student
    (``models``), a JAX ``cli train`` run's (``trained``), and the store;
    all converted by one run of the tool."""
    w = tmp_path_factory.mktemp("orbax")
    models = w / "models"
    models.mkdir()
    for seed, name in enumerate(FAMILY):
        _save(models, name, seed)
    (models / "fastddpm_steps5_grid.json").write_text(json.dumps(
        {"base": "fastddpm", "factor": 2, "timesteps": GRID}))
    store = str(w / "store")
    make_synthetic_store(store, num_patients=8, slices_per_volume=8,
                         height=CLI_HW, width=CLI_HW)
    trained = w / "trained"
    jax_cli.main(["train", "--preset", "unet", "--data", store,
                  "--features", "4", "--image-size", str(CLI_HW),
                  "--batch-size", "4", "--epochs", "1",
                  "--checkpoint-dir", str(trained), "--results-dir",
                  str(w / "train_results")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert orbax_to_torch.main(["--models-dir", str(models),
                                    str(trained / "unet_best")]) == 0
    return {"w": w, "models": models, "trained": trained, "store": store,
            "tool_out": out.getvalue()}


def test_tool_converts_every_best(orbax):
    """``--models-dir`` converts each ``*_best`` (the student's too), and
    each conversion records its directory."""
    models = orbax["models"]
    for name in FAMILY:
        d = models / f"{name}_best"
        ckpt = torch.load(str(d) + ".pt", weights_only=True)
        assert ckpt["orbax"] == orbax_record(str(d)), name
        assert ckpt["orbax"]["dir"] == f"{name}_best"
        assert f"{d} -> {d}.pt" in orbax["tool_out"]
    # the JAX trainer's other directories were not asked for
    assert not (orbax["trained"] / "unet_latest.pt").exists()
    assert (orbax["trained"] / "unet_best.pt").exists()


def _jax_forward(loaded, family, ins):
    """The loaded flax module's eval forward, jitted."""
    kw = _init_kw(family)
    return jax.jit(lambda v, *x: loaded.module.apply(v, *x, **kw))(
        loaded.variables, *ins)


@pytest.mark.parametrize("name", [*FAMILY, "trained unet"])
def test_converted_checkpoint_forward_matches_jax(orbax, name):
    """Each family's ``load_model`` through the conversion against the JAX
    package's ``load_model`` of the Orbax directory: the same forward
    (the denoiser at given timesteps for the diffusion models) within rel
    1e-5 / atol 1e-4; the student keeps its grid and DDIM sampler."""
    if name == "trained unet":
        name, models, feat = "unet", orbax["trained"], 4
    else:
        models, feat = orbax["models"], F
    family = FAMILY[name]
    base = "fastddpm" if name == "fastddpm_steps5" else name
    mcfg = ModelConfig(name=base, base_features=feat)
    got = load_model(name, str(models), checkpoint="required", cfg=mcfg,
                     device="cpu")
    want = jax_load_model(name, str(models), cfg=JaxModelConfig(
        name=base, base_features=feat), image_size=(HW, HW))
    ins = _jax_inputs(family, batch=2, seed=7)
    y_want = _jax_forward(want, family, [jnp.asarray(a) for a in ins])
    with torch.no_grad():
        y_got = got.module(*(torch.from_numpy(a) for a in ins))
    y_got = y_got if isinstance(y_got, tuple) else (y_got,)
    y_want = y_want if isinstance(y_want, tuple) else (y_want,)
    assert len(y_got) == len(y_want)
    for g, j in zip(y_got, y_want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)
    if name == "fastddpm_steps5":
        assert got.sampler == want.sampler == "ddim_grid"
        assert got.schedule.timesteps.tolist() == GRID == [
            int(t) for t in want.schedule.timesteps]


def test_cli_eval_of_jax_trained_checkpoint_matches_jax(orbax):
    """``eval --model unet`` of the JAX ``cli train`` run's Orbax
    checkpoint: the port's JSON equals the JAX CLI's (SSIM within 3e-5,
    the rest within 1e-3: ``tests/test_torch_port_cli.py``'s bounds)."""
    w = orbax["w"]
    args = ["eval", "--model", "unet", "--data", orbax["store"],
            "--image-size", str(CLI_HW), "--features", "4", "--batch-size",
            "4", "--checkpoint-dir", str(orbax["trained"])]
    jax_cli.main([*args, "--results-dir", str(w / "jax_eval")])
    cli.main([*args, "--results-dir", str(w / "eval"), "--device", "cpu"])
    got = json.loads((w / "eval" / "unet_test_metrics.json").read_text())
    want = json.loads((w / "jax_eval" / "unet_test_metrics.json")
                      .read_text())
    assert set(got) == set(want) == {"3mm", "6mm"}
    for label in want:
        assert set(got[label]) == set(want[label])
        for k, v in want[label].items():
            tol = 3e-5 if k.startswith("ssim") else 1e-3
            assert got[label][k] == pytest.approx(v, abs=tol), (label, k)


def test_missing_or_stale_conversion_raises_naming_the_tool(orbax, tmp_path):
    """No ``D.pt``, a ``D.pt`` from an earlier save of ``D`` (stale), or a
    port-trained ``<name>_best.pt`` beside a JAX-trained ``<name>_best/``:
    each raises with the tool's command, for the plain and the explicit
    path and for a step-distilled student; converting again loads."""
    mcfg = ModelConfig(base_features=F)
    d = tmp_path / "unet_best"
    shutil.copytree(orbax["models"] / "unet_best", d)
    command = f"python tools/orbax_to_torch.py {d} --model unet"

    def refused(match, **kw):
        with pytest.raises(NotImplementedError, match=match) as e:
            load_model("unet", str(tmp_path), cfg=mcfg, device="cpu", **kw)
        assert command in str(e.value)

    refused("missing")
    refused("missing", checkpoint=str(d))
    # a port-trained unet_best.pt: not a conversion of the directory
    torch.save(reference_checkpoint(UNet(features=F), "unet"),
               str(d) + ".pt")
    refused("records no Orbax")
    orbax_to_torch.convert(str(d))
    load_model("unet", str(tmp_path), cfg=mcfg, device="cpu")
    # the directory saved again after its conversion
    save_checkpoint(str(d), {**_variables("unet", 11), "epoch": 4})
    refused("stale")
    refused("stale", checkpoint="required")
    orbax_to_torch.convert(str(d))
    got = load_model("unet", str(tmp_path), cfg=mcfg, device="cpu")
    want = jax_load_model("unet", str(tmp_path), cfg=JaxModelConfig(
        base_features=F), image_size=(HW, HW))
    _assert_forward_matches_jax(got, want)
    # a step-distilled student's Orbax directory without its conversion
    s = tmp_path / "fastddpm_steps5_best"
    shutil.copytree(orbax["models"] / "fastddpm_steps5_best", s)
    shutil.copy(orbax["models"] / "fastddpm_steps5_grid.json", tmp_path)
    with pytest.raises(NotImplementedError) as e:
        load_model("fastddpm_steps5", str(tmp_path), device="cpu",
                   cfg=ModelConfig(name="fastddpm", base_features=F))
    assert (f"python tools/orbax_to_torch.py {s} --model fastddpm_steps5"
            in str(e.value))


def _assert_forward_matches_jax(got, want):
    x = noise((1, HW, HW, 2), seed=3)
    np.testing.assert_allclose(
        got.predict_nhwc(torch.from_numpy(x)).numpy(),
        np.asarray(_jax_forward(want, "unet", [jnp.asarray(x)])),
        rtol=RTOL, atol=ATOL)


def test_explicit_directory_of_any_name(orbax, tmp_path):
    """An Orbax directory whose name names no family (``runs/exp42``),
    passed as ``checkpoint=``, as the JAX ``load_model`` reads it: the
    port raises with the tool's command and the model's name; the tool
    refuses the directory's name alone and converts it with ``--model``;
    the forward then equals the JAX package's (rel 1e-5 / atol 1e-4)."""
    d = tmp_path / "runs" / "exp42"
    shutil.copytree(orbax["models"] / "unet_best", d)
    mcfg = ModelConfig(base_features=F)
    with pytest.raises(NotImplementedError, match="missing") as e:
        load_model("unet", checkpoint=str(d), cfg=mcfg, device="cpu")
    assert f"python tools/orbax_to_torch.py {d} --model unet" in str(e.value)
    with pytest.raises(ValueError, match="--model"):
        orbax_to_torch.convert(str(d))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert orbax_to_torch.main([str(d), "--model", "unet"]) == 0
    assert f"{d} -> {d}.pt" in out.getvalue()
    got = load_model("unet", checkpoint=str(d), cfg=mcfg, device="cpu")
    want = jax_load_model("unet", checkpoint=str(d), cfg=JaxModelConfig(
        base_features=F), image_size=(HW, HW))
    _assert_forward_matches_jax(got, want)


def test_directory_without_metadata_is_refused(orbax, tmp_path):
    """Without Orbax's ``_CHECKPOINT_METADATA`` a conversion could not be
    told from a stale one: the tool refuses the directory, and a ``D.pt``
    whose record holds no hash does not load."""
    d = tmp_path / "unet_best"
    shutil.copytree(orbax["models"] / "unet_best", d)
    (d / "_CHECKPOINT_METADATA").unlink()
    with pytest.raises(ValueError, match="_CHECKPOINT_METADATA"):
        orbax_to_torch.convert(str(d))
    assert not (tmp_path / "unet_best.pt").exists()
    assert orbax_record(str(d)) == {"dir": "unet_best", "sha256": None}
    ckpt = torch.load(str(orbax["models"] / "unet_best") + ".pt",
                      weights_only=True)
    torch.save({**ckpt, "orbax": orbax_record(str(d))}, str(d) + ".pt")
    with pytest.raises(NotImplementedError,
                       match="records no hash of its metadata"):
        load_model("unet", str(tmp_path), cfg=ModelConfig(base_features=F),
                   device="cpu")
