"""The pair UNet's remaining serving paths in the port against mrisr_tpu's
(CPU, FEAT 4, 32^2): ``unet_int8_apply`` (kernel A's float epilogue at
every 3x3 conv, bf16 between), the pre-r3 int8_fused fallback, the
``quant='none'`` (bf16 compute) and ``quant='int8'`` bundles written by
each package and served by the other, ``export-serving --quant none|int8``
and ``engine_from_model`` in its three modes.  Kernel A's plain version
runs here; the card runs the kernel (``tests/test_torch_port_cuda.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.api import load_model as jax_load_model
from mrisr_tpu.ckpt.fold_bn import fold_unet_batchnorm as jax_fold
from mrisr_tpu.config import ModelConfig as JaxModelConfig
from mrisr_tpu.models import UNet as JaxUNet
from mrisr_tpu.serve import bundle as jb
from mrisr_tpu.serve import engine as je
from mrisr_tpu.serve import quant as jq
from mrisr_tpu_torch import cli
from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
from mrisr_tpu_torch.config import ModelConfig
from mrisr_tpu_torch.data.synthetic import make_synthetic_store
from mrisr_tpu_torch.serve import (
    Int8UNet,
    engine_from_bundle,
    engine_from_model,
    load_bundle,
    make_bundle_apply,
    unet_int8_apply,
    unet_int8_fused_apply,
)
from torch_port_util import (
    jax_unet_variables,
    noise,
    port_unet,
    rel_l2,
    to_torch_tree,
)

torch.set_num_threads(2)

F, HW = 4, 32
# two jitted bf16 programs of the same module (XLA keeps fused
# intermediates in float32) agree to bf16 noise: the bound of
# tests/test_bundle.py:72
BF16_ATOL = 2e-2
# the int8 error budget against the folded float forward
# (tests/test_quant.py:68,114)
INT8_VS_FLOAT = 0.15


@pytest.fixture(scope="module")
def tables():
    v = jax_unet_variables(F, HW, seed=31)
    folded = jax.tree.map(np.asarray, jax_fold(v["params"], v["batch_stats"]))
    x = noise((4, HW, HW, 2), seed=32)
    calib = jq.calibrate_unet(folded, [jnp.asarray(x)], dtype=jnp.float32)
    legacy = {k: c for k, c in calib.items()
              if not (k.startswith("upconv") or k == "final")}
    model = port_unet(folded, F)
    with torch.no_grad():
        y_float = model(torch.from_numpy(x)).numpy()
    return {"folded": folded, "x": x, "y_float": y_float,
            "q": jq.quantize_unet(folded, calib),
            "q_legacy": jq.quantize_unet(folded, legacy)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_unet_int8_apply_matches_jax(tables, dtype):
    """The same tables through both packages' ``unet_int8_apply`` (as
    ``tests/test_quant.py:59,98`` call it): the same bits in bf16, float32
    roundings apart in float32, and within the int8 budget of float."""
    x = tables["x"]
    want = np.asarray(jax.jit(lambda p, b: jq.unet_int8_apply(
        p, b, dtype=getattr(jnp, dtype)))(tables["q"], jnp.asarray(x)))
    got = unet_int8_apply(to_torch_tree(tables["q"]), torch.from_numpy(x),
                          dtype=getattr(torch, dtype))
    assert got.shape == (4, HW, HW, 1) and got.dtype == torch.float32
    assert rel_l2(got.numpy(), want) <= (0.0 if dtype == "bfloat16"
                                         else 1e-6)
    assert rel_l2(got.numpy(), tables["y_float"]) < INT8_VS_FLOAT
    plain = Int8UNet(to_torch_tree(tables["q"]), getattr(torch, dtype),
                     device="cpu", plain=True)(torch.from_numpy(x))
    assert torch.equal(plain, got)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_legacy_fallback_matches_jax(tables, dtype):
    """Pre-r3 tables (``tests/test_quant.py:144-160, 244-250``): the default
    skip emission degrades to 'dual' and the output is the JAX package's
    (the same bits in bf16); an explicit 'shared' raises its ValueError."""
    x = tables["x"]
    q = to_torch_tree(tables["q_legacy"])
    assert "w_int8" not in q["upconv1"]
    want = np.asarray(jax.jit(lambda p, b: jq.unet_int8_fused_apply(
        p, b, dtype=getattr(jnp, dtype)))(tables["q_legacy"],
                                           jnp.asarray(x)))
    got = unet_int8_fused_apply(q, torch.from_numpy(x),
                                dtype=getattr(torch, dtype))
    assert rel_l2(got.numpy(), want) <= (0.0 if dtype == "bfloat16"
                                         else 1e-6)
    assert rel_l2(got.numpy(), tables["y_float"]) < INT8_VS_FLOAT
    dual = unet_int8_fused_apply(q, torch.from_numpy(x), skip_emit="dual",
                                 dtype=getattr(torch, dtype))
    assert torch.equal(dual, got)
    with pytest.raises(ValueError, match="full int8 tables"):
        jq.unet_int8_fused_apply(tables["q_legacy"], jnp.asarray(x),
                                 skip_emit="shared")
    with pytest.raises(ValueError, match="full int8 tables"):
        unet_int8_fused_apply(q, torch.from_numpy(x), skip_emit="shared")


def jax_pair_forward(params, quant, x):
    """The JAX package's forward of a pair bundle's tables run op by op
    (eager), each op rounded as the code writes it.  A jitted program
    rounds elsewhere: its fusions keep bf16 intermediates in float32, and
    its final bf16 1x1 conv moved the served output 0.58 % on inputs past
    the calibration range, where the eager conv is the exactly rounded
    one."""
    if quant == "int8":
        return np.asarray(jq.unet_int8_apply(params, jnp.asarray(x)))
    module = JaxUNet(features=F, use_bn=False, dtype=jnp.bfloat16)
    return np.asarray(module.apply(params, jnp.asarray(x), train=False))


def jax_bundle_forward(path, x):
    params, meta = jb.load_bundle(path)
    return jax_pair_forward(params, meta["quant"], x)


def _bf16_tree(folded):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16)
                        if a.dtype == np.float32 else a, folded)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_jax_bundle_serves_in_port(tables, tmp_path, quant):
    """A bundle the JAX package writes serves in the port with the bits of
    the JAX forward of its tables run op by op, and within bf16 noise of
    the JAX package's own (jitted) bundle forward."""
    x = tables["x"]
    tree = tables["q"] if quant == "int8" else _bf16_tree(tables["folded"])
    path = jb.save_bundle(str(tmp_path / "b"), tree, model_name="unet",
                          quant=quant, base_features=F, image_size=(HW, HW))
    with engine_from_bundle(path, batch_size=2, device="cpu") as eng:
        got = np.stack(eng.predict_many(list(x)))
    assert got.shape == (4, HW, HW, 1)
    assert rel_l2(got, jax_bundle_forward(path, x)) == 0.0
    want = np.asarray(jb.make_bundle_apply(*jb.load_bundle(path))(
        jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    assert rel_l2(got, tables["y_float"]) < (INT8_VS_FLOAT if quant == "int8"
                                             else 0.05)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A reference-layout ``unet_best.pt`` (non-trivial BN statistics) both
    packages load, and a store for the CLI's calibration batches."""
    w = tmp_path_factory.mktemp("pair")
    v = jax_unet_variables(F, HW, seed=33)
    module = port_unet(v, F)
    os.makedirs(w / "models")
    torch.save(reference_checkpoint(module, "unet"), w / "models" /
               "unet_best.pt")
    make_synthetic_store(str(w / "store"), num_patients=8,
                         slices_per_volume=8, height=HW, width=HW)
    return w


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cli_export_serving_pair_bundle_serves_in_jax(checkpoint, tmp_path,
                                                      quant):
    """``export-serving --quant none|int8`` of a pair checkpoint (``--bf16``
    taken and changing nothing, as in the JAX CLI): a bundle in the
    reference's format (a bf16 folded tree, or the int8 tables) that the
    JAX package loads and serves as the port serves it."""
    out = str(tmp_path / "bundle")
    cli.main(["export-serving", "--model", "unet", "--quant", quant,
              "--data", str(checkpoint / "store"), "--image-size", str(HW),
              "--features", str(F), "--batch-size", "4", "--calib-batches",
              "2", "--checkpoint-dir", str(checkpoint / "models"),
              "--device", "cpu", "--out", out, "--bf16"])
    params, meta = jb.load_bundle(out)
    assert meta["quant"] == quant and meta["base_features"] == F
    if quant == "none":
        assert meta["calibration"] is None
        assert set(params) == {"params"}
        assert params["params"]["enc1"]["Conv_0"]["kernel"].dtype == (
            jnp.bfloat16)
        # the JAX package's export of the same checkpoint: the same tree
        ref = jb.export_serving_bundle(
            str(tmp_path / "jax_bundle"), "unet", str(checkpoint / "models"),
            quant="none", cfg=JaxModelConfig(base_features=F),
            image_size=(HW, HW))
        ref_params = jb.load_bundle(ref)[0]
        for got, want in zip(jax.tree.leaves(params),
                             jax.tree.leaves(ref_params)):
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_allclose(np.asarray(got, np.float32),
                                       np.asarray(want, np.float32),
                                       rtol=2 ** -8, atol=0)
    x = noise((4, HW, HW, 2), seed=34)
    got = make_bundle_apply(*load_bundle(out), device="cpu")(
        torch.from_numpy(x)).numpy()
    assert rel_l2(got, jax_bundle_forward(out, x)) == 0.0
    want = np.asarray(jb.make_bundle_apply(params, meta)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("quant", ["none", "int8", "int8_fused"])
def test_engine_from_model_matches_jax(checkpoint, quant):
    """``engine_from_model`` on the same checkpoint in both packages
    (``tests/test_serve.py:108-170``, one device).  'none' is float32
    arithmetic over bf16-rounded folded weights in both (the port with
    TF32 off): rel-L2 1e-5.  The int8 modes calibrate on the same batches
    and quantize.  Each package's calibration runs its bf16 float forward
    (the JAX one jitted: rounded elsewhere), so the ranges agree to bf16
    (rtol 2^-7) and the codes, hence the two servings, may differ (both
    within the int8 budget of the float forward); the port's served output
    equals the JAX forward of the port's own tables (run op by op) bit for
    bit in int8, within 1e-5 through int8_fused (float32 epilogues)."""
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.serve import calibrate_unet, quantize_unet

    xs = list(noise((5, HW, HW, 2), seed=35))
    calib = [noise((4, HW, HW, 2), seed=36)]
    common = dict(models_dir=str(checkpoint / "models"), quant=quant,
                  batch_size=2, image_size=(HW, HW),
                  calibration_batches=calib)
    with je.engine_from_model("unet", cfg=JaxModelConfig(base_features=F),
                              **common) as eng:
        want = np.stack(eng.predict_many(xs))
    with engine_from_model("unet", cfg=ModelConfig(base_features=F),
                           device="cpu", **common) as eng:
        got = np.stack(eng.predict_many(xs))
        assert eng.stats.requests == 5 and eng.stats.batches == 3
    assert got.shape == (5, HW, HW, 1) and np.isfinite(got).all()
    loaded = jax_load_model("unet", str(checkpoint / "models"),
                            checkpoint="required",
                            cfg=JaxModelConfig(base_features=F),
                            image_size=(HW, HW), fold_bn=True)
    y_float = np.asarray(loaded.module.apply(loaded.variables,
                                             jnp.asarray(np.stack(xs)),
                                             train=False))
    if quant == "none":
        assert rel_l2(got, want) <= 1e-5
        assert rel_l2(got, y_float) < 1e-2
        return
    assert rel_l2(got, y_float) < INT8_VS_FLOAT
    assert rel_l2(want, y_float) < INT8_VS_FLOAT
    port = load_model("unet", str(checkpoint / "models"),
                      checkpoint="required", cfg=ModelConfig(base_features=F),
                      fold_bn=True, device="cpu").module
    ranges = calibrate_unet(port, calib)
    jax_ranges = jq.calibrate_unet(loaded.variables, calib)
    for k, r in jax_ranges.items():
        assert ranges[k] == pytest.approx(r, rel=2 ** -7), k
    tables = jax.tree.map(lambda t: np.asarray(t.float()).astype(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else t.numpy(),
        quantize_unet(port, ranges))
    if quant == "int8":
        ref = jax_pair_forward(tables, "int8", np.stack(xs))
        assert rel_l2(got, ref) == 0.0
    else:
        ref = np.asarray(jq.unet_int8_fused_apply(
            tables, jnp.asarray(np.stack(xs)), dtype=jnp.float32))
        assert rel_l2(got, ref) <= 1e-5


def test_engine_from_model_none_rounds_batch_stats(tmp_path):
    """A pair model that is not a UNet serves with quant 'none' in both
    packages: DeepCNN, whose BatchNorm running statistics (buffers in the
    port, ``batch_stats`` in flax) are rounded to bf16 with its weights,
    and whose BatchNorms then compute ``rsqrt(var + eps) * scale`` in bf16
    (flax's dtype promotion).  Those 17 bf16 scale factors move the output
    3.9 % from the float32 forward; the two packages agree to 1e-5."""
    from mrisr_tpu.models.deepcnn import DeepCNN as JaxDeepCNN
    from mrisr_tpu_torch.ckpt.from_jax import deepcnn_state_dict_from_flax
    from mrisr_tpu_torch.models.deepcnn import DeepCNN
    from torch_port_util import jax_init

    v = jax_init(JaxDeepCNN(base_features=F),
                 jnp.zeros((1, HW, HW, 2)), seed=37, train=False)
    module = DeepCNN(base_features=F)
    module.load_state_dict(deepcnn_state_dict_from_flax(v))
    torch.save(reference_checkpoint(module, "deepcnn"),
               tmp_path / "deepcnn_best.pt")
    xs = list(noise((3, HW, HW, 2), seed=38))
    common = dict(models_dir=str(tmp_path), batch_size=2,
                  image_size=(HW, HW))
    with je.engine_from_model("deepcnn", cfg=JaxModelConfig(
            name="deepcnn", base_features=F),
            **common) as eng:
        want = np.stack(eng.predict_many(xs))
    with engine_from_model("deepcnn", cfg=ModelConfig(
            name="deepcnn", base_features=F),
            device="cpu", **common) as eng:
        got = np.stack(eng.predict_many(xs))
    assert rel_l2(got, want) <= 1e-5
    with torch.no_grad():
        y_float = module.eval()(torch.from_numpy(np.stack(xs))).numpy()
    assert 0 < rel_l2(got, y_float) < 0.1


def test_engine_from_model_refusals(checkpoint, tmp_path):
    """The JAX package's refusals: a missing checkpoint (unless
    ``require_checkpoint=False``), a window model, int8 without
    calibration batches or on a model with no enc1 block; and a
    ``data_parallel=True`` batch that does not divide over the devices
    (``tests/test_serve.py:159-168``)."""
    kw = dict(image_size=(HW, HW), batch_size=2, device="cpu")
    with pytest.raises(FileNotFoundError):
        engine_from_model("unet", models_dir=str(tmp_path), cfg=ModelConfig(
            base_features=F), **kw)
    with engine_from_model("unet", models_dir=str(tmp_path), cfg=ModelConfig(
            base_features=F), require_checkpoint=False, **kw) as eng:
        assert eng.predict(np.zeros((HW, HW, 2), np.float32)).shape == (
            HW, HW, 1)
    with pytest.raises(ValueError, match="pair"):
        engine_from_model("progressive_unet", models_dir=str(tmp_path),
                          cfg=ModelConfig(name="progressive_unet",
                                          base_features=F),
                          require_checkpoint=False, **kw)
    with pytest.raises(ValueError, match="calibration_batches"):
        engine_from_model("unet", models_dir=str(checkpoint / "models"),
                          cfg=ModelConfig(base_features=F), quant="int8", **kw)
    with pytest.raises(ValueError, match="enc1"):
        engine_from_model("deepcnn", models_dir=str(tmp_path),
                          cfg=ModelConfig(name="deepcnn", base_features=F),
                          quant="int8", require_checkpoint=False,
                          calibration_batches=[np.zeros((1, HW, HW, 2),
                                                        np.float32)], **kw)
    with pytest.raises(ValueError, match="divide"):
        engine_from_model("unet", models_dir=str(checkpoint / "models"),
                          cfg=ModelConfig(base_features=F),
                          data_parallel=True, devices=["cpu"] * 4, **kw)
