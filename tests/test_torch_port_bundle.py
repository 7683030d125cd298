"""Bundles cross between the packages, and the port's engine serves them
(CPU): a bundle mrisr_tpu writes serves in the port within rel-L2 0.02 of
mrisr_tpu's own forward; a bundle the port writes loads in mrisr_tpu."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrisr_tpu.ckpt.fold_bn import fold_unet_batchnorm as jax_fold
from mrisr_tpu.serve import bundle as jb
from mrisr_tpu.serve import quant as jq
from mrisr_tpu_torch.serve import (
    engine_from_bundle,
    load_bundle,
    make_bundle_apply,
    quantize_unet,
    save_bundle,
)
from torch_port_util import jax_unet_variables, noise, port_unet, rel_l2

F = 4
HW = 16

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tables():
    v = jax_unet_variables(F, HW, seed=21)
    folded = jax.tree.map(np.asarray, jax_fold(v["params"], v["batch_stats"]))
    x = noise((4, HW, HW, 2), seed=22)
    calib = jq.calibrate_unet(folded, [jnp.asarray(x)], dtype=jnp.float32)
    return {"folded": folded, "x": x, "calib": calib,
            "q": jq.quantize_unet(folded, calib)}


def test_jax_bundle_serves_in_port(tables, tmp_path):
    path = jb.save_bundle(str(tmp_path / "b"), tables["q"], model_name="unet",
                          quant="int8_fused", base_features=F,
                          image_size=(HW, HW), calibration="1 batch, absmax")
    x = tables["x"]
    want = np.asarray(jb.make_bundle_apply(*jb.load_bundle(path))(
        jnp.asarray(x)))
    params, meta = load_bundle(path)
    assert params["upconv1"]["kernel"].dtype == torch.bfloat16
    assert params["enc1"]["Conv_0"]["w_int8"].dtype == torch.int8
    with engine_from_bundle(path, batch_size=3, device="cpu",
                            max_delay_ms=50) as eng:
        got = np.stack(eng.predict_many(list(x)))
    assert got.shape == (4, HW, HW, 1)
    assert rel_l2(got, want) < 0.02
    # 4 requests over batch 3: one full batch and one wrap-padded one
    assert eng.stats.requests == 4
    assert eng.stats.batches == 2 and eng.stats.padded_slots == 2


def test_port_bundle_loads_in_jax(tables, tmp_path):
    model = port_unet(tables["folded"], F)
    q = quantize_unet(model, tables["calib"])
    path = save_bundle(str(tmp_path / "b"), q, model_name="unet",
                       quant="int8_fused", base_features=F,
                       image_size=(HW, HW))
    params, meta = jb.load_bundle(path)
    assert meta["quant"] == "int8_fused" and meta["base_features"] == F
    for name in ("enc1", "dec1"):
        np.testing.assert_array_equal(
            np.asarray(params[name]["Conv_0"]["w_int8"]),
            q[name]["Conv_0"]["w_int8"].numpy())
    assert params["final"]["kernel"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(params["final"]["kernel"], np.float32),
        q["final"]["kernel"].float().numpy())
    x = tables["x"]
    jax_y = np.asarray(jb.make_bundle_apply(params, meta)(jnp.asarray(x)))
    port_y = make_bundle_apply(*load_bundle(path), device="cpu")(
        torch.from_numpy(x)).numpy()
    assert rel_l2(port_y, jax_y) < 0.02


def test_unported_modes_raise(tables):
    """Pair bundles of every quant serve
    (``tests/test_torch_port_pair_serving.py``): a 'none' bundle whose tree
    is not a folded UNet raises the reference's ValueError, an unknown
    quant a ValueError, and so does a diffusion bundle's pair-only quant
    (ddim_grid bundles serve: ``test_steps_export_reloads_as_ddim_grid``)."""
    with pytest.raises(ValueError, match="UNet-family topology"):
        make_bundle_apply({}, {"quant": "none"}, device="cpu")
    with pytest.raises(ValueError, match="BN-FOLDED"):
        make_bundle_apply({"params": {"enc1": {"BatchNorm_0": {}}}},
                          {"quant": "none"}, device="cpu")
    with pytest.raises(ValueError, match="int8_fused"):
        make_bundle_apply(tables["q"], {"quant": "int4"}, device="cpu")
    with pytest.raises(ValueError, match="diffusion bundles carry"):
        make_bundle_apply({}, {"quant": "int8_fused", "kind": "diffusion",
                               "sampler": "ddim_grid"}, device="cpu")


def test_engine_threads_and_close(tables, tmp_path):
    path = jb.save_bundle(str(tmp_path / "b"), tables["q"], model_name="unet",
                          quant="int8_fused", base_features=F,
                          image_size=(HW, HW))
    x = tables["x"]
    ref = make_bundle_apply(*load_bundle(path), device="cpu")(
        torch.from_numpy(x)).numpy()
    eng = engine_from_bundle(path, batch_size=2, device="cpu")
    results = {}

    def client(k):
        results[k] = [eng.submit(x[i]) for i in range(4)]

    threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for k in range(2):
        for i, fut in enumerate(results[k]):
            np.testing.assert_allclose(fut.result(timeout=60), ref[i],
                                       atol=1e-6)
    eng.close()
    assert not eng._thread.is_alive()
    assert eng.stats.requests == 8
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(x[0])
    with engine_from_bundle(path, batch_size=2, device="cpu") as eng2:
        with pytest.raises(ValueError, match="shape"):
            eng2.submit(np.zeros((3, 3, 2), np.float32))


def test_steps_export_reloads_as_ddim_grid(tmp_path):
    """A step-distilled student (``fastddpm_steps3_best.pt`` + its grid
    sidecar) exports as a bundle whose meta names the loaded model's
    sampler, 'ddim_grid' (the JAX package writes ``loaded.sampler``), with
    its grid, calibrated on that sampler's trajectory; the JAX package
    reads the same meta, and the port serves it with DDIM over the grid."""
    import json

    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
    from mrisr_tpu_torch.config import ModelConfig
    from mrisr_tpu_torch.models.diffusion import FastDDPMUNet
    from mrisr_tpu_torch.serve.bundle import export_serving_bundle
    from mrisr_tpu_torch.serve.quant_diffusion import calibrate_fastddpm

    torch.manual_seed(23)
    module = FastDDPMUNet(base_features=4, time_dim=8)
    torch.save(reference_checkpoint(module, "fastddpm"),
               tmp_path / "fastddpm_steps3_best.pt")
    grid = [199, 799, 999]
    (tmp_path / "fastddpm_steps3_grid.json").write_text(json.dumps(
        {"base": "fastddpm", "factor": 2, "timesteps": grid}))
    mcfg = ModelConfig(name="fastddpm", base_features=4, time_dim=8)
    cond = noise((2, HW, HW, 2), seed=24) * 0.5
    path = export_serving_bundle(
        str(tmp_path / "b"), "fastddpm_steps3", str(tmp_path),
        quant="int8_deep", calibration_batches=[cond], cfg=mcfg,
        image_size=(HW, HW), device="cpu")
    params, meta = load_bundle(path)
    assert meta["sampler"] == "ddim_grid"
    assert meta["model_name"] == "fastddpm_steps3"
    np.testing.assert_array_equal(params["schedule"]["timesteps"].numpy(),
                                  grid)
    loaded = load_model("fastddpm_steps3", str(tmp_path), cfg=mcfg,
                        device="cpu")
    for sampler in ("ddim_grid", "ancestral"):
        ranges = calibrate_fastddpm(
            {"params": fastddpm_flax_params(loaded.module)}, loaded.schedule,
            [cond], torch.Generator().manual_seed(0), sampler=sampler)
        same = np.array_equal(
            params["int8"]["enc2"]["conv1"]["a_scale"].numpy(),
            np.maximum(ranges["enc2/conv1"], 1e-12) / 127.0)
        assert same == (sampler == "ddim_grid"), sampler
    assert jb.load_bundle(path)[1]["sampler"] == "ddim_grid"
    with engine_from_bundle(path, batch_size=2, device="cpu") as eng:
        got = np.stack(eng.predict_many(list(cond)))
    fwd = make_bundle_apply(params, meta, device="cpu")
    want = fwd(torch.from_numpy(cond)).numpy()
    np.testing.assert_array_equal(got, want)
    # one fresh x_T a call, the chain DDIM over the 3-step grid
    assert not np.array_equal(want, make_bundle_apply(
        params, {**meta, "sampler": "ancestral"}, device="cpu")(
            torch.from_numpy(cond)).numpy())
