"""The port's int8 Fast-DDPM serving path against
mrisr_tpu/serve/quant_diffusion.py and bundle.py (CPU): the float forward
with its statistics, both calibrators fed the JAX package's draws, the
quantized tables, the int8 forward on the same tables ('chain' and K3's
'fused'), bundles across the packages, and the export-serving entry point
end to end."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrisr_tpu import api as japi
from mrisr_tpu.ckpt import convert_torch_checkpoint
from mrisr_tpu.models import diffusion as jd
from mrisr_tpu.serve import bundle as jb
from mrisr_tpu.serve import quant_diffusion as jq
from mrisr_tpu_torch import cli
from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
from mrisr_tpu_torch.models import diffusion as pd
from mrisr_tpu_torch.serve import bundle as pb
from mrisr_tpu_torch.serve import quant_diffusion as pq
from torch_port_util import (
    jax_chain_noise,
    jax_fastddpm_variables,
    noise,
    rel_l2,
    to_torch_tree,
)

BASE, TDIM, HW = 8, 16, 32

torch.set_num_threads(2)

# a low-noise schedule keeps a random-init chain bounded (the JAX package's
# tests/test_quant_diffusion.py), so one table serves every step
SCHED = (50, 4, "linear", "linspace")


@pytest.fixture(scope="module")
def setup():
    v = jax_fastddpm_variables(BASE, TDIM, HW, seed=21)
    js = jd.DiffusionSchedule.create(*SCHED)
    cond = noise((2, HW, HW, 2), seed=22)
    key = jax.random.PRNGKey(23)
    calib = jq.calibrate_fastddpm(v, js, [jnp.asarray(cond)], key,
                                  dtype=jnp.float32, time_dim=TDIM)
    q = {only: jq.quantize_fastddpm(v, calib, only=only)
         for only in (None, jq.DEEP_SITES)}
    return {"v": v, "params": to_torch_tree(v["params"]), "js": js,
            "ps": pd.DiffusionSchedule.create(*SCHED), "cond": cond,
            "key": key, "calib": calib, "q": q}


def _pv(setup):
    return {"params": setup["params"]}


def test_float_apply_and_stats_match_jax(setup):
    x = noise((2, HW, HW, 3), seed=24)
    t = np.array([7, 36], np.int32)
    @jax.jit
    def fwd(params, x, t):
        stats = {}
        y = jq.fastddpm_float_apply(params, x, t, time_dim=TDIM, stats=stats)
        return y, stats

    want, want_stats = fwd(setup["v"]["params"], jnp.asarray(x),
                           jnp.asarray(t))
    stats = {}
    got = pq.fastddpm_float_apply(setup["params"], torch.from_numpy(x),
                                  torch.from_numpy(t), stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # init + 7 blocks x 2 + 6 skips + 3 upconvs + final
    assert set(stats) == set(want_stats) and len(stats) == 25
    for k, w in want_stats.items():
        np.testing.assert_allclose(float(stats[k]), float(w), rtol=1e-4,
                                   err_msg=k)


def test_calibrate_inputs_matches_jax(setup):
    batches = [(noise((2, HW, HW, 3), seed=s), np.full((2,), t, np.int32))
               for s, t in ((25, 0), (26, 49))]
    want = jq.calibrate_fastddpm_inputs(
        setup["v"], [(jnp.asarray(x), jnp.asarray(t)) for x, t in batches],
        dtype=jnp.float32, time_dim=TDIM)
    got = pq.calibrate_fastddpm_inputs(_pv(setup), batches,
                                       dtype=torch.float32)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("sampler,percentile,sched", [
    ("ancestral", None, SCHED),
    ("ancestral", 99.9, SCHED),
    ("ddim_grid", None, SCHED),
    ("ancestral", None, (1000, 10, "cosine", "nonuniform-4060")),
])
def test_calibrate_trajectory_matches_jax(setup, sampler, percentile, sched):
    js = jd.DiffusionSchedule.create(*sched)
    conds = [setup["cond"], noise((1, HW, HW, 2), seed=27)]
    key = jax.random.PRNGKey(28)
    want = jq.calibrate_fastddpm(
        setup["v"], js, [jnp.asarray(c) for c in conds], key,
        dtype=jnp.float32, time_dim=TDIM, percentile=percentile,
        sampler=sampler)
    draws = [jax_chain_noise(jax.random.fold_in(key, i),
                             (c.shape[0], HW, HW, 1), js)
             for i, c in enumerate(conds)]
    got = pq.calibrate_fastddpm(
        _pv(setup), pd.DiffusionSchedule.create(*sched), conds,
        dtype=torch.float32, percentile=percentile, sampler=sampler,
        noise=draws)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["__timesteps__"],
                                  want["__timesteps__"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("only", [None, jq.DEEP_SITES])
def test_quantize_matches_jax(setup, only):
    want = setup["q"][only]
    got = pq.quantize_fastddpm(_pv(setup), setup["calib"], only=only)
    assert set(got) == set(want) == {"params", "int8", "timesteps"}
    assert set(got["int8"]) == set(want["int8"])
    assert len(got["int8"]) == (25 if only is None else 16)
    for name, lq in want["int8"].items():
        g = got["int8"][name]
        assert set(g) == set(lq)
        np.testing.assert_array_equal(g["w_int8"].numpy(),
                                      np.asarray(lq["w_int8"]))
        for k in ("a_scale", "w_scale", "bias"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(lq[k]),
                                       rtol=1e-6, err_msg=(name, k))
    np.testing.assert_array_equal(got["timesteps"].numpy(),
                                  np.asarray(want["timesteps"]))
    leaf = got["params"]["enc2"]["norm1"]["scale"]
    assert leaf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        leaf.float().numpy(),
        np.asarray(want["params"]["enc2"]["norm1"]["scale"], np.float32))


@pytest.mark.parametrize("only", [jq.DEEP_SITES, None])
def test_int8_apply_matches_jax(setup, only):
    """fp32, on the same tables, at every step's row.  int8_deep (the
    served set): 'chain' within rel-L2 0.02 of the JAX package's 'xla' and
    K3's 'fused' (its plain version here) within atol 0.05 of it, the
    contract of tests/test_groupnorm_pallas.py:138-140.  Every site int8
    (quant='int8'): rel-L2 0.1.  At base 8 one int8 code that float32
    reduction order moves across a .5 boundary shifts this all-int8 output
    by up to 3 % rel-L2 (measured over four seeds, 'chain' and 'fused'
    alike), so the bound there is the same as for a different summation
    order, not a tighter one."""
    q = setup["q"][only]
    qt = to_torch_tree(q)
    x = noise((2, HW, HW, 3), seed=29)
    jax_apply = jax.jit(lambda q, x, t: jq.fastddpm_int8_apply(
        q, x, t, dtype=jnp.float32, time_dim=TDIM, gn_impl="xla"))
    for t_val in np.asarray(setup["js"].timesteps):
        t = np.full((2,), t_val, np.int32)
        want = np.asarray(jax_apply(q, jnp.asarray(x), jnp.asarray(t)))
        got = {gn: pq.fastddpm_int8_apply(
            qt, torch.from_numpy(x), torch.from_numpy(t), dtype=torch.float32,
            gn_impl=gn).numpy() for gn in pq.GN_IMPLS}
        assert got["chain"].shape == (2, HW, HW, 1)
        assert not np.allclose(got["fused"], 0.0)
        if only is None:
            for y in got.values():
                assert rel_l2(y, want) < 0.1
            continue
        assert rel_l2(got["chain"], want) < 0.02
        np.testing.assert_allclose(got["fused"], want, atol=0.05)


def test_bad_tables_and_options_raise(setup):
    qt = pq.quantize_fastddpm(_pv(setup), setup["calib"])
    x, t = torch.zeros(1, HW, HW, 3), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="gn_impl"):
        pq.fastddpm_int8_apply(qt, x, t, gn_impl="xla")
    with pytest.raises(ValueError, match="timesteps"):
        pq.fastddpm_int8_apply({k: v for k, v in qt.items()
                                if k != "timesteps"}, x, t)
    with pytest.raises(KeyError, match="missing conv site"):
        pq.quantize_fastddpm(_pv(setup), {"init_conv": 1.0})
    with pytest.raises(ValueError, match="sampler"):
        pq.calibrate_fastddpm(_pv(setup), setup["ps"], [], sampler="ddim")
    with pytest.raises(ValueError, match="none/int8/int8_deep"):
        pb.make_bundle_apply({}, {"quant": "int8_fused", "kind": "diffusion",
                                  "sampler": "ddim_grid"}, device="cpu")


def _serve_with_jax_draws(path, cond):
    """The port's sampler over a bundle's tables, fed the draws of the JAX
    package's make_bundle_apply (PRNGKey(0), chain fold_in(key, 0))."""
    params, meta = pb.load_bundle(path)
    assert meta["kind"] == "diffusion"
    sched = params["schedule"]
    ps = pd.DiffusionSchedule(sched["betas"], sched["alphas"],
                              sched["alphas_cumprod"], sched["timesteps"])
    js = jd.DiffusionSchedule(*(jnp.asarray(sched[k].numpy()) for k in (
        "betas", "alphas", "alphas_cumprod", "timesteps")))
    draws = jax_chain_noise(jax.random.fold_in(jax.random.PRNGKey(0), 0),
                            (cond.shape[0], *cond.shape[1:3], 1), js)
    fwd = pq.FastDDPMForward(
        params["params"], pb._reflatten_int8_sites(params["int8"]),
        params["timesteps"], device="cpu")
    return pd.sample_ancestral(fwd, torch.from_numpy(cond), None, ps,
                               noise=draws).numpy()


def test_jax_bundle_serves_in_port(setup, tmp_path):
    """A bundle the JAX package exports (int8_deep, bf16) serves in the
    port; fed the same draws, the port's chain lands within rel-L2 0.02 of
    the JAX package's served sample."""
    loaded = japi.LoadedModel(
        name="fastddpm",
        module=jd.FastDDPMUNet(base_features=BASE, time_dim=TDIM),
        variables=setup["v"], kind="diffusion", schedule=setup["js"])
    cond = setup["cond"]
    path = jb._export_diffusion_bundle(
        str(tmp_path / "b"), loaded, quant="int8_deep",
        calibration_batches=[jnp.asarray(cond)], image_size=(HW, HW))
    want = np.asarray(jb.make_bundle_apply(*jb.load_bundle(path))(
        jnp.asarray(cond)))
    assert rel_l2(_serve_with_jax_draws(path, cond), want) < 0.02
    with pb.engine_from_bundle(path, batch_size=2, device="cpu") as eng:
        got = np.stack(eng.predict_many(list(cond) + [cond[0]]))
    assert got.shape == (3, HW, HW, 1) and np.isfinite(got).all()
    assert eng.stats.batches == 2 and eng.stats.padded_slots == 1


def test_export_serving_cli_drive(tmp_path):
    """The entry point at tiny size on the CPU: a seeded reference-layout
    fastddpm_best.pt -> cli export-serving (int8_deep) -> the engine; the
    JAX package loads the same bundle and serves it, and on the same draws
    the two samplers agree."""
    store, models = tmp_path / "store", tmp_path / "models"
    cli.main(["synth", str(store), "--patients", "8", "--slices", "6",
              "--size", str(HW)])
    torch.manual_seed(31)
    model = pd.FastDDPMUNet(base_features=BASE, time_dim=128)
    os.makedirs(models)
    torch.save(reference_checkpoint(model, "fastddpm", epoch=1),
               models / "fastddpm_best.pt")
    common = ["--model", "fastddpm", "--data", str(store), "--image-size",
              str(HW), "--features", str(BASE), "--batch-size", "4",
              "--checkpoint-dir", str(models), "--device", "cpu"]
    cli.main(["export-serving", *common, "--quant", "int8_deep",
              "--calib-batches", "2", "--out", str(tmp_path / "b")])
    path = str(tmp_path / "b")
    params, meta = pb.load_bundle(path)
    assert meta["quant"] == "int8_deep" and meta["time_dim"] == 128
    assert meta["calibration"] == "2 cond batches, trajectory absmax"
    sites = pb._reflatten_int8_sites(params["int8"])
    assert set(sites) == set(pq.DEEP_SITES)
    assert sites["enc2/conv1"]["a_scale"].shape == (10,)
    # the weights are the file's, as the JAX package's converter reads it,
    # and the schedule is the fastddpm preset's (cosine)
    jv = convert_torch_checkpoint("fastddpm", torch.load(
        models / "fastddpm_best.pt", weights_only=True))
    for blk, layer, leaf in (("enc2", "conv1", "kernel"),
                             ("dec1", "skip", "kernel"),
                             ("time_emb", "Dense_1", "kernel"),
                             ("upconv3", None, "kernel")):
        want = jv["params"][blk] if layer is None else jv["params"][blk][layer]
        got = params["params"][blk]
        got = got if layer is None else got[layer]
        np.testing.assert_array_equal(
            got[leaf].float().numpy(),
            np.asarray(jnp.asarray(want[leaf], jnp.bfloat16), np.float32))
    js = jd.DiffusionSchedule.create(1000, 10, "cosine", "nonuniform-4060")
    for k in ("alphas_cumprod", "timesteps"):
        np.testing.assert_array_equal(params["schedule"][k].numpy(),
                                      np.asarray(getattr(js, k)))

    requests = noise((3, HW, HW, 2), seed=32)
    with pb.engine_from_bundle(path, batch_size=2, device="cpu") as eng:
        got = np.stack(eng.predict_many(list(requests)))
    assert got.shape == (3, HW, HW, 1) and np.isfinite(got).all()
    want = np.asarray(jb.make_bundle_apply(*jb.load_bundle(path))(
        jnp.asarray(requests[:2])))
    assert rel_l2(_serve_with_jax_draws(path, requests[:2]), want) < 0.02
    # the float bundle and the float model's own sampler
    cli.main(["export-serving", *common, "--quant", "none", "--out",
              str(tmp_path / "f")])
    with pb.engine_from_bundle(str(tmp_path / "f"), batch_size=2,
                               device="cpu") as eng:
        y = eng.predict(requests[0])
    assert y.shape == (HW, HW, 1) and np.isfinite(y).all()
