"""Port calibration, quantization and the int8_fused forward against
mrisr_tpu/serve/quant.py on the same weights and tables (fp32, CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrisr_tpu.ckpt.fold_bn import fold_unet_batchnorm as jax_fold
from mrisr_tpu.serve import quant as jq
from mrisr_tpu_torch.serve import quant as pq
from mrisr_tpu_torch.models import UNet
from torch_port_util import (
    jax_unet_variables,
    noise,
    port_unet,
    rel_l2,
    to_torch_tree,
)

F = 8
HW = 32

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    v = jax_unet_variables(F, HW, seed=11)
    folded = jax_fold(v["params"], v["batch_stats"])
    folded = jax.tree.map(np.asarray, folded)
    x = noise((4, HW, HW, 2), seed=12)
    calib = jq.calibrate_unet(folded, [jnp.asarray(x)], dtype=jnp.float32)
    return {"folded": folded, "model": port_unet(folded, F), "x": x,
            "calib": calib, "q": jq.quantize_unet(folded, calib)}


def test_float_stats_forward_matches_jax(setup):
    want, want_stats = jq._unet_float_with_stats(
        setup["folded"]["params"], jnp.asarray(setup["x"]), dtype=jnp.float32)
    with torch.no_grad():
        got, stats = pq._unet_float_with_stats(
            setup["model"], torch.from_numpy(setup["x"]), dtype=torch.float32)
    assert len(stats) == 23 and set(stats) == set(want_stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("percentile", [None, 99.9])
def test_calibrate_matches_jax(setup, percentile):
    if percentile is None:
        want = setup["calib"]
    else:
        want = jq.calibrate_unet(setup["folded"], [jnp.asarray(setup["x"])],
                                 dtype=jnp.float32, percentile=percentile)
    got = pq.calibrate_unet(setup["model"], [setup["x"]], dtype=torch.float32,
                            percentile=percentile)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_quantize_matches_jax(setup):
    got = pq.quantize_unet(setup["model"], setup["calib"])
    want = setup["q"]
    assert set(got) == set(want)
    for name, ent in want.items():
        subs = ent.items() if "Conv_0" in ent else [(None, ent)]
        for cn, lq in subs:
            g = got[name][cn] if cn else got[name]
            assert set(g) == set(lq), (name, cn)
            np.testing.assert_array_equal(g["w_int8"].numpy(),
                                          np.asarray(lq["w_int8"]))
            for k in ("scale", "a_scale"):
                np.testing.assert_allclose(g[k].numpy(), np.asarray(lq[k]),
                                           rtol=1e-6, err_msg=(name, cn, k))
            if cn is None:
                assert g["kernel"].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    g["kernel"].float().numpy(),
                    np.asarray(lq["kernel"], np.float32))
                np.testing.assert_array_equal(g["qbias"].numpy(),
                                              np.asarray(lq["qbias"]))


@pytest.mark.parametrize("skip_emit", ["shared", "dual"])
def test_fused_apply_matches_jax(setup, skip_emit):
    x = setup["x"]
    want = np.asarray(jax.jit(
        lambda p, b: jq.unet_int8_fused_apply(p, b, dtype=jnp.float32,
                                              skip_emit=skip_emit)
    )(setup["q"], jnp.asarray(x)))
    got = pq.unet_int8_fused_apply(to_torch_tree(setup["q"]),
                                   torch.from_numpy(x), skip_emit=skip_emit)
    assert got.shape == (4, HW, HW, 1) and got.dtype == torch.float32
    assert rel_l2(got.numpy(), want) < 0.02
    # and close to the float forward (tests/test_quant.py's bound)
    with torch.no_grad():
        y_fp = setup["model"](torch.from_numpy(x)).numpy()
    assert rel_l2(got.numpy(), y_fp) < 0.15


def test_legacy_tables_raise(setup):
    """Pre-r3 tables (no upconv/final int8 entries) take the reference's
    fallback: a default skip_emit degrades to 'dual' and serves the JAX
    package's output (the same bits in bf16); an explicit 'shared' raises
    its ValueError."""
    legacy_calib = {k: v for k, v in setup["calib"].items()
                    if not (k.startswith("upconv") or k == "final")}
    q = pq.quantize_unet(setup["model"], legacy_calib)
    assert "w_int8" not in q["upconv4"]
    assert pq.resolve_variants(q) == "dual"
    assert pq.resolve_variants(pq.quantize_unet(setup["model"],
                                                setup["calib"])) == "shared"
    x = setup["x"]
    with pytest.raises(ValueError, match="full int8 tables"):
        pq.unet_int8_fused_apply(q, torch.from_numpy(x), skip_emit="shared")
    jq_legacy = jq.quantize_unet(setup["folded"], legacy_calib)
    want = np.asarray(jax.jit(jq.unet_int8_fused_apply)(jq_legacy,
                                                        jnp.asarray(x)))
    got = pq.unet_int8_fused_apply(to_torch_tree(jq_legacy),
                                   torch.from_numpy(x))
    assert got.shape == (4, HW, HW, 1) and got.dtype == torch.float32
    assert rel_l2(got.numpy(), want) == 0.0


def test_rejects_unfolded():
    model = UNet(features=4)
    with pytest.raises(ValueError, match="BN-FOLDED"):
        pq.calibrate_unet(model, [np.zeros((1, 16, 16, 2), np.float32)])
    with pytest.raises(ValueError, match="BN-FOLDED"):
        pq.quantize_unet(model, {})
