"""Port eval layer against mrisr_tpu's (CPU): metrics in all three
normalizations, volume prediction with a port UNet carrying JAX weights,
and the per-spacing test-set runner."""

import json

import numpy as np
import pytest
import torch

import jax

from mrisr_tpu.config import DataConfig as JaxDataConfig
from mrisr_tpu.data.synthetic import make_synthetic_store as jax_make_store
from mrisr_tpu.data.synthetic import make_synthetic_volume
from mrisr_tpu.eval import metrics as jm
from mrisr_tpu.eval import runner as jr
from mrisr_tpu.eval import volume_eval as jv
from mrisr_tpu.models import UNet as JaxUNet
from mrisr_tpu_torch.config import DataConfig
from mrisr_tpu_torch.data.volumes import VolumeStore
from mrisr_tpu_torch.eval import metrics as pm
from mrisr_tpu_torch.eval import runner as pr
from mrisr_tpu_torch.eval import volume_eval as pv
from torch_port_util import jax_unet_variables, port_unet

torch.set_num_threads(2)

F = 4
HW = 32
CPU = "cpu"


def assert_metrics_close(got, want, ssim_atol=3e-5):
    """SSIM at 3e-5 (K1's contract), PSNR at 1e-3 dB, MAE at 1e-6."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_metrics_close(g, w, ssim_atol)
        elif isinstance(w, np.ndarray):
            np.testing.assert_allclose(g, w, atol=1e-6, err_msg=k)
        elif k.startswith("ssim"):
            assert g == pytest.approx(w, abs=ssim_atol), k
        elif k.startswith("psnr"):
            if np.isfinite(w):
                assert g == pytest.approx(w, abs=1e-3), k
            else:  # inf (identical slices) and its nan std, as in V6
                assert np.isnan(g) == np.isnan(w) and np.isinf(g) == np.isinf(
                    w), (k, g, w)
        else:
            assert g == pytest.approx(w, abs=1e-6), k


@pytest.fixture(scope="module")
def volume():
    return make_synthetic_volume(num_slices=12, height=HW, width=HW, seed=3)


@pytest.fixture(scope="module")
def models():
    """(jax predict_fn, port UNet) with the same seeded weights."""
    v = jax_unet_variables(F, HW, seed=7)
    jmod = JaxUNet(features=F)
    jax_fn = jax.jit(lambda x: jmod.apply(v, x, train=False))
    return jax_fn, port_unet(v, F)


def test_compute_metrics_matches_jax(volume):
    rng = np.random.default_rng(0)
    pred = volume + 40.0 * rng.standard_normal(volume.shape).astype(np.float32)
    pred[::3] = volume[::3]  # untouched slices: PSNR inf, as in V6
    assert_metrics_close(pm.compute_metrics(volume, pred, CPU),
                         jm.compute_metrics(volume, pred))


@pytest.mark.parametrize("mode", ["minmax-each", "denorm-11", "raw"])
def test_per_sample_metrics_matches_jax(mode):
    rng = np.random.default_rng(1)
    gt = np.tanh(rng.standard_normal((6, 20, 24))).astype(np.float32)
    pred = (gt + 0.1 * rng.standard_normal(gt.shape)).astype(np.float32)
    got = pm.per_sample_metrics(torch.from_numpy(gt), pred, mode, CPU)
    assert_metrics_close(got, jm.per_sample_metrics(gt, pred, mode))


def test_spacing_metrics_matches_jax():
    rng = np.random.default_rng(2)
    gt = rng.random((7, 16, 16)).astype(np.float32)
    pred = gt + 0.3 * rng.random(gt.shape).astype(np.float32)
    dist = np.array([2, 4, 2, 4, 4, 2, 2])
    got = pm.spacing_metrics(gt, pred, dist, device=CPU)
    assert got["3mm"]["num_samples"] == 4 and got["6mm"]["num_samples"] == 3
    assert_metrics_close(got, jm.spacing_metrics(gt, pred, dist))


@pytest.mark.parametrize("hierarchical", [False, True])
def test_predict_volume_matches_jax(volume, models, hierarchical):
    jax_fn, model = models
    jfun = (jv.predict_volume_hierarchical if hierarchical
            else jv.predict_volume)
    pfun = (pv.predict_volume_hierarchical if hierarchical
            else pv.predict_volume)
    want = jfun(jax_fn, volume, batch_size=4, image_size=(HW, HW))
    got = pfun(model, volume, batch_size=4, image_size=(HW, HW), device=CPU)
    assert got["predicted_indices"] == want["predicted_indices"]
    np.testing.assert_allclose(got["volume_original"],
                               want["volume_original"], atol=1e-5)
    np.testing.assert_allclose(got["volume_predicted"],
                               want["volume_predicted"], atol=1e-4)
    for key in ("metrics", "metrics_predicted_only"):
        assert_metrics_close(got[key], want[key])


def test_predict_volume_progressive_matches_jax(volume):
    """No port model drives it yet: a fixed stub on both sides."""

    def stub(x):
        return tuple(0.5 * (x[..., j - 1:j] + x[..., j + 1:j + 2])
                     + 0.01 * j for j in (1, 2, 3))

    want = jv.predict_volume_progressive(stub, volume,
                                         batch_size=3, image_size=(24, 24))
    got = pv.predict_volume_progressive(stub, volume,
                                        batch_size=3, image_size=(24, 24),
                                        device=CPU)
    assert got["predicted_indices"] == want["predicted_indices"]
    np.testing.assert_allclose(got["volume_predicted"],
                               want["volume_predicted"], atol=1e-5)
    assert_metrics_close(got["metrics_predicted_only"],
                         want["metrics_predicted_only"])


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return jax_make_store(str(tmp_path_factory.mktemp("eval_store")),
                          num_patients=8, slices_per_volume=10, height=HW,
                          width=HW)


@pytest.mark.parametrize("max_batches", [None, 2])
def test_evaluate_pair_model_test_set_matches_jax(store, models, max_batches):
    jax_fn, model = models
    kw = dict(batch_size=3, image_size=(HW, HW))
    want = jr.evaluate_pair_model_test_set(
        jax_fn, store, JaxDataConfig(**kw), max_batches=max_batches)
    timings = {}
    got = pr.evaluate_pair_model_test_set(
        model, VolumeStore.open(store.root), DataConfig(**kw),
        max_batches=max_batches, device=CPU, timings=timings)
    assert set(got) == {"3mm", "6mm"}
    if max_batches:
        assert got["3mm"]["num_samples"] == 6
    assert_metrics_close(got, want)
    assert set(timings) == {"loader", "forward", "metrics"}


def test_evaluate_progressive_and_save(store, tmp_path, models):
    def stub(x):
        return tuple(0.5 * (x[..., j - 1:j] + x[..., j + 1:j + 2])
                     for j in (1, 2, 3))

    kw = dict(batch_size=4, image_size=(HW, HW))
    want = jr.evaluate_progressive_test_set(stub, store, JaxDataConfig(**kw),
                                            max_batches=1)
    pstore = VolumeStore.open(store.root)
    got = pr.evaluate_progressive_test_set(stub, pstore, DataConfig(**kw),
                                           max_batches=1, device=CPU)
    assert_metrics_close(got, want)

    out = tmp_path / "r" / "unet_test_metrics.json"
    saved = pr.evaluate_and_save(models[1], pstore, DataConfig(**kw),
                                 out_json=str(out), device=CPU)
    assert json.loads(out.read_text()) == saved
