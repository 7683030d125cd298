"""The port's comparison figures (eval/figures.py) against mrisr_tpu's (CPU):
each figure function, given the same seeded numpy arrays, must render the
same PNG pixels; without matplotlib the port raises an ImportError that
names it."""

import sys

import numpy as np
import pytest

from mrisr_tpu.eval import figures as jax_figures
from mrisr_tpu_torch.eval import figures

Z, HW = 8, 32


def volume_results(seed: int, names=("unet", "progressive_unet")):
    """predict-volume's results dict shape, from a seeded generator."""
    rng = np.random.default_rng(seed)
    orig = rng.standard_normal((Z, HW, HW)).astype(np.float32)
    out = {}
    for k, name in enumerate(names):
        pred = orig + 0.1 * (k + 1) * rng.standard_normal(orig.shape).astype(
            np.float32)
        out[name] = {"volume_original": orig, "volume_predicted": pred,
                     "metrics": {"ssim_mean": float(rng.random()),
                                 "psnr_mean": float(20 + 10 * rng.random())}}
    return out


def render_both(tmp_path, name, *args, **kw):
    """Draw figure ``name`` with both packages; return the two PNGs'
    pixels."""
    import matplotlib.image as mpimg

    got, want = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert getattr(figures, name)(*args, save_path=got, **kw) == got
    getattr(jax_figures, name)(*args, save_path=want, **kw)
    return mpimg.imread(got), mpimg.imread(want)


@pytest.mark.parametrize("names,kw", [
    (("unet", "progressive_unet"), {"sagittal_x": HW // 2}),
    (("unet",), {"sagittal_x": 3, "axial_z": 5}),
])
def test_parallel_views_figure(tmp_path, names, kw):
    got, want = render_both(tmp_path, "parallel_views_figure",
                            volume_results(0, names), "seed42", **kw)
    assert got.shape == want.shape and got.shape[0] > 100
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("view,index", [("sagittal", None), ("axial", 3)])
def test_single_view_figure(tmp_path, view, index):
    got, want = render_both(tmp_path, "single_view_figure",
                            volume_results(1), view=view, index=index,
                            patient_name="seed42")
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="view must be"):
        figures.single_view_figure(volume_results(1), view="coronal")


def test_volume_views_figure(tmp_path):
    vol = np.random.default_rng(2).standard_normal((Z, HW, 24)).astype(
        np.float32)
    got, want = render_both(tmp_path, "volume_views_figure", vol,
                            title="views")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_models", [1, 3])
def test_triplet_grid_figure(tmp_path, n_models):
    rng = np.random.default_rng(3)
    pre, post, gt = (rng.standard_normal((HW, HW)).astype(np.float32)
                     for _ in range(3))
    preds = {f"model{k}": gt + 0.1 * rng.standard_normal((HW, HW)).astype(
        np.float32) for k in range(n_models)}
    got, want = render_both(tmp_path, "triplet_grid_figure", pre, post, gt,
                            preds)
    np.testing.assert_array_equal(got, want)


def test_figures_name_matplotlib_when_missing(tmp_path, monkeypatch):
    """No matplotlib (the card's machine): every figure raises an
    ImportError naming it, and writes nothing."""
    for mod in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    x = np.zeros((HW, HW), np.float32)
    for call in (
        lambda: figures.pyplot(),
        lambda: figures.parallel_views_figure(volume_results(0)),
        lambda: figures.triplet_grid_figure(x, x, x, {}, str(tmp_path / "t")),
    ):
        with pytest.raises(ImportError, match="matplotlib"):
            call()
    assert list(tmp_path.iterdir()) == []
