"""Comparison figures (V7 parallel views, V10 triplet grids): the port's
copy of ``mrisr_tpu/eval/figures.py``, drawing the same pixels from the
same numpy arrays.

Keeps the reference's artifact contract: sagittal/axial side-by-side
comparisons with difference maps
(`reference/src/VolumeVisualization.py:272-402`) and single-triplet
PRE/POST/GT/prediction grids with per-image min-max normalization + MSE
annotation (`:737-881`, source of ``results/triplet_seed*.png``).

matplotlib is imported when a figure is drawn, with the Agg backend; on a
machine without it, :func:`pyplot` raises an ImportError that names it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def pyplot():
    """matplotlib.pyplot on the Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the comparison figures need matplotlib, which is not installed "
            "on this machine (pip install matplotlib)") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _norm01(img: np.ndarray) -> np.ndarray:
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo + 1e-8)


def parallel_views_figure(
    results: Dict[str, Dict],
    patient_name: str = "",
    save_path: Optional[str] = None,
    sagittal_x: int = 128,
    axial_z: Optional[int] = None,
):
    """All-model comparison: rows = [sagittal, axial, |diff|], columns =
    [original] + models.  ``results[name]`` comes from eval.volume_eval."""
    plt = pyplot()
    names = list(results)
    first = results[names[0]]
    orig = first["volume_original"]
    z = axial_z if axial_z is not None else orig.shape[0] // 2

    ncols = len(names) + 1
    fig, axes = plt.subplots(3, ncols, figsize=(4 * ncols, 12))
    if ncols == 1:
        axes = axes[:, None]

    def put(ax, img, title):
        ax.imshow(_norm01(img), cmap="gray")
        ax.set_title(title, fontsize=10)
        ax.axis("off")

    put(axes[0, 0], orig[:, :, sagittal_x], "Original (sagittal)")
    put(axes[1, 0], orig[z], "Original (axial)")
    axes[2, 0].axis("off")

    for c, name in enumerate(names, start=1):
        pred = results[name]["volume_predicted"]
        m = results[name]["metrics"]
        label = f"{name}\nSSIM {m['ssim_mean']:.4f} PSNR {m['psnr_mean']:.2f}"
        put(axes[0, c], pred[:, :, sagittal_x], label)
        put(axes[1, c], pred[z], f"{name} (axial)")
        diff = np.abs(pred[z] - orig[z])
        axes[2, c].imshow(diff, cmap="hot")
        axes[2, c].set_title(f"{name} |diff|", fontsize=10)
        axes[2, c].axis("off")

    fig.suptitle(f"Volume prediction comparison {patient_name}", fontsize=14)
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def single_view_figure(
    results: Dict[str, Dict],
    view: str = "sagittal",
    index: Optional[int] = None,
    patient_name: str = "",
    save_path: Optional[str] = None,
):
    """All-model single-view side-by-side comparison — the V8 figure shape
    (`reference/src/VolumeVisualization.py:1042-1271`): ONE chosen
    view (sagittal X, reference default 128, or axial Z, reference default
    30) as a single row [Original] + one panel per model (incl. FastDDPM),
    each annotated with its volume SSIM/PSNR."""
    plt = pyplot()
    names = list(results)
    orig = results[names[0]]["volume_original"]
    if view == "sagittal":
        index = orig.shape[2] // 2 if index is None else index
        pick = lambda vol: vol[:, :, index]  # noqa: E731
    elif view == "axial":
        index = orig.shape[0] // 2 if index is None else index
        pick = lambda vol: vol[index]  # noqa: E731
    else:
        raise ValueError(f"view must be 'sagittal' or 'axial', got {view!r}")

    ncols = len(names) + 1
    fig, axes = plt.subplots(1, ncols, figsize=(4 * ncols, 4.5))
    axes = np.atleast_1d(axes)
    axes[0].imshow(_norm01(pick(orig)), cmap="gray", aspect="auto")
    axes[0].set_title(f"Original ({view} {index})", fontsize=10)
    axes[0].axis("off")
    for c, name in enumerate(names, start=1):
        res = results[name]
        m = res["metrics"]
        axes[c].imshow(
            _norm01(pick(res["volume_predicted"])), cmap="gray", aspect="auto"
        )
        axes[c].set_title(
            f"{name}\nSSIM {m['ssim_mean']:.4f} PSNR {m['psnr_mean']:.2f}",
            fontsize=10,
        )
        axes[c].axis("off")
    fig.suptitle(f"Model comparison {patient_name} ({view})", fontsize=14)
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def volume_views_figure(
    volume: np.ndarray,
    save_path: Optional[str] = None,
    title: str = "MRI slice views",
):
    """Axial / sagittal / coronal mid-volume views — the Data Analysis
    notebook's ``show_views`` geometry check
    (`reference/notebooks/Data Analysis.ipynb:cell8`, source of
    ``results/mri_slice_views_before.png``)."""
    plt = pyplot()
    z, h, w = volume.shape
    views = [
        ("axial (z)", volume[z // 2]),
        ("coronal (y)", volume[:, h // 2, :]),
        ("sagittal (x)", volume[:, :, w // 2]),
    ]
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    for ax, (name, img) in zip(axes, views):
        ax.imshow(_norm01(np.asarray(img)), cmap="gray", aspect="auto")
        ax.set_title(name)
        ax.axis("off")
    fig.suptitle(title)
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def triplet_grid_figure(
    pre: np.ndarray,
    post: np.ndarray,
    target: np.ndarray,
    predictions: Dict[str, np.ndarray],
    save_path: Optional[str] = None,
):
    """One triplet: PRE / POST / GT then each model's prediction with MSE
    annotation; every image min-max normalized independently (V10)."""
    plt = pyplot()
    items = [("PRE", pre), ("POST", post), ("GROUND TRUTH", target)]
    for name, img in predictions.items():
        items.append((name, img))
    n = len(items)
    ncols = min(n, 4)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 4 * nrows))
    axes = np.atleast_2d(axes)
    for k, (title, img) in enumerate(items):
        ax = axes[k // ncols, k % ncols]
        ax.imshow(_norm01(np.asarray(img)), cmap="gray")
        if title not in ("PRE", "POST", "GROUND TRUTH"):
            mse = float(np.mean((np.asarray(img) - np.asarray(target)) ** 2))
            title = f"{title}\nMSE {mse:.4f}"
        ax.set_title(title, fontsize=10)
        ax.axis("off")
    for k in range(n, nrows * ncols):
        axes[k // ncols, k % ncols].axis("off")
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path
