"""Fast-DDPM served int8_deep, as ``export-serving --quant int8_deep`` and
``serve`` make it: a checkpoint of the seeded model,
``export_serving_bundle`` (``calibrate_fastddpm`` over the sampler's own
trajectory on the given condition batches, the 16 deep sites in int8;
serving runs K3 at the GroupNorms that feed them, A and B), and
``engine_from_bundle`` with the default GroupNorm path.

The served sampler draws its noise from a generator seeded 0 on every
call, so a request's answer depends on its row in the batch: the engine's
batch order gives each sampled request its row, and the reference draws
the same batch's noise the same way and takes that row.  Compared: each
sampled answer against the reference's float32 sampler (TF32 off): the RMS difference over the reference's standard
deviation (rel-RMSE, ``core.gap``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import core
from portbench.reference import counts
from portbench.reference import fastddpm as ref
from portbench.weights import fastddpm_weights

needs_rows = True
NUMBER = "rel_rmse"
REF_BLOCK = 8


def _b(cfg):
    return int(cfg["widths"]["base_features"])


def _d(cfg):
    return int(cfg["widths"]["time_dim"])


def weights(cfg: Dict[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    return fastddpm_weights(ref.param_shapes(_b(cfg), _d(cfg),
                                             cfg["widths"]["in_channels"]),
                            seed, device)


def build(cfg: Dict[str, Any], w: Dict[str, torch.Tensor], calib: List,
          workdir: str, device, engine: Dict[str, Any]):
    from mrisr_tpu_torch.config import ModelConfig
    from mrisr_tpu_torch.serve.bundle import (
        engine_from_bundle,
        export_serving_bundle,
    )

    name = cfg["model_name"]
    torch.save({"model_state_dict": {k: v.cpu() for k, v in w.items()}},
               os.path.join(workdir, f"{name}_best.pt"))
    wd, s = cfg["widths"], cfg["sampler"]
    mcfg = ModelConfig(
        name=name, in_channels=wd["in_channels"], base_features=_b(cfg),
        time_dim=_d(cfg), num_timesteps=s["num_timesteps"],
        num_inference_steps=s["steps"], beta_schedule=s["beta_schedule"],
        timestep_selection=s["timestep_selection"])
    hw = int(cfg["image_size"])
    path = export_serving_bundle(
        os.path.join(workdir, "bundle"), model_name=name, models_dir=workdir,
        quant=cfg["serve"]["quant"], calibration_batches=calib, cfg=mcfg,
        image_size=(hw, hw), device=device)
    return engine_from_bundle(path, batch_size=int(engine["batch_size"]),
                              max_delay_ms=float(engine["max_delay_ms"]),
                              device=device)


def sites(cfg: Dict[str, Any], batch: int):
    return counts.fastddpm_kernel_sites(batch, int(cfg["image_size"]),
                                        _b(cfg))


def slice_ideal_s(cfg: Dict[str, Any]) -> float:
    return counts.ideal_s(counts.fastddpm_model_ops(
        int(cfg["image_size"]), _b(cfg), _d(cfg),
        int(cfg["sampler"]["steps"])))


def batch_noise(batch: int, hw: int, steps: int, device):
    """The served call's draws: x_T, then one z a step but the last, from
    a generator seeded 0, each ``(batch, hw, hw, 1)``."""
    g = torch.Generator(device=device).manual_seed(0)

    def draw():
        return torch.randn((batch, hw, hw, 1), generator=g, device=device,
                           dtype=torch.float32)

    x_t = draw()
    return x_t, [draw() for _ in range(steps - 1)]


@torch.no_grad()
def compare(cfg: Dict[str, Any], w: Dict[str, torch.Tensor], samples: List,
            pool: np.ndarray, device, batch: int, calib: List, bits=None):
    """Each sampled answer's RMS distance from the float32 reference
    sampler on the same noise and the reference's standard deviation, by
    sample; with ``bits`` the reference sampler with its deep sites served
    at that precision, calibrated on ``calib``'s trajectories, stands in
    for the answers."""
    hw, steps = int(cfg["image_size"]), int(cfg["sampler"]["steps"])
    n_t = cfg["sampler"]["num_timesteps"]
    x_t, zs = batch_noise(batch, hw, steps, device)
    with core.fp32():
        quant = (ref.calibrated(w, calib, bits, device, steps, n_t)
                 if bits else None)
        errs, norms = [], []
        for i in range(0, len(samples), REF_BLOCK):
            chunk = samples[i:i + REF_BLOCK]
            rows = torch.tensor([r for _, _, _, r in chunk], device=device)
            cond = torch.from_numpy(np.stack([pool[v, p] for v, p, _, _ in
                                              chunk])).to(device)
            noise = (x_t[rows], [z[rows] for z in zs])
            want = ref.sample(w, cond, *noise, None, n_t).double()
            got = (ref.sample(w, cond, *noise, quant, n_t) if bits else
                   torch.from_numpy(np.stack([y for _, _, y, _ in chunk]))
                   .to(device)).double()
            errs += (got - want).square().mean(dim=(1, 2, 3)).sqrt().tolist()
            norms += want.std(dim=(1, 2, 3)).tolist()
        return errs, norms
