"""The M2 UNet served int8_fused, as ``export-serving`` and ``serve`` make
it: a checkpoint of the seeded model, ``export_serving_bundle`` (BN fold,
absmax calibration on the given batches, int8 tables; kernels A and B at
serving time), ``engine_from_bundle``.

Compared: each sampled answer against the reference's float32 forward of
its request (TF32 off), by L2 distance over the reference's norm
(``core.gap``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import core
from portbench.reference import counts
from portbench.reference import unet as ref
from portbench.weights import unet_weights

needs_rows = False
NUMBER = "rel_l2"
REF_BLOCK = 16  # reference rows a call


def _f(cfg):
    return int(cfg["widths"]["base_features"])


def weights(cfg: Dict[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    w = cfg["widths"]
    return unet_weights(ref.param_shapes(_f(cfg), w["in_channels"],
                                         w["out_channels"]), seed, device)


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
    wd = cfg["widths"]
    mcfg = ModelConfig(name=name, in_channels=wd["in_channels"],
                       out_channels=wd["out_channels"],
                       base_features=_f(cfg))
    hw = int(cfg["image_size"])
    path = export_serving_bundle(
        os.path.join(workdir, "bundle"), model_name=name, models_dir=workdir,
        quant=cfg["serve"]["quant"], calibration_batches=calib, cfg=mcfg,
        image_size=(hw, hw), device=device)
    return engine_from_bundle(path, batch_size=int(engine["batch_size"]),
                              max_delay_ms=float(engine["max_delay_ms"]),
                              device=device)


def sites(cfg: Dict[str, Any], batch: int):
    return counts.unet_kernel_sites(batch, int(cfg["image_size"]), _f(cfg))


def slice_ideal_s(cfg: Dict[str, Any]) -> float:
    return counts.ideal_s(counts.unet_model_ops(int(cfg["image_size"]),
                                                _f(cfg)))


@torch.no_grad()
def compare(cfg: Dict[str, Any], w: Dict[str, torch.Tensor], samples: List,
            pool: np.ndarray, device, batch: int, calib: List, bits=None):
    """Each sampled answer's distance from the float32 reference
    (``||got - want||``) and the reference's norm, by sample; with
    ``bits`` the reference served at that precision, calibrated on
    ``calib``, stands in for the answers."""
    with core.fp32():
        quant = ref.calibrated(w, calib, bits, device) if bits else None
        errs, norms = [], []
        for i in range(0, len(samples), REF_BLOCK):
            chunk = samples[i:i + REF_BLOCK]
            x = torch.from_numpy(np.stack([pool[v, p] for v, p, _, _ in
                                           chunk])).to(device)
            want = ref.forward(w, x).double()
            got = (ref.forward_served(w, x, quant) if bits else
                   torch.from_numpy(np.stack([y for _, _, y, _ in chunk]))
                   .to(device)).double()
            errs += torch.linalg.vector_norm(got - want,
                                             dim=(1, 2, 3)).tolist()
            norms += torch.linalg.vector_norm(want, dim=(1, 2, 3)).tolist()
        return errs, norms
