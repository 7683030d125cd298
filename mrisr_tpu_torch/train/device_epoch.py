"""Training epochs that stay on the card (counterpart:
``mrisr_tpu/train/device_epoch.py``, one ``lax.scan`` an epoch there).

The split's normalized slices live on the device (a ``SliceBank`` with
``backend='device'``, bf16) and so does the epoch's sample plan.  Each epoch
draws one ``torch.randperm`` from a generator on the card, and every step
gathers its batch there, moves it to NHWC float32, augments it with draws
from the same generator and takes the train step; the metrics are averaged
on the card.  No batch crosses the host, and the host fetches the metrics
once an epoch.  Every trainer runs here through its own step of a batch
and the epoch's generator (the diffusion step draws its timesteps and
noise from it; the others ignore it).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from mrisr_tpu_torch.data.pipeline import SliceBank, _AugmentSpec


def epoch_seed(seed: int, epoch: int) -> int:
    """The generator seed of one epoch: a function of (seed, epoch) alone,
    so a resumed run draws what an uninterrupted one would."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


class DeviceEpochRunner:
    """Runs train epochs with the batches gathered on the card.

    bank: a SliceBank with backend='device'.
    plan_flat: ``(N, C)`` flat slice ids (the loader's ``plan_flat``).
    train_step: ``step(batch, generator) -> metrics``, one train step of
    the trainer's states, updated in place.
    sharding: ``parallel/mesh.py:batch_sharding`` of a data mesh: every
    rank draws the same permutation and augmentation (the global batch's)
    and gathers and steps only its rows (JAX pins the gathered batch to the
    'data' axis, and each chip reads its rows).
    """

    def __init__(self, bank: SliceBank, plan_flat: np.ndarray,
                 train_step: Callable, batch_size: int,
                 augment: Optional[_AugmentSpec] = None, seed: int = 0,
                 sharding=None):
        if bank.backend != "device":
            raise ValueError("DeviceEpochRunner needs a device bank "
                             "(backend='device')")
        self.flat = bank.flat  # (S, H, W) on the device
        self.device = self.flat.device
        self.plan = torch.as_tensor(np.asarray(plan_flat, np.int64),
                                    device=self.device)
        self.sharding = sharding
        if sharding is not None and batch_size % sharding.size:
            raise ValueError(
                f"batch_size {batch_size} not divisible by the mesh's data "
                f"axis ({sharding.size})")
        self.batch_size = batch_size
        self.steps_per_epoch = int(plan_flat.shape[0]) // batch_size
        if self.steps_per_epoch <= 0:
            raise ValueError(f"batch_size {batch_size} exceeds the "
                             f"{plan_flat.shape[0]} samples available")
        self.train_step = train_step
        self.augment = augment or _AugmentSpec()
        self.seed = seed

    def run_epoch(self, epoch: int) -> Dict[str, torch.Tensor]:
        """One epoch of ``steps_per_epoch`` steps (the tail that does not
        fill a batch is dropped, as the scan does); returns the mean of
        each metric as a device scalar."""
        g = torch.Generator(self.device).manual_seed(
            epoch_seed(self.seed, epoch))
        perm = torch.randperm(self.plan.shape[0], generator=g,
                              device=self.device)
        bs, acc = self.batch_size, {}
        mine = (slice(0, bs) if self.sharding is None
                else self.sharding.rows(bs))
        for s in range(self.steps_per_epoch):
            idx = perm[s * bs:(s + 1) * bs][mine]
            rows = self.plan[idx]                                # (B, C)
            batch = self.flat[rows].permute(0, 2, 3, 1).float()  # NHWC
            batch = self.augment.apply(
                batch.contiguous(), g,
                None if self.sharding is None else mine, bs)
            metrics = self.train_step(batch, g)
            for k, v in metrics.items():
                acc.setdefault(k, []).append(v)
        return {k: torch.stack(v).double().mean() for k, v in acc.items()}
