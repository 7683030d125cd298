"""Fast-DDPM trainer for both lineages (counterpart:
``mrisr_tpu/train/diffusion.py``).

- 'fastddpm' (M11; presets ``fastddpm``, ``fastddpm_cosine128``,
  ``fastddpm_large``): ``FastDDPMUNet`` at the preset's width, the
  1000-step schedule with its selected timesteps, antithetic train draws,
  fixed linspace validation draws, ancestral sampling.
- 'fastddpm_simple' (M10): ``SimpleDiffusionUNet``, the compressed-T
  ``FastNoiseSchedule``, ``[x, cond]`` input order, DDIM sampling.
- 'fastddpm_pmub' (the port's own): ``DDPMUNet``, Fast-DDPM's published
  network, trained as the 'fastddpm' lineage is.

The module is the registry's build of the config's model name.

AdamW with a global-norm clip of 1.0 (``train/state.py``).  The model
computes in the config's compute dtype; the timesteps, the noise and
``q_sample`` stay float32, as the JAX steps draw them.  Every draw of a
step (timesteps and noise) comes from a generator seeded from (seed,
epoch, train or val, batch index) alone, so a resumed run draws what an
unbroken one would; the card-side epochs (``--scan-epochs``) draw from the
epoch's generator (``train/device_epoch.py:epoch_seed``).  Under a mesh
every rank draws the global batch's values and keeps its rows
(``train/steps.py``).  Checkpoints
are the single-model layout of ``train/trainer.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mrisr_tpu_torch.config import Config
from mrisr_tpu_torch.device import DeviceLike, fp32_reference
from mrisr_tpu_torch.models.diffusion import (
    DiffusionSchedule,
    FastNoiseSchedule,
    sample_ancestral,
    sample_ddim,
)
from mrisr_tpu_torch.models.registry import init_model
from mrisr_tpu_torch.train.state import create_train_state
from mrisr_tpu_torch.train.steps import (
    make_diffusion_steps,
    make_simple_diffusion_steps,
)
from mrisr_tpu_torch.train.trainer import _SingleStateTrainer, compute_dtype


def batch_seed(seed: int, epoch: int, train: bool, index: int) -> int:
    """The generator seed of one loader batch's draws."""
    return int(np.random.SeedSequence(
        [seed, epoch, 0 if train else 1, index]).generate_state(1)[0])


class DiffusionTrainer(_SingleStateTrainer):
    def __init__(self, config: Config, steps_per_epoch: Optional[int] = None,
                 device: DeviceLike = None, mesh=None):
        self._init_loop(config, device, mesh)
        mcfg = config.model
        self.simple = mcfg.name == "fastddpm_simple"
        module, _ = init_model(mcfg.name, mcfg, seed=config.train.seed,
                               dtype=compute_dtype(config))
        self.state = self._replicate(create_train_state(
            module.to(self.device), config.train,
            steps_per_epoch=steps_per_epoch))
        if self.simple:
            self.schedule = FastNoiseSchedule.create(mcfg.num_inference_steps)
            steps = make_simple_diffusion_steps(self.schedule)
        else:
            self.schedule = DiffusionSchedule.create(
                num_timesteps=mcfg.num_timesteps,
                num_inference_steps=mcfg.num_inference_steps,
                beta_schedule=mcfg.beta_schedule,
                selection=mcfg.timestep_selection)
            steps = make_diffusion_steps(self.schedule)
        self.train_step, self.eval_step = steps

    def _generator(self, epoch: int, train: bool, index: int):
        return torch.Generator(self.device).manual_seed(
            batch_seed(self.config.train.seed, epoch, train, index))

    def _train(self, batch, generator):
        return self.train_step(self.state, batch, generator)[1]

    def _eval(self, batch, generator):
        return self.eval_step(self.state, batch, generator)

    @torch.no_grad()
    def sample(self, cond: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               num_samples: int = 3, combine: str = "first",
               noise=None) -> torch.Tensor:
        """cond ``(B, H, W, 2)`` [pre, post] -> the generated middle
        ``(B, H, W, 1)``: the ancestral chain (``combine`` 'first': the
        Fixed notebook's default, 'mean' the v2 variant), or DDIM for the
        simple lineage (deterministic given x_T, so one chain).
        ``generator`` (None: seeded 0) or ``noise`` gives the draws."""
        module = self.state.module.eval()
        cond = cond.to(self.device, torch.float32)
        with fp32_reference():
            if self.simple:
                return sample_ddim(module, cond, generator, self.schedule,
                                   noise=noise)
            return sample_ancestral(module, cond, generator, self.schedule,
                                    num_samples=num_samples, combine=combine,
                                    noise=noise)
