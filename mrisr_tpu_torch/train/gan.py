"""UNet-GAN trainer: LSGAN with the conditional PatchGAN (counterpart:
``mrisr_tpu/train/gan.py``).

The preset's settings (``results/unet_gan_history.json``): lr_G = lr_D =
2e-4 (D's from ``train.learning_rate_d``), lambda l1/perc/adv = 1.0/0.1/
0.01, batch 4, augmentation on, early-stop patience 5.  G (the bias-free
UNet) is initialized from ``train.seed``, D from ``train.seed + 1``.  The
per-loss train histories are g/d/l1/perc/adv and the val ones
l1_loss/adv_loss/d_loss/perc_loss/g_loss, the artifact's keys; early
stopping reads G's objective.

A checkpoint holds both models in the reference's GAN layout::

    {epoch, generator_state_dict, discriminator_state_dict,
     g_/d_optimizer_state_dict, g_/d_scheduler_state_dict, g_/d_step,
     val_loss, best_loss}

``api.load_model("unet_gan")`` and the JAX package's converter read the
generator from it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mrisr_tpu_torch.ckpt.torch_ckpt import load_checkpoint_file
from mrisr_tpu_torch.config import Config
from mrisr_tpu_torch.device import DeviceLike, fp32_reference
from mrisr_tpu_torch.models.registry import init_model
from mrisr_tpu_torch.train.state import create_train_state
from mrisr_tpu_torch.train.steps import make_gan_steps
from mrisr_tpu_torch.train.trainer import (
    _EpochLoopMixin,
    compute_dtype,
    load_state,
    state_checkpoint,
)


class GANTrainer(_EpochLoopMixin):
    def __init__(self, config: Config, perceptual_fn: Optional[Callable] = None,
                 steps_per_epoch: Optional[int] = None,
                 device: DeviceLike = None, mesh=None):
        # mesh: G and D both replicated, both gradients averaged
        self._init_loop(config, device, mesh)
        tcfg = config.train
        # G and D both in the compute dtype, as the JAX trainer builds them
        dtype = compute_dtype(config)
        gen, _ = init_model("unet_gan", config.model, seed=tcfg.seed,
                            dtype=dtype)
        disc, _ = init_model("patchgan", config.model, seed=tcfg.seed + 1,
                             dtype=dtype)
        self.g_state = self._replicate(create_train_state(
            gen.to(self.device), tcfg, steps_per_epoch=steps_per_epoch))
        self.d_state = self._replicate(create_train_state(
            disc.to(self.device), tcfg, steps_per_epoch=steps_per_epoch,
            learning_rate=tcfg.learning_rate_d))
        lcfg = config.loss
        self.train_step, self.eval_step = make_gan_steps(
            perceptual_fn=perceptual_fn, lambda_l1=lcfg.lambda_l1,
            lambda_perceptual=lcfg.lambda_perceptual,
            lambda_adversarial=lcfg.lambda_adversarial)

    def _train(self, batch, generator):
        return self.train_step(self.g_state, self.d_state, batch)[-1]

    def _eval(self, batch, generator):
        return self.eval_step(self.g_state, self.d_state, batch)

    def _epoch_metrics(self, out: Dict[str, float]) -> Dict[str, float]:
        # the epoch loop's 'loss' (early stopping, best checkpoint) is G's
        # objective, the reference's val g_loss criterion
        out["loss"] = out.get("g", out.get("g_loss", 0.0))
        return out

    @torch.no_grad()
    def predict(self, inputs: torch.Tensor) -> torch.Tensor:
        """The generator: ``(B, H, W, 2) -> (B, H, W, 1)``, eval mode."""
        with fp32_reference():
            return self.g_state.module.eval()(inputs.to(self.device))

    def _checkpoint(self, epoch: int, best_loss: float,
                    val_loss: float) -> dict:
        ckpt = state_checkpoint(self.g_state, "unet_gan", epoch, val_loss,
                                "generator_state_dict", "g_")
        ckpt.update(state_checkpoint(self.d_state, "patchgan", epoch,
                                     val_loss, "discriminator_state_dict",
                                     "d_"))
        ckpt["best_loss"] = float(best_loss)
        return ckpt

    def load(self, path: str) -> None:
        ckpt = load_checkpoint_file(path)
        load_state(self.g_state, ckpt, "generator_state_dict", "g_")
        load_state(self.d_state, ckpt, "discriminator_state_dict", "d_")
        self._resume_point(ckpt)
