"""Train state and optimizer construction (counterpart:
``mrisr_tpu/train/state.py``).

The optimizers follow the reference configs as the JAX package builds them
with optax: Adam (the UNet family), AdamW with a global-norm gradient clip
of 1.0 (diffusion), an optional cosine learning-rate decay.  Where torch's
building blocks differ from optax's, this module writes optax's rule:

- AdamW decays every parameter (optax's ``adamw`` with no mask);
- the clip scales by ``max_norm / g_norm`` only when ``g_norm >= max_norm``
  (``clip_by_global_norm``); ``torch.nn.utils.clip_grad_norm_`` divides by
  ``g_norm + 1e-6`` instead;
- the cosine schedule is ``optax.cosine_decay_schedule``'s closed form,
  ``lr * (1 + cos(pi * min(t, T) / T)) / 2`` with t the count of updates
  before this one, as a ``LambdaLR`` (``CosineAnnealingLR`` recurses and
  drifts).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR

from mrisr_tpu_torch.config import TrainConfig


def make_optimizer(
    cfg: TrainConfig,
    params: Iterable[torch.Tensor],
    steps_per_epoch: Optional[int] = None,
    learning_rate: Optional[float] = None,
) -> Tuple[torch.optim.Optimizer, Optional[LambdaLR]]:
    """(optimizer, schedule or None) for ``params``: Adam or AdamW (betas
    0.9 / 0.999, eps 1e-8, optax's defaults) at ``learning_rate`` (None:
    ``cfg.learning_rate``), with the cosine decay over ``cfg.epochs *
    steps_per_epoch`` updates when ``cfg.lr_schedule`` is 'cosine'."""
    lr = cfg.learning_rate if learning_rate is None else learning_rate
    if cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    else:
        raise ValueError(cfg.optimizer)
    schedule = None
    if cfg.lr_schedule == "cosine":
        if steps_per_epoch:
            total = cfg.epochs * steps_per_epoch
            schedule = LambdaLR(opt, lambda t: 0.5 * (1.0 + math.cos(
                math.pi * min(t, total) / total)))
        else:
            warnings.warn("lr_schedule='cosine' requires steps_per_epoch; "
                          "falling back to a constant learning rate",
                          stacklevel=2)
    return opt, schedule


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: every gradient becomes
    ``(g / g_norm) * max_norm`` when ``g_norm >= max_norm``, with no host
    synchronization."""
    if not grads:
        return
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = g_norm < max_norm
    one = torch.ones_like(g_norm)
    torch._foreach_div_(grads, torch.where(keep, one, g_norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))


@dataclass
class TrainState:
    """A module with its optimizer, its schedule (or None), the clip norm
    (0: none), the count of updates taken and, for the distillation
    student, ``ema_params``: an exponential moving average of the
    parameters by name (None: no average), and ``mesh``, the data group
    the gradients are averaged over (None: one process).  BatchNorm running statistics
    are not averaged: the live module's are shared."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Optional[LambdaLR] = None
    grad_clip_norm: float = 0.0
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    # the data group (parallel/mesh.py): the gradients are averaged over
    # it before the clip; None or one rank: the unmeshed program
    mesh: Optional[object] = None

    def seed_ema(self) -> None:
        """Start the average at the current parameters, as a copy."""
        self.ema_params = {n: p.detach().clone()
                           for n, p in self.module.named_parameters()}

    @torch.no_grad()
    def update_ema(self, decay: float) -> None:
        """``ema = decay * ema + (1 - decay) * p`` for every parameter, as
        two products and a sum (the JAX step's arithmetic; ``lerp`` rounds
        otherwise)."""
        names = list(self.ema_params)
        ema = [self.ema_params[n] for n in names]
        live = dict(self.module.named_parameters())
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(
            [live[n].detach() for n in names], 1.0 - decay))

    def apply_gradients(self) -> None:
        """Clip the gradients the last backward left, take one optimizer
        step, advance the schedule."""
        if self.grad_clip_norm and self.grad_clip_norm > 0:
            clip_by_global_norm_([p.grad for p in self.module.parameters()
                                  if p.grad is not None], self.grad_clip_norm)
        self.optimizer.step()
        if self.schedule is not None:
            self.schedule.step()
        self.step += 1


def create_train_state(module: nn.Module, cfg: TrainConfig,
                       steps_per_epoch: Optional[int] = None,
                       learning_rate: Optional[float] = None) -> TrainState:
    opt, schedule = make_optimizer(cfg, module.parameters(),
                                   steps_per_epoch=steps_per_epoch,
                                   learning_rate=learning_rate)
    return TrainState(module=module, optimizer=opt, schedule=schedule,
                      grad_clip_norm=cfg.grad_clip_norm)
