"""Train and eval steps of the pair models (counterpart:
``mrisr_tpu/train/steps.py:make_supervised_steps``).

One step is forward in train mode, the loss, backward, the optimizer update;
the metrics stay tensors on the device, so an epoch fetches them to the host
once instead of once a step.  Convolutions run in full float32
(``fp32_reference``): cuDNN would otherwise compute them in TF32.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from mrisr_tpu_torch.device import fp32_reference
from mrisr_tpu_torch.train.state import TrainState

LossFn = Callable[[torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
Metrics = Dict[str, torch.Tensor]


def make_supervised_steps(loss_fn: LossFn):
    """``(train_step, eval_step)`` for pair-input models, batch
    ``(B, H, W, 3)`` = [pre, post, target].

    ``train_step(state, batch) -> (state, metrics)`` updates ``state`` in
    place (its module, optimizer, schedule and step) and leaves each
    parameter's gradient in ``.grad``; ``eval_step(state, batch) ->
    metrics`` runs the module in eval mode with no gradient.  Metrics are
    ``{"loss", **components}``, detached device scalars."""

    def train_step(state: TrainState, batch: torch.Tensor
                   ) -> Tuple[TrainState, Metrics]:
        inputs, target = batch[..., :2], batch[..., 2:3]
        module = state.module.train()
        with fp32_reference():
            pred = module(inputs)
            loss, comps = loss_fn(pred, target)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        state.apply_gradients()
        return state, {"loss": loss.detach(),
                       **{k: v.detach() for k, v in comps.items()}}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: torch.Tensor) -> Metrics:
        inputs, target = batch[..., :2], batch[..., 2:3]
        with fp32_reference():
            pred = state.module.eval()(inputs)
            loss, comps = loss_fn(pred, target)
        return {"loss": loss, **comps}

    return train_step, eval_step
