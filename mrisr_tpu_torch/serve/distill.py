"""Serving distillation: train a reduced-width UNet student against a
trained teacher (counterpart: ``mrisr_tpu/serve/distill.py``).

The half-width student (``unet_distilled``: features 32, ~7.8 M
parameters) costs about a quarter of the M2 UNet's operations with the same
receptive field; it is distilled from the trained 31 M teacher.

Loss: ``alpha * MSE(student, teacher(x)) + (1 - alpha) * MSE(student, gt)``
[+ ``lambda_ssim * (1 - SSIM(student, teacher))``].  The teacher runs
frozen and BN-folded inside the train step, with no gradient: float32 over
bf16-rounded weights (``quant='none'``), or the int8 serving forward
(kernel A alone for 'int8', kernels A and B for 'int8_fused') calibrated on
a few validation batches.  With ``ema_decay`` the train step keeps an
exponential moving average of the student's parameters, the eval step
scores it, and the checkpoints carry it as the served model.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mrisr_tpu_torch.config import Config
from mrisr_tpu_torch.device import DeviceLike, fp32_reference
from mrisr_tpu_torch.losses import mse, ssim_loss
from mrisr_tpu_torch.parallel.mesh import mean_metrics
from mrisr_tpu_torch.train.state import TrainState
from mrisr_tpu_torch.train.steps import Metrics, _update
from mrisr_tpu_torch.train.trainer import SupervisedTrainer

TeacherFn = Callable[[torch.Tensor], torch.Tensor]


def make_distill_steps(teacher_fn: TeacherFn, alpha: float = 0.5,
                       lambda_ssim: float = 0.0, ema_decay: float = 0.0):
    """``(train_step, eval_step)`` for pair-input distillation, batch
    ``(B, H, W, 3)`` = [pre, post, target].

    ``teacher_fn`` is a frozen forward ``(B, H, W, 2) -> (B, H, W, 1)``
    float32.  Metrics: ``loss``, ``teacher_mse``, ``gt_mse`` and, with
    ``lambda_ssim``, ``ssim_loss``.  With ``ema_decay`` > 0 the train step
    updates ``state.ema_params`` after the optimizer step and the eval step
    runs the module with the averaged parameters (its live BatchNorm
    statistics)."""

    def objective(pred, t_pred, target):
        l_teacher = mse(pred, t_pred)
        l_gt = mse(pred, target)
        loss = alpha * l_teacher + (1.0 - alpha) * l_gt
        comps = {"teacher_mse": l_teacher, "gt_mse": l_gt}
        if lambda_ssim:
            l_ssim = ssim_loss(pred[..., 0], t_pred[..., 0])
            loss = loss + lambda_ssim * l_ssim
            comps["ssim_loss"] = l_ssim
        return loss, comps

    def train_step(state: TrainState, batch: torch.Tensor):
        inputs, target = batch[..., :2], batch[..., 2:3]
        with torch.no_grad():
            t_pred = teacher_fn(inputs)
        with fp32_reference():
            loss, comps = objective(state.module.train()(inputs), t_pred,
                                    target)
            _update(state, loss)
        if ema_decay:
            state.update_ema(ema_decay)
        return state, mean_metrics(
            {"loss": loss.detach(),
             **{k: v.detach() for k, v in comps.items()}}, state.mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: torch.Tensor) -> Metrics:
        inputs, target = batch[..., :2], batch[..., 2:3]
        t_pred = teacher_fn(inputs)
        module = state.module.eval()
        with fp32_reference():
            pred = (torch.func.functional_call(module, state.ema_params,
                                               (inputs,))
                    if ema_decay else module(inputs))
            loss, comps = objective(pred, t_pred, target)
        return mean_metrics({"loss": loss, **comps}, state.mesh)

    return train_step, eval_step


def make_teacher_fn(teacher_name: str = "unet", models_dir: str = "models",
                    cfg=None, quant: str = "none", calibration_batches=None,
                    device: DeviceLike = None) -> TeacherFn:
    """Frozen BN-folded forward of a trained pair-model checkpoint on
    ``device`` (``None``: the card), float32 out.

    quant='none': float32 over bf16-rounded weights (the serving engine's
    'none' forward, ``serve/engine.py``).  'int8' and 'int8_fused' distill
    against the quantized teacher, the exact serving numerics: the tables
    are calibrated on ``calibration_batches`` (a list of ``(B, H, W, 2)``
    inputs) and the forward is ``unet_int8_apply`` (kernel A) or the
    int8-resident forward (kernels A and B)."""
    from mrisr_tpu_torch.api import load_model
    from mrisr_tpu_torch.serve.engine import _bf16_weights_apply

    loaded = load_model(teacher_name, models_dir=models_dir,
                        checkpoint="required", cfg=cfg, fold_bn=True,
                        device=device)
    if loaded.kind != "pair":
        raise ValueError(
            f"distillation teacher must be a pair model; {teacher_name!r} "
            f"is kind={loaded.kind!r}")
    if quant == "none":
        return _bf16_weights_apply(loaded.module)
    if quant not in ("int8", "int8_fused"):
        raise ValueError(f"unknown teacher quant {quant!r}")
    if not calibration_batches:
        raise ValueError("a quantized teacher needs calibration_batches")
    from mrisr_tpu_torch.serve.quant import (
        Int8FusedUNet,
        Int8UNet,
        calibrate_unet,
        quantize_unet,
    )

    qparams = quantize_unet(loaded.module, calibrate_unet(
        loaded.module, calibration_batches))
    forward = (Int8FusedUNet if quant == "int8_fused" else Int8UNet)(
        qparams, device=loaded.device)

    @torch.no_grad()
    def teacher_fn(x: torch.Tensor) -> torch.Tensor:
        return forward(x).float()

    return teacher_fn


class DistillationTrainer(SupervisedTrainer):
    """``SupervisedTrainer`` with the distillation objective: the epoch
    loop, early stopping, checkpoints and history are inherited, and the
    student's ``<preset>_best.pt`` loads through ``api.load_model`` like
    any pair model.

    ``init_from_teacher`` starts the student as a magnitude-pruned channel
    slice of the teacher (``serve/prune.py``).  With ``loss.distill_ema``
    the average starts as a copy of the initial parameters, and every
    checkpoint holds the averaged weights as ``model_state_dict`` (the
    model the eval step scored and the one ``load_model`` serves) and the
    live weights as ``live_params``; ``load`` restores both."""

    def __init__(self, config: Config, teacher_fn: Optional[TeacherFn] = None,
                 teacher_name: str = "unet",
                 teacher_models_dir: str = "models", teacher_cfg=None,
                 teacher_quant: str = "none",
                 teacher_calibration_batches=None,
                 init_from_teacher: bool = False,
                 steps_per_epoch: Optional[int] = None,
                 device: DeviceLike = None, mesh=None):
        # mesh: the student data parallel; the teacher, frozen and equal on
        # every rank, runs on each rank's rows
        super().__init__(config, steps_per_epoch=steps_per_epoch,
                         device=device, mesh=mesh)
        if self.kind != "pair":
            raise ValueError("distillation supports pair models only")
        if init_from_teacher:
            from mrisr_tpu_torch.serve.prune import load_pruned_student_init

            load_pruned_student_init(teacher_name, teacher_models_dir,
                                     self.state.module, cfg=teacher_cfg,
                                     device=self.device)
        if teacher_fn is None:
            teacher_fn = make_teacher_fn(
                teacher_name, models_dir=teacher_models_dir, cfg=teacher_cfg,
                quant=teacher_quant,
                calibration_batches=teacher_calibration_batches,
                device=self.device)
        lcfg = config.loss
        self._ema_decay = lcfg.distill_ema
        if self._ema_decay:
            self.state.seed_ema()
        self.teacher_fn = teacher_fn
        self.train_step, self.eval_step = make_distill_steps(
            teacher_fn, alpha=lcfg.distill_alpha,
            lambda_ssim=lcfg.distill_lambda_ssim, ema_decay=self._ema_decay)

    def _make_steps(self, perceptual_fn):
        # the steps need the teacher, which __init__ builds after the
        # student: they are set there
        return None, None

    def _checkpoint(self, epoch: int, best_loss: float,
                    val_loss: float) -> Dict:
        from mrisr_tpu_torch.ckpt.torch_ckpt import reference_state_dict

        ckpt = super()._checkpoint(epoch, best_loss, val_loss)
        if self._ema_decay:
            name = self.config.model.name
            module = self.state.module
            ckpt["live_params"] = reference_state_dict(
                dict(module.named_parameters()), name)
            ckpt["model_state_dict"] = reference_state_dict(
                {**module.state_dict(), **self.state.ema_params}, name)
        return ckpt

    def load(self, path: str) -> None:
        from mrisr_tpu_torch.ckpt.torch_ckpt import (
            load_checkpoint_file,
            port_state_dict,
        )
        from mrisr_tpu_torch.train.trainer import load_state

        ckpt = load_checkpoint_file(path)
        load_state(self.state, ckpt)
        if self._ema_decay:
            # the module now holds the averaged weights: they seed the
            # average, and the live weights go back into the module
            self.state.seed_ema()
            live = port_state_dict(ckpt["live_params"])
            with torch.no_grad():
                for n, p in self.state.module.named_parameters():
                    p.copy_(live[n])
        self._resume_point(ckpt)
