"""Trainers: epoch loops with early stopping, checkpoints and history
(counterpart: ``mrisr_tpu/train/trainer.py``).

``SupervisedTrainer`` keeps UNetTrainer's contract (reference
``src/unet_model.py:148-298``): per-epoch train and val losses, early
stopping with a patience counter, ``<preset>_best`` / ``_latest`` /
``_epoch_<N>`` checkpoints, the history JSON and the loss-curve PNG.  It
trains the pair models (the UNets and DeepCNN) with the MSE or the combined
loss, and the Progressive UNet on 5-slice windows with the weighted
progressive loss.  ``train/gan.py`` and ``train/diffusion.py`` run their
families on the same loop (:class:`_EpochLoopMixin`).

A checkpoint is the reference's torch layout, Python scalars only::

    {epoch, model_state_dict (a pair UNet's 1x1 head as final_conv),
     optimizer_state_dict, scheduler_state_dict, step, val_loss, best_loss}

so ``api.load_model("unet_combined")`` reads ``unet_combined_best.pt`` as
it reads the reference's files, and ``try_resume`` continues from the
newest ``_epoch_<N>.pt``.

``train.compute_dtype='bfloat16'`` builds every model in bf16 compute
(flax's ``dtype=``, ``models/blocks.py``), as the JAX trainers do; the
parameters, the loss, the optimizer and the checkpoints stay float32.

``mesh=`` (``parallel/mesh.py``, the JAX trainers' ``mesh=``): data
parallel over the mesh's ranks.  The models are replicated from the first
rank (with cross-rank BatchNorm statistics), each step averages the
gradients, the train loader yields each rank's rows of the global batch,
and the epoch metrics are averaged over the group, so every rank takes
the same early-stopping decision.  With a 'model' axis each model
coordinate's data group runs that same program.  Only the mesh's first
rank writes checkpoints and the history; every rank waits at a barrier
after a save, and every rank loads on ``--resume``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch

from mrisr_tpu_torch.ckpt.io import (
    get_latest_checkpoint,
    save_checkpoint,
    wait_for_async_saves,
)
from mrisr_tpu_torch.ckpt.torch_ckpt import (
    load_checkpoint_file,
    load_reference_state_dict,
    reference_checkpoint,
)
from mrisr_tpu_torch.config import Config
from mrisr_tpu_torch.device import DeviceLike, fp32_reference, resolve_device
from mrisr_tpu_torch.losses import combined_loss, mse, progressive_loss
from mrisr_tpu_torch.models.registry import init_model
from mrisr_tpu_torch.parallel.mesh import batch_sharding, replicated
from mrisr_tpu_torch.train.history import TrainingHistory
from mrisr_tpu_torch.train.state import TrainState, create_train_state
from mrisr_tpu_torch.train.steps import (
    make_progressive_steps,
    make_supervised_steps,
)


def compute_dtype(config: Config) -> torch.dtype:
    """The models' compute dtype: bf16 for ``train.compute_dtype ==
    'bfloat16'``, else float32, as the JAX trainers read it."""
    return (torch.bfloat16 if config.train.compute_dtype == "bfloat16"
            else torch.float32)


class _EpochLoopMixin:
    """Shared epoch loop: early stopping, best/latest/epoch_N checkpoints,
    history."""

    config: Config
    history: TrainingHistory

    def _init_loop(self, config: Config, device: DeviceLike,
                   mesh=None) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh
        self._device_runner = None
        self.history = TrainingHistory(json.loads(config.to_json()))
        # one entry a run_epoch: {epoch, train, steps, seconds}, the host
        # clock up to the epoch's one metrics fetch
        self.timings: List[Dict] = []

    def _replicate(self, state: TrainState) -> TrainState:
        """``state`` replicated over the trainer's mesh (a no-op without
        one): the module broadcast from the first rank, its BatchNorms
        cross-rank, its gradients averaged over the group."""
        if self.mesh is not None:
            replicated(state.module, self.mesh)
            state.mesh = self.mesh
        return state

    @property
    def _writes(self) -> bool:
        """True on the rank that writes checkpoints and the history: the
        mesh's first (data and model coordinate 0)."""
        return self.mesh is None or self.mesh.first

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def enable_device_epochs(self, bank, plan_flat) -> None:
        """Run the train epochs with the batches gathered on the card
        (``train/device_epoch.py``): ``bank`` is a device-backend SliceBank
        and ``plan_flat`` the loader's flat slice plan.  Validation keeps
        the loader."""
        from mrisr_tpu_torch.data.pipeline import _AugmentSpec
        from mrisr_tpu_torch.train.device_epoch import DeviceEpochRunner

        self._device_runner = DeviceEpochRunner(
            bank, plan_flat, self._train,
            batch_size=self.config.data.batch_size,
            augment=_AugmentSpec.from_config(self.config.data),
            seed=self.config.train.seed,
            sharding=None if self.mesh is None else batch_sharding(self.mesh))

    # a trainer defines _train and _eval (one batch, with the generator of
    # its draws) and _checkpoint / load
    def _train(self, batch, generator) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _eval(self, batch, generator) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _generator(self, epoch: int, train: bool,
                   index: int) -> Optional[torch.Generator]:
        """The generator of a loader batch's draws (None: a step that
        draws nothing)."""
        return None

    def _epoch_metrics(self, out: Dict[str, float]) -> Dict[str, float]:
        """The fetched epoch means; a trainer whose metrics have no 'loss'
        names the one early stopping reads."""
        return out

    def run_epoch(self, loader, train: bool, epoch: int) -> Dict[str, float]:
        t0 = time.perf_counter()
        if train and self._device_runner is not None:
            means = self._device_runner.run_epoch(epoch)
            steps = self._device_runner.steps_per_epoch
        else:
            step = self._train if train else self._eval
            acc: Dict[str, list] = {}
            steps = 0
            for i, batch in enumerate(loader):
                g = self._generator(epoch, train, i)
                for k, v in step(batch, g).items():
                    acc.setdefault(k, []).append(v)
                steps += 1
            means = {k: torch.stack(v).double().mean()
                     for k, v in acc.items()}
        # each step's metrics are already the group's mean, so every rank
        # reads the same numbers (and takes the same early-stopping call)
        # the epoch's one host fetch
        out = (dict(zip(means, torch.stack(list(means.values())).tolist()))
               if means else {})
        self.timings.append({"epoch": epoch, "train": train, "steps": steps,
                             "seconds": time.perf_counter() - t0})
        return self._epoch_metrics(out)

    def save(self, path: str, epoch: int, best_loss: float, val_loss: float,
             async_: bool = False) -> None:
        """Write a checkpoint (the first rank of a mesh only; every rank
        then waits at a barrier)."""
        if self._writes:
            save_checkpoint(path, self._checkpoint(epoch, best_loss,
                                                   val_loss), async_=async_)
        self._barrier()

    def _resume_point(self, ckpt: dict) -> None:
        self.best_loss = float(ckpt.get("best_loss", ckpt.get(
            "val_loss", float("inf"))))
        self.start_epoch = int(ckpt.get("epoch", 0)) + 1

    def _ckpt_path(self, suffix: str) -> str:
        d = self.config.train.checkpoint_dir
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{self.config.preset}_{suffix}.pt")

    def try_resume(self) -> bool:
        """Resume from the newest ``<preset>_epoch_<N>.pt``, else from
        ``<preset>_latest.pt``."""
        found = get_latest_checkpoint(self.config.train.checkpoint_dir,
                                      self.config.preset)
        path = found[0] if found is not None else None
        if path is None and os.path.isfile(self._ckpt_path("latest")):
            path = self._ckpt_path("latest")
        if path is None:
            return False
        self.load(path)
        self._restore_history()
        return True

    def _restore_history(self) -> None:
        """Reload the epoch series up to the resumed epoch from the run's
        history JSON, so a resumed run keeps one continuous history."""
        hist_path = os.path.join(self.config.train.results_dir,
                                 f"{self.config.preset}_history.json")
        if not os.path.exists(hist_path):
            return
        try:
            with open(hist_path) as f:
                prior = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        cutoff = getattr(self, "start_epoch", 1) - 1
        keep = sum(1 for e in prior.get("epoch", []) if e <= cutoff)
        for k, v in prior.items():
            if isinstance(v, list) and v and isinstance(v[0], (int, float)):
                self.history.series[k] = [float(x) for x in v[:keep]]

    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            epochs: Optional[int] = None, verbose: bool = True
            ) -> TrainingHistory:
        epochs = epochs or self.config.train.epochs
        verbose = verbose and self._writes  # one rank of a mesh prints
        tcfg = self.config.train
        patience = tcfg.early_stopping_patience
        best_loss = getattr(self, "best_loss", float("inf"))
        patience_counter = 0
        start_epoch = getattr(self, "start_epoch", 1)
        # bound before the loop: light mode saves 'latest' after it even
        # when no epoch ran
        epoch = start_epoch - 1
        for epoch in range(start_epoch, epochs + 1):
            t_epoch = time.perf_counter()
            train_metrics = self.run_epoch(train_loader, train=True,
                                           epoch=epoch)
            val_metrics = (train_metrics if val_loader is None else
                           self.run_epoch(val_loader, train=False,
                                          epoch=epoch))
            self.history.append(epoch=epoch,
                                train_loss=train_metrics["loss"],
                                val_loss=val_metrics["loss"],
                                epoch_time_s=time.perf_counter() - t_epoch)
            for k, v in train_metrics.items():
                if k != "loss":
                    self.history.append(**{f"train_{k}": v})
            if val_loader is not None:
                for k, v in val_metrics.items():
                    if k != "loss":
                        self.history.append(**{f"val_{k}": v})
            val_loss = val_metrics["loss"]
            if verbose:
                print(f"Epoch {epoch}/{epochs} | train "
                      f"{train_metrics['loss']:.4f} | val {val_loss:.4f}",
                      end="")
            if val_loss < best_loss:
                best_loss = val_loss
                patience_counter = 0
                # light mode: best goes through the async writer, flushed
                # before fit() returns
                self.save(self._ckpt_path("best"), epoch, best_loss,
                          val_loss, async_=tcfg.light_checkpoints)
                if verbose:
                    print("  (best)")
            else:
                patience_counter += 1
                if verbose:
                    print(f"  (patience {patience_counter}/{patience})")
            if not tcfg.light_checkpoints:
                self.save(self._ckpt_path("latest"), epoch, best_loss,
                          val_loss)
            if tcfg.save_every_epoch:
                # resume snapshots through the async writer: the step loop
                # does not wait for the disk
                self.save(self._ckpt_path(f"epoch_{epoch}"), epoch,
                          best_loss, val_loss, async_=True)
            if patience and patience_counter >= patience:
                if verbose:
                    print(f"Early stopping after {epoch} epochs")
                break

        if tcfg.light_checkpoints:
            # the one resumable state light mode keeps
            last = self.history.series.get("val_loss") or [best_loss]
            self.save(self._ckpt_path("latest"), epoch, best_loss, last[-1])
        # a resume right after fit() sees the newest epoch checkpoint
        wait_for_async_saves()
        self.best_loss = best_loss
        self.history.set(best_val_loss=best_loss)
        if self._writes:
            rd = tcfg.results_dir
            os.makedirs(rd, exist_ok=True)
            self.history.save_json(os.path.join(
                rd, f"{self.config.preset}_history.json"))
            self.history.save_curves_png(
                os.path.join(rd, f"{self.config.preset}_training_curves.png"),
                title=f"{self.config.preset} training")
        self._barrier()
        return self.history


def state_checkpoint(state: TrainState, model_name: str, epoch: int,
                     val_loss: float, sd_key: str = "model_state_dict",
                     prefix: str = "") -> dict:
    """One train state in the reference layout: the module under
    ``sd_key`` (a pair UNet's head under the reference's name), its
    optimizer, schedule and update count under ``<prefix>optimizer_
    state_dict``, ``<prefix>scheduler_state_dict`` and ``<prefix>step``."""
    ckpt = reference_checkpoint(state.module, model_name, epoch=epoch,
                                val_loss=val_loss)
    ckpt[sd_key] = ckpt.pop("model_state_dict")
    ckpt.update({
        f"{prefix}optimizer_state_dict": state.optimizer.state_dict(),
        f"{prefix}scheduler_state_dict": (state.schedule.state_dict()
                                          if state.schedule is not None
                                          else None),
        f"{prefix}step": int(state.step)})
    return ckpt


def load_state(state: TrainState, ckpt: dict,
               sd_key: str = "model_state_dict", prefix: str = "") -> None:
    """The inverse of :func:`state_checkpoint` into ``state``."""
    load_reference_state_dict(state.module,
                              ckpt[sd_key] if sd_key in ckpt else ckpt)
    if ckpt.get(f"{prefix}optimizer_state_dict") is not None:
        state.optimizer.load_state_dict(ckpt[f"{prefix}optimizer_state_dict"])
    if state.schedule is not None and ckpt.get(
            f"{prefix}scheduler_state_dict"):
        state.schedule.load_state_dict(ckpt[f"{prefix}scheduler_state_dict"])
    state.step = int(ckpt.get(f"{prefix}step", 0))


class _SingleStateTrainer(_EpochLoopMixin):
    """A trainer of one model: ``self.state``, checkpointed as
    ``model_state_dict``."""

    state: TrainState

    def _checkpoint(self, epoch: int, best_loss: float,
                    val_loss: float) -> dict:
        ckpt = state_checkpoint(self.state, self.config.model.name, epoch,
                                val_loss)
        ckpt["best_loss"] = float(best_loss)
        return ckpt

    def load(self, path: str) -> None:
        ckpt = load_checkpoint_file(path)
        load_state(self.state, ckpt)
        self._resume_point(ckpt)


class SupervisedTrainer(_SingleStateTrainer):
    """MSE or combined-loss training of a pair model (the UNets, DeepCNN),
    or progressive-loss training of the Progressive UNet on windows, on
    ``device`` (``None``: the card), initialized as the JAX package
    initializes it (``models/registry.py:init_model``, seed
    ``train.seed``), in the config's compute dtype; ``mesh``: data
    parallel over its ranks."""

    def __init__(self, config: Config, perceptual_fn: Optional[Callable] = None,
                 steps_per_epoch: Optional[int] = None,
                 device: DeviceLike = None, mesh=None):
        self._init_loop(config, device, mesh)
        module, self.kind = init_model(config.model.name, config.model,
                                       seed=config.train.seed,
                                       dtype=compute_dtype(config))
        self.state = self._replicate(create_train_state(
            module.to(self.device), config.train,
            steps_per_epoch=steps_per_epoch))
        self.train_step, self.eval_step = self._make_steps(perceptual_fn)

    def _make_steps(self, perceptual_fn: Optional[Callable]):
        """``(train_step, eval_step)`` of the config's loss."""
        lcfg = self.config.loss
        if self.kind == "window":
            def loss_fn(preds, window):
                return progressive_loss(preds, window, lcfg.w_i1, lcfg.w_i2,
                                        lcfg.w_i3)
            steps = make_progressive_steps(loss_fn)
        elif lcfg.kind == "combined":
            def loss_fn(pred, target):
                return combined_loss(
                    pred, target, perceptual_fn=perceptual_fn,
                    lambda_perceptual=lcfg.lambda_perceptual,
                    lambda_ssim=lcfg.lambda_ssim)
            steps = make_supervised_steps(loss_fn)
        elif lcfg.kind == "mse":
            steps = make_supervised_steps(lambda p, t: (mse(p, t), {}))
        else:
            raise ValueError(
                f"loss kind {lcfg.kind!r} is not a supervised loss: the GAN "
                "trains with train/gan.py, diffusion with train/diffusion.py, "
                "distillation with serve/distill.py")
        return steps

    def _train(self, batch, generator):
        return self.train_step(self.state, batch)[1]

    def _eval(self, batch, generator):
        return self.eval_step(self.state, batch)

    @torch.no_grad()
    def predict(self, inputs: torch.Tensor):
        """``(B, H, W, 2) -> (B, H, W, 1)`` (a window model: ``(B, H, W,
        5) -> (p1, p2, p3)``), eval mode, float32 out (computed in the
        model's compute dtype)."""
        with fp32_reference():
            return self.state.module.eval()(inputs.to(self.device))
