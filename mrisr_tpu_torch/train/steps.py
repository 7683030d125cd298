"""Train and eval steps of every family (counterpart:
``mrisr_tpu/train/steps.py``).

One step is forward in train mode, the loss, backward, the optimizer update;
the metrics stay tensors on the device, so an epoch fetches them to the host
once instead of once a step.  Convolutions run in full float32
(``fp32_reference``): cuDNN would otherwise compute them in TF32.  A train
step updates its states in place (module, optimizer, schedule, step count)
and leaves each parameter's gradient in ``.grad``.

Under a data mesh (``TrainState.mesh``, ``parallel/mesh.py``) each rank
steps on its rows of the global batch: the gradients are averaged over the
group before the clip, every random value (the diffusion timesteps and
noise) is drawn for the global batch and sliced, and the metrics are
averaged over the group, so every rank reports the global batch's (an
eval step given the whole batch on every rank, as the trainers' val
loaders give it, reports it unchanged).

- :func:`make_supervised_steps`: pair models (UNet, DeepCNN), batch
  ``(B, H, W, 3)`` = [pre, post, target].
- :func:`make_progressive_steps`: the Progressive UNet, batch
  ``(B, H, W, 5)``, three outputs.
- :func:`make_diffusion_steps` / :func:`make_simple_diffusion_steps`:
  epsilon prediction for the two Fast-DDPM lineages.  Each step takes a
  ``torch.Generator`` for its timestep and noise draws; the pure inner
  ``train_on``/``eval_on`` take the drawn values (the tests pass the JAX
  package's draws, which a torch generator cannot reproduce).
- :func:`make_gan_steps`: LSGAN alternating updates of the UNet generator
  and the PatchGAN.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from mrisr_tpu_torch.device import fp32_reference
from mrisr_tpu_torch.losses import l1, lsgan_d_loss, lsgan_g_loss, mse
from mrisr_tpu_torch.models.diffusion import q_sample
from mrisr_tpu_torch.parallel.mesh import average_gradients, mean_metrics
from mrisr_tpu_torch.train.state import TrainState

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
Metrics = Dict[str, torch.Tensor]


def _detached(loss: torch.Tensor, comps: Metrics) -> Metrics:
    return {"loss": loss.detach(), **{k: v.detach() for k, v in comps.items()}}


def _update(state: TrainState, loss: torch.Tensor, **backward) -> None:
    """Backward, the gradients averaged over the state's data group (one
    flat all-reduce; a no-op for one process), then the clip and the
    optimizer step (``TrainState.apply_gradients``)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward(**backward)
    average_gradients(list(state.module.parameters()), state.mesh)
    state.apply_gradients()


def _global_draw(draw: Callable, b: int, mesh) -> torch.Tensor:
    """``draw(n)`` for the global batch of which this rank holds ``b``
    rows, then this rank's rows: every rank draws the same values from the
    same stream, as JAX draws the whole batch from one key."""
    if mesh is None or mesh.size <= 1:
        return draw(b)
    n = b * mesh.size
    return draw(n)[mesh.rows(n)]


def _steps(loss_fn: LossFn, split: Callable):
    """Train and eval steps of a deterministic model: ``split(batch) ->
    (inputs, target)``, ``loss_fn(module(inputs), target)``."""

    def train_step(state: TrainState, batch: torch.Tensor
                   ) -> Tuple[TrainState, Metrics]:
        inputs, target = split(batch)
        with fp32_reference():
            loss, comps = loss_fn(state.module.train()(inputs), target)
            _update(state, loss)
        return state, mean_metrics(_detached(loss, comps), state.mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: torch.Tensor) -> Metrics:
        inputs, target = split(batch)
        with fp32_reference():
            loss, comps = loss_fn(state.module.eval()(inputs), target)
        return mean_metrics({"loss": loss, **comps}, state.mesh)

    return train_step, eval_step


def make_supervised_steps(loss_fn: LossFn):
    """``(train_step, eval_step)`` for pair-input models, batch
    ``(B, H, W, 3)`` = [pre, post, target].

    ``train_step(state, batch) -> (state, metrics)``; ``eval_step(state,
    batch) -> metrics`` runs the module in eval mode with no gradient.
    Metrics are ``{"loss", **components}``, detached device scalars."""
    return _steps(loss_fn, lambda b: (b[..., :2], b[..., 2:3]))


def make_progressive_steps(loss_fn: LossFn):
    """Steps of the 3-stage Progressive UNet: batch ``(B, H, W, 5)``, and
    ``loss_fn((p1, p2, p3), window)``."""
    return _steps(loss_fn, lambda b: (b, b))


# ----------------------------------------------------------------- diffusion


class _OnDevice:
    """A CPU table, copied once to each device it is asked for: a copy
    from pageable host memory waits for the stream, so one a step would
    stop the host from running ahead of the card."""

    def __init__(self, table: torch.Tensor):
        self.table, self.copies = table, {}

    def __call__(self, device: torch.device) -> torch.Tensor:
        if device not in self.copies:
            self.copies[device] = self.table.to(device)
        return self.copies[device]


def antithetic_draw(n_sel: int, b: int, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
    """The reference's antithetic timestep indices: ``b // 2 + 1`` uniform
    draws in [0, n_sel), their mirrors ``n_sel - t - 1`` appended, the
    whole truncated to ``b`` (for an even b the last mirror is dropped:
    the reference's quirk, kept)."""
    t = torch.randint(0, n_sel, (b // 2 + 1,), generator=generator,
                      device=device)
    return torch.cat([t, n_sel - t - 1])[:b]


def linspace_draw(n_sel: int, b: int, device: torch.device) -> torch.Tensor:
    """Validation indices ``floor(linspace(0, n_sel - 1, b))``, made on
    ``device``."""
    return torch.linspace(0.0, n_sel - 1, b, dtype=torch.float64,
                          device=device).floor().long()


def _diffusion_steps(n_sel: int, make_input: Callable):
    """``make_input(batch, t_idx, noise) -> (x_in, t)``; the loss is the
    MSE of the predicted noise (a model's first output channel: ADM's
    second, its learned variance, takes no loss here).  Returns ``(train_step, eval_step)`` with
    ``train_on``/``eval_on`` attached, the inner functions of the drawn
    values."""

    def train_on(state: TrainState, batch: torch.Tensor, t_idx: torch.Tensor,
                 noise: torch.Tensor) -> Tuple[TrainState, Metrics]:
        with fp32_reference():
            x_in, t = make_input(batch, t_idx, noise)
            loss = mse(state.module.train()(x_in, t)[..., :1], noise)
            _update(state, loss)
        return state, mean_metrics({"loss": loss.detach()}, state.mesh)

    @torch.no_grad()
    def eval_on(state: TrainState, batch: torch.Tensor, t_idx: torch.Tensor,
                noise: torch.Tensor) -> Metrics:
        with fp32_reference():
            x_in, t = make_input(batch, t_idx, noise)
            return mean_metrics(
                {"loss": mse(state.module.eval()(x_in, t)[..., :1], noise)},
                state.mesh)

    def _noise(batch, generator, mesh=None):
        b, h, w, _ = batch.shape
        return _global_draw(lambda n: torch.randn(
            (n, h, w, 1), generator=generator, device=batch.device,
            dtype=torch.float32), b, mesh)

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: torch.Generator) -> Tuple[TrainState, Metrics]:
        # the indices and the noise of the global batch (the antithetic
        # mirror depends on its size), this rank's rows of each
        t_idx = _global_draw(lambda n: antithetic_draw(
            n_sel, n, generator, batch.device), batch.shape[0], state.mesh)
        return train_on(state, batch, t_idx,
                        _noise(batch, generator, state.mesh))

    def eval_step(state: TrainState, batch: torch.Tensor,
                  generator: torch.Generator) -> Metrics:
        t_idx = linspace_draw(n_sel, batch.shape[0], batch.device)
        return eval_on(state, batch, t_idx, _noise(batch, generator))

    train_step.train_on, eval_step.eval_on = train_on, eval_on
    return train_step, eval_step


def make_diffusion_steps(schedule):
    """Fast-DDPM epsilon-prediction steps (the Fixed notebook's): training
    draws antithetic indices into the schedule's selected timesteps,
    validation the fixed linspace indices; the model sees the ORIGINAL
    timestep values and ``[pre, post, x_noisy]``.  The gradient clip lives
    in the train state (AdamW + clip 1.0)."""
    timesteps = _OnDevice(schedule.timesteps.long())
    abar = _OnDevice(schedule.alphas_cumprod)

    def make_input(batch, t_idx, noise):
        t = timesteps(batch.device)[t_idx]
        x_noisy = q_sample(abar(batch.device), batch[..., 2:3], t, noise)
        return torch.cat([batch[..., :2], x_noisy], dim=-1), t

    return _diffusion_steps(schedule.num_inference_steps, make_input)


def make_simple_diffusion_steps(schedule):
    """Steps of the M10 "simple" lineage: the timesteps are the compressed
    indices 0..T-1, noised by ``FastNoiseSchedule.q_sample``, and the
    model sees ``[x_noisy, pre, post]`` (x FIRST)."""

    abar = _OnDevice(schedule.alphas_cumprod)

    def make_input(batch, t_idx, noise):
        x_noisy = q_sample(abar(batch.device), batch[..., 2:3], t_idx, noise)
        return torch.cat([x_noisy, batch[..., :2]], dim=-1), t_idx

    return _diffusion_steps(schedule.T, make_input)


# ----------------------------------------------------------------------- GAN


def make_gan_steps(perceptual_fn: Optional[Callable] = None,
                   lambda_l1: float = 1.0, lambda_perceptual: float = 0.1,
                   lambda_adversarial: float = 0.01):
    """LSGAN alternating updates, as the JAX package's ``make_gan_steps``:

    1. D's fake comes from G in EVAL mode (running statistics), detached.
    2. D updates in train mode on real then fake: its BatchNorm running
       statistics take the real batch's update, then the fake batch's
       starting from it.
    3. G updates in train mode against the already updated D, run in eval
       mode: ``lambda_l1 * l1 + lambda_adversarial * adv [+
       lambda_perceptual * perc]``; D's parameters take no gradient.

    ``train_step(g_state, d_state, batch) -> (g_state, d_state, metrics)``
    with the keys g/d/l1/adv[/perc]; ``eval_step(g_state, d_state, batch)``
    returns l1_loss/adv_loss/d_loss[/perc_loss]/g_loss."""

    def g_objective(fake, target, d_fake):
        adv = lsgan_g_loss(d_fake)
        rec = l1(fake, target)
        total = lambda_l1 * rec + lambda_adversarial * adv
        comps = {"l1": rec, "adv": adv}
        if perceptual_fn is not None:
            perc = perceptual_fn(fake, target)
            total = total + lambda_perceptual * perc
            comps["perc"] = perc
        return total, comps

    def train_step(g_state: TrainState, d_state: TrainState,
                   batch: torch.Tensor):
        inputs, target = batch[..., :2], batch[..., 2:3]
        gen, disc = g_state.module, d_state.module
        with fp32_reference():
            with torch.no_grad():
                fake_detached = gen.eval()(inputs)
            disc.train()
            d_real = disc(torch.cat([inputs, target], dim=-1))
            d_fake = disc(torch.cat([inputs, fake_detached], dim=-1))
            d_loss = lsgan_d_loss(d_real, d_fake)
            _update(d_state, d_loss)

            fake = gen.train()(inputs)
            g_loss, comps = g_objective(
                fake, target, disc.eval()(torch.cat([inputs, fake], dim=-1)))
            _update(g_state, g_loss, inputs=list(gen.parameters()))
        metrics = {"g": g_loss.detach(), "d": d_loss.detach(),
                   **{k: v.detach() for k, v in comps.items()}}
        return g_state, d_state, mean_metrics(metrics, g_state.mesh)

    @torch.no_grad()
    def eval_step(g_state: TrainState, d_state: TrainState,
                  batch: torch.Tensor) -> Metrics:
        inputs, target = batch[..., :2], batch[..., 2:3]
        gen, disc = g_state.module.eval(), d_state.module.eval()
        with fp32_reference():
            fake = gen(inputs)
            d_real = disc(torch.cat([inputs, target], dim=-1))
            d_fake = disc(torch.cat([inputs, fake], dim=-1))
            total, comps = g_objective(fake, target, d_fake)
            out = {"l1_loss": comps["l1"], "adv_loss": comps["adv"],
                   "d_loss": lsgan_d_loss(d_real, d_fake)}
            if "perc" in comps:
                out["perc_loss"] = comps["perc"]
            out["g_loss"] = total
        return mean_metrics(out, g_state.mesh)

    return train_step, eval_step
