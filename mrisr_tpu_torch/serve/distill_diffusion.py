"""Progressive step-distillation of the Fast-DDPM sampler, T = 10 -> 5 -> 3
(counterpart: ``mrisr_tpu/serve/distill_diffusion.py``).

Serving a diffusion model costs T sequential UNet forwards a slice, so the
remaining lever is fewer steps.  Progressive distillation (Salimans & Ho
2022, on the Fixed lineage's ``DiffusionSchedule`` grid): one student DDIM
step from grid point t down ``factor`` positions must reproduce the
teacher's ``factor`` consecutive DDIM sub-steps.  Given the teacher's
result x'' between the noise levels abar_t and abar'', the (x0*, eps*)
pair a single DDIM step needs is solved in closed form
(:func:`solve_x0_target`), and the student, still an eps-predicting
``FastDDPMUNet``, regresses onto eps* (default) or onto x0* with the
truncated-SNR weight.  Each round halves the grid.

The frozen teacher is the module in float32 over bf16-rounded weights:
flax's promotion of a float32 module's bf16 parameters computes in float32,
GroupNorm statistics included.  The train step draws the student step
indices ``m`` and the noise from a ``torch.Generator``; the pure inner
``train_on``/``eval_on`` take them as arguments (the tests pass the JAX
package's draws).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mrisr_tpu_torch.config import TrainConfig
from mrisr_tpu_torch.device import fp32_reference
from mrisr_tpu_torch.models.diffusion import DiffusionSchedule
from mrisr_tpu_torch.train.state import TrainState, create_train_state
from mrisr_tpu_torch.train.steps import _OnDevice, _update, linspace_draw

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# --------------------------------------------------------------------- grids


def grid_positions(n_steps: int, factor: int) -> np.ndarray:
    """Student-grid positions into a length-``n_steps`` teacher grid:
    every ``factor``-th position descending from the top noise level
    (sampling starts there), returned ascending; ``ceil(n_steps /
    factor)`` of them.  The lowest pairs with "clean" (abar = 1)."""
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    pos = np.arange(n_steps - 1, -1, -factor, dtype=np.int64)
    return pos[::-1].copy()


def subgrid_schedule(schedule: DiffusionSchedule,
                     positions: Sequence[int]) -> DiffusionSchedule:
    """The schedule a distilled student samples with: the same full
    tables, the timesteps restricted to ``positions`` of the parent grid."""
    pos = torch.as_tensor(np.asarray(positions, dtype=np.int64))
    return DiffusionSchedule(betas=schedule.betas, alphas=schedule.alphas,
                             alphas_cumprod=schedule.alphas_cumprod,
                             timesteps=schedule.timesteps[pos])


# ------------------------------------------------------------------- sampler


def ddim_grid_steps(schedule: DiffusionSchedule
                    ) -> List[Tuple[int, float, float, float, float]]:
    """Per-step constants of :func:`sample_ddim_grid`, descending t:
    ``(t, sqrt(1 - abar), sqrt(abar), sqrt(abar_next), sqrt(1 -
    abar_next))``, each evaluated in float32 as the JAX sampler's traced
    arithmetic does (abar_next = 1 at the last step)."""
    one = np.float32(1.0)
    ts = schedule.timesteps.numpy()
    abar_all = schedule.alphas_cumprod.numpy()
    out = []
    for k in range(len(ts) - 1, -1, -1):
        a = abar_all[int(ts[k])]
        a_next = abar_all[int(ts[k - 1])] if k > 0 else one
        out.append((int(ts[k]), float(np.sqrt(one - a)), float(np.sqrt(a)),
                    float(np.sqrt(a_next)), float(np.sqrt(one - a_next))))
    return out


def sample_ddim_grid(eps_fn: EpsFn, cond: torch.Tensor,
                     generator: Optional[torch.Generator],
                     schedule: DiffusionSchedule,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deterministic DDIM over a ``DiffusionSchedule`` grid, the input
    order ``[pre, post, x]`` and the original t values (the convention of
    ``sample_ancestral``); the last step targets abar = 1 and returns the
    x0 prediction.  No clamp.  This is both the teacher's sub-step rule and
    the distilled student's serving sampler.

    cond ``(B, H, W, 2)``; x_T is drawn from ``generator`` (``None``:
    seeded 0 on cond's device) or given as ``noise`` (the tests pass the
    JAX package's draw).  Returns ``(B, H, W, 1)`` float32."""
    b, h, w, _ = cond.shape
    device = cond.device
    if noise is not None:
        x = torch.as_tensor(noise, dtype=torch.float32, device=device)
    else:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        x = torch.randn((b, h, w, 1), generator=generator, device=device,
                        dtype=torch.float32)
    for t, s1m, s, s_next, s1m_next in ddim_grid_steps(schedule):
        t_batch = torch.full((b,), t, dtype=torch.int32, device=device)
        eps = eps_fn(torch.cat([cond, x], dim=-1), t_batch)
        x0 = (x - s1m * eps) / s
        x = s_next * x0 + s1m_next * eps
    return x


# ------------------------------------------------------------------- targets


def solve_x0_target(x_t, x_pp, abar_t, abar_pp):
    """The x0 a single DDIM step from (x_t, abar_t) to abar'' must predict
    to land exactly on x'':

        x0* = (sqrt(1-abar_t) x'' - sqrt(1-abar'') x_t) / den,
        den = sqrt(abar''(1-abar_t)) - sqrt(abar_t(1-abar''))

    den > 0 whenever abar'' > abar_t, and at abar'' = 1 it is
    sqrt(1-abar_t), so x0* = x'' there with no special case."""
    den = (torch.sqrt(abar_pp * (1.0 - abar_t))
           - torch.sqrt(abar_t * (1.0 - abar_pp)))
    return (torch.sqrt(1.0 - abar_t) * x_pp
            - torch.sqrt(1.0 - abar_pp) * x_t) / den


def _per_step_tables(schedule: DiffusionSchedule, factor: int):
    """Per-student-step constant tables, on the CPU.

    Student step m starts at grid position p = spos[m]; the teacher walks
    p, p-1, ..., p-factor, and positions below 0 are "clean" (abar = 1).
    A DDIM step whose target abar equals its current one is an exact
    identity, so sub-paths that bottom out early are padded with
    clean-to-clean steps and every step runs ``factor`` teacher calls.
    Returns (spos, t_start, t_path (S, factor), abar_path (S, factor+1))."""
    ts = schedule.timesteps.numpy()
    abar_full = schedule.alphas_cumprod.numpy()
    spos = grid_positions(len(ts), factor)
    s = len(spos)
    t_path = np.zeros((s, factor), np.int32)
    abar_path = np.ones((s, factor + 1), np.float32)
    for m, p in enumerate(spos):
        for k in range(factor + 1):
            q = p - k
            abar_path[m, k] = abar_full[ts[q]] if q >= 0 else 1.0
            if k < factor:
                t_path[m, k] = ts[q] if q >= 0 else ts[0]
    return (torch.as_tensor(spos.astype(np.int32)),
            torch.as_tensor(ts[spos].astype(np.int32)),
            torch.as_tensor(t_path), torch.as_tensor(abar_path))


# --------------------------------------------------------------------- steps


def make_stepdistill_steps(schedule: DiffusionSchedule, factor: int,
                           teacher_eps_fn: EpsFn, loss_space: str = "eps"):
    """Train and eval steps distilling ``factor`` teacher DDIM sub-steps
    into one student step.  ``teacher_eps_fn(x_in (B, H, W, 3), t (B,)) ->
    (B, H, W, 1)`` runs frozen; the batch is ``(B, H, W, 3)`` = [pre,
    post, middle].

    ``loss_space``: 'eps' regresses the solved eps* (the teacher's own
    objective space); 'x_snr_trunc' regresses x0* weighted by
    ``max(SNR, 1)``.

    ``train_step(state, batch, generator)`` draws ``m`` uniformly in
    [0, S) and the noise; ``eval_step(state, batch, generator)`` takes the
    fixed ``floor(linspace(0, S-1, B))`` indices and draws the noise.  The
    inner ``train_step.train_on(state, batch, m, noise)`` and
    ``eval_step.eval_on(...)`` take the draws."""
    if loss_space not in ("eps", "x_snr_trunc"):
        raise ValueError(loss_space)
    tables = [_OnDevice(t) for t in _per_step_tables(schedule, factor)]
    n_student = int(tables[0].table.shape[0])

    def _loss(module, batch, m, noise):
        _, t_start, t_path, abar_path = (t(batch.device) for t in tables)
        cond, target = batch[..., :2], batch[..., 2:3]
        m = m.to(batch.device).long()
        a_t = abar_path[m, 0].reshape(-1, 1, 1, 1)
        a_pp = abar_path[m, factor].reshape(-1, 1, 1, 1)
        x_t = torch.sqrt(a_t) * target + torch.sqrt(1.0 - a_t) * noise
        with torch.no_grad():
            x = x_t
            for k in range(factor):
                a_cur = abar_path[m, k].reshape(-1, 1, 1, 1)
                a_nxt = abar_path[m, k + 1].reshape(-1, 1, 1, 1)
                eps = teacher_eps_fn(torch.cat([cond, x], dim=-1),
                                     t_path[m, k])
                x0 = (x - torch.sqrt(1.0 - a_cur) * eps) / torch.sqrt(a_cur)
                x = torch.sqrt(a_nxt) * x0 + torch.sqrt(1.0 - a_nxt) * eps
            x0_star = solve_x0_target(x_t, x, a_t, a_pp)
        eps_s = module(torch.cat([cond, x_t], dim=-1), t_start[m])
        if loss_space == "eps":
            eps_star = ((x_t - torch.sqrt(a_t) * x0_star)
                        / torch.sqrt(1.0 - a_t))
            per_sample = (eps_s - eps_star).square().mean(dim=(1, 2, 3))
        else:
            x0_s = (x_t - torch.sqrt(1.0 - a_t) * eps_s) / torch.sqrt(a_t)
            w = torch.clamp_min(a_t / (1.0 - a_t), 1.0)
            per_sample = (w * (x0_s - x0_star).square()).mean(dim=(1, 2, 3))
        return per_sample.mean()

    def train_on(state: TrainState, batch: torch.Tensor, m: torch.Tensor,
                 noise: torch.Tensor):
        with fp32_reference():
            loss = _loss(state.module.train(), batch, m, noise)
            _update(state, loss)
        return state, {"loss": loss.detach()}

    @torch.no_grad()
    def eval_on(state: TrainState, batch: torch.Tensor, m: torch.Tensor,
                noise: torch.Tensor):
        with fp32_reference():
            return {"loss": _loss(state.module.eval(), batch, m, noise)}

    def _noise(batch, generator):
        return torch.randn(batch[..., 2:3].shape, generator=generator,
                           device=batch.device, dtype=torch.float32)

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: torch.Generator):
        m = torch.randint(0, n_student, (batch.shape[0],),
                          generator=generator, device=batch.device)
        return train_on(state, batch, m, _noise(batch, generator))

    def eval_step(state: TrainState, batch: torch.Tensor,
                  generator: torch.Generator):
        m = linspace_draw(n_student, batch.shape[0], batch.device)
        return eval_on(state, batch, m, _noise(batch, generator))

    train_step.train_on, eval_step.eval_on = train_on, eval_on
    return train_step, eval_step


# -------------------------------------------------------------------- rounds


def frozen_bf16_teacher(module: nn.Module) -> EpsFn:
    """The frozen teacher of a round: a copy of ``module`` in float32 with
    every float32 parameter rounded to bf16 (a float32 flax module over
    bf16 parameters computes in float32), eval mode, no gradient."""
    from mrisr_tpu_torch.serve.engine import bf16_rounded_copy

    teacher = bf16_rounded_copy(module).requires_grad_(False)

    def eps_fn(x_in: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return teacher(x_in, t).float()

    return eps_fn


def distill_sampler_round(
    module: nn.Module,
    schedule: DiffusionSchedule,
    train_loader,
    val_loader=None,
    factor: int = 2,
    epochs: int = 30,
    learning_rate: float = 2e-4,
    grad_clip_norm: float = 1.0,
    loss_space: str = "eps",
    seed: int = 0,
    verbose: bool = True,
) -> Tuple[nn.Module, DiffusionSchedule, Dict]:
    """One round: grid N -> ceil(N / factor).

    ``module`` is the teacher (unchanged); the student is a copy of it,
    trained with AdamW (optax's default weight decay 1e-4) after a global
    gradient clip.  The step draws come from a generator seeded ``seed`` on
    the batches' device, the eval noise from one seeded 1 for every batch.
    Returns ``(student, student_schedule, history)``: the student holds the
    best-val-loss epoch's weights when a ``val_loader`` is given (every
    trainer's ``_best``), else the last epoch's, in eval mode."""
    teacher_eps = frozen_bf16_teacher(module)
    student = copy.deepcopy(module).requires_grad_(True)
    state = create_train_state(student, TrainConfig(
        optimizer="adamw", learning_rate=learning_rate, weight_decay=1e-4,
        grad_clip_norm=grad_clip_norm, lr_schedule="constant"))
    train_step, eval_step = make_stepdistill_steps(
        schedule, factor, teacher_eps, loss_space=loss_space)
    device = next(module.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)

    history: Dict[str, List[float]] = {"train_loss": [], "val_loss": []}
    best_val = math.inf
    best_sd = None
    for epoch in range(epochs):
        losses = [train_step(state, batch.to(device), generator)[1]["loss"]
                  for batch in train_loader]
        history["train_loss"].append(float(torch.stack(losses).mean()))
        if val_loader is not None:
            vlosses = [eval_step(state, vb.to(device), torch.Generator(
                device=device).manual_seed(1))["loss"] for vb in val_loader]
            val_loss = float(torch.stack(vlosses).mean())
            history["val_loss"].append(val_loss)
            if val_loss < best_val:
                best_val = val_loss
                best_sd = {k: v.clone()
                           for k, v in student.state_dict().items()}
        if verbose:
            vmsg = (f" val {history['val_loss'][-1]:.5f}"
                    if history["val_loss"] else "")
            print(f"[distill-steps x{factor}] epoch {epoch + 1}/{epochs} "
                  f"train {history['train_loss'][-1]:.5f}{vmsg}", flush=True)

    if best_sd is not None:
        student.load_state_dict(best_sd)
    spos = grid_positions(schedule.num_inference_steps, factor)
    return (student.eval().requires_grad_(False),
            subgrid_schedule(schedule, spos), history)


def progressive_distill(
    module: nn.Module,
    schedule: DiffusionSchedule,
    train_loader,
    val_loader=None,
    rounds: int = 2,
    factor: int = 2,
    epochs: int = 30,
    learning_rate: float = 2e-4,
    loss_space: str = "eps",
    seed: int = 0,
    verbose: bool = True,
):
    """Chain ``rounds`` halvings, each round's student teaching the next
    (round r seeded ``seed + r``).  Returns ``[(student, schedule,
    history), ...]``, one a round."""
    out = []
    teacher, sched = module, schedule
    for r in range(rounds):
        if sched.num_inference_steps <= 1:
            break
        teacher, sched, hist = distill_sampler_round(
            teacher, sched, train_loader, val_loader, factor=factor,
            epochs=epochs, learning_rate=learning_rate,
            loss_space=loss_space, seed=seed + r, verbose=verbose)
        out.append((teacher, sched, hist))
    return out
