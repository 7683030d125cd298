"""Public API: the reference's ``load_model`` contract (counterpart:
``mrisr_tpu/api.py``).

``load_model(name)`` searches checkpoints as ``mrisr_tpu.api.load_model``
does and returns a :class:`LoadedModel` with the reference's NCHW call
contract, ``(B, 2, H, W) -> (B, 1, H, W)``, and the NHWC fast path the
eval code uses.  Every eval model of the registry loads: the pair UNets
(the GAN's generator among them), DeepCNN, the Progressive UNet (a window
``(B, 5, H, W)`` in, three predictions out), ``fastddpm`` (sampled by the
10-step ancestral chain) and ``fastddpm_simple`` (DDIM over the compressed
schedule).  A step-distilled student ``<base>_steps<N>`` (``cli
distill-steps``) loads as its base architecture with the timestep grid of
its sidecar, sampled by deterministic DDIM over that grid.  Where the
JAX package reads an Orbax directory ``D`` (its trainers write them), the
port reads ``D.pt``, the conversion ``tools/orbax_to_torch.py`` writes.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, replace
from typing import Optional

import torch
from torch import nn

from mrisr_tpu_torch.ckpt.fold_bn import fold_unet_batchnorm
from mrisr_tpu_torch.ckpt.torch_ckpt import (
    load_checkpoint_file,
    load_reference_state_dict,
    orbax_record,
)
from mrisr_tpu_torch.config import PRESETS, ModelConfig
from mrisr_tpu_torch.device import DeviceLike, fp32_reference, resolve_device
from mrisr_tpu_torch.models.diffusion import (
    DiffusionSchedule,
    FastNoiseSchedule,
    sample_ancestral,
    sample_ddim,
)
from mrisr_tpu_torch.models.registry import TRAINABLE, create_model

# pair UNets of the registry (mrisr_tpu/models/registry.py): the GAN
# generator's convs are bias-free
PAIR_UNETS = ("unet", "unet_combined", "unet_gan", "unet_distilled")
NOT_EVAL = {
    "patchgan": "'patchgan' is the UNet-GAN's discriminator, not an eval "
                "model: load 'unet_gan' (its checkpoint holds both)",
}

# the reference's checkpoint file names (reference src/ModelLoader.py:662-669)
_TORCH_CKPT_FILES = {
    "unet": "unet_best.pt",
    "unet_combined": "unet_combined_best.pt",
    "deepcnn": "deepcnn_best.pt",
    "progressive_unet": "progressive_unet_best.pt",
    "unet_gan": "unet_gan_best.pt",
    "fastddpm": "fastddpm_best.pt",
    "fastddpm_simple": "fastddpm_advanced_best.pth",
}


@dataclass
class LoadedModel:
    """An eval-ready model on ``device``: a pair UNet, or a diffusion model
    with its sampling ``schedule``."""

    name: str
    module: nn.Module
    kind: str  # 'pair' | 'window' | 'diffusion'
    device: torch.device
    # DiffusionSchedule (ancestral) or FastNoiseSchedule (fastddpm_simple)
    schedule: Optional[object] = None
    # 'ddim_grid': deterministic DDIM over schedule.timesteps (the
    # step-distilled students); None: the lineage's own sampler
    sampler: Optional[str] = None

    @torch.no_grad()
    def predict_nhwc(self, x: torch.Tensor,
                     generator: Optional[torch.Generator] = None):
        """``(B, H, W, 2) -> (B, H, W, 1)`` float32 on the model's device
        (a window model: ``(B, H, W, 5) -> (p1, p2, p3)``).  The forward
        runs in full float32 (TF32 off): the metric it feeds is the
        reference's float model's.  A diffusion model samples from ``x`` =
        [pre, post]: the ancestral chain, DDIM for ``fastddpm_simple``, or
        DDIM over the grid for a step-distilled student, with
        ``generator`` (None: seeded 0, the JAX package's
        ``PRNGKey(0)``)."""
        x = x.to(self.device, torch.float32)
        with fp32_reference():
            if self.kind != "diffusion":
                return self.module(x)
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            if self.sampler == "ddim_grid":
                from mrisr_tpu_torch.serve.distill_diffusion import (
                    sample_ddim_grid,
                )

                return sample_ddim_grid(self.module, x, generator,
                                        self.schedule)
            if self.name == "fastddpm_simple":
                return sample_ddim(self.module, x, generator, self.schedule)
            return sample_ancestral(self.module, x, generator, self.schedule,
                                    combine="first")

    def __call__(self, x_nchw, generator: Optional[torch.Generator] = None):
        """``(B, 2, H, W) -> (B, 1, H, W)`` (a diffusion model: the sample
        conditioned on the two slices; a window model: ``(B, 5, H, W)`` ->
        three ``(B, 1, H, W)``)."""
        x = torch.as_tensor(x_nchw, dtype=torch.float32).permute(0, 2, 3, 1)
        out = self.predict_nhwc(x, generator)
        if isinstance(out, tuple):
            return tuple(o.permute(0, 3, 1, 2) for o in out)
        return out.permute(0, 3, 1, 2)

    def sample(self, cond_nchw, generator: Optional[torch.Generator] = None):
        """A diffusion model's sample conditioned on ``(B, 2, H, W)``
        [pre, post]: ``(B, 1, H, W)``, as ``__call__``."""
        assert self.kind == "diffusion"
        return self(cond_nchw, generator)


def orbax_conversion(directory: str, model_name: str) -> dict:
    """The checkpoint the port reads for the JAX package's Orbax checkpoint
    ``directory`` of model ``model_name``: its conversion
    ``<directory>.pt`` (``tools/orbax_to_torch.py``), when that file is
    there and its record matches the directory (a record without the
    metadata's hash matches nothing).  Anything else raises, with the
    tool's command: a port-trained ``<name>_best.pt`` beside a JAX-trained
    ``<name>_best/`` is not a conversion of it."""
    directory = os.path.normpath(directory)
    path = directory + ".pt"
    if not os.path.isfile(path):
        problem = "is missing"
    else:
        ckpt = load_checkpoint_file(path)
        record = ckpt.get("orbax") if isinstance(ckpt, dict) else None
        if record is None:
            problem = "records no Orbax checkpoint"
        elif record.get("sha256") is None:
            problem = "records no hash of its metadata"
        elif record == orbax_record(directory):
            return ckpt
        else:
            problem = "records another save of it (stale)"
    raise NotImplementedError(
        f"{directory} is an Orbax checkpoint of the JAX package; the port "
        f"reads its conversion {path}, which {problem}: run "
        f"'python tools/orbax_to_torch.py {directory} --model {model_name}' "
        "where JAX and Orbax are installed")


def load_model(
    model_name: str,
    models_dir: str = "models",
    checkpoint: Optional[str] = None,
    cfg: Optional[ModelConfig] = None,
    fold_bn: bool = False,
    device: DeviceLike = None,
) -> LoadedModel:
    """Load the best checkpoint for ``model_name`` onto ``device``
    (``None``: the card).

    Search order, as the JAX package's: an explicit ``checkpoint`` path;
    the Orbax dir ``<models_dir>/<name>_best``, read through its
    conversion (:func:`orbax_conversion`, which raises without one); the
    reference torch file ``<models_dir>/<torch name>``; the port trainer's
    ``<models_dir>/<name>_best.pt``.  With none found,
    fresh weights (seeded), unless ``checkpoint='required'``, which raises.
    ``fold_bn`` folds a pair UNet's BatchNorm into the convs (exact in
    eval).  A diffusion model's schedule is built from ``cfg``;
    'patchgan' raises ``ValueError``: it is not an eval model."""
    name = model_name.lower()
    m = re.fullmatch(r"(.+)_steps(\d+)", name)
    if m and m.group(1) in TRAINABLE:
        # the checkpoint pairs with its grid sidecar in models_dir: an
        # explicit path has no sidecar, and would sample on the wrong grid
        if checkpoint and checkpoint != "required":
            raise ValueError(
                f"{model_name}: step-distilled models resolve their "
                "checkpoint AND timestep-grid sidecar from models_dir; "
                "pass models_dir instead of an explicit checkpoint path")
        return _load_step_distilled(name, m.group(1), int(m.group(2)),
                                    models_dir, cfg, device)
    if name in NOT_EVAL:
        raise ValueError(NOT_EVAL[name])
    if name not in TRAINABLE:
        raise ValueError(f"Unknown model: {model_name}. Choose from: "
                         f"{sorted(set(TRAINABLE) - set(NOT_EVAL))}")
    device = resolve_device(device)
    if cfg is None:
        cfg = PRESETS[name].model if name in PRESETS else ModelConfig(name=name)
    require = checkpoint == "required"
    if require:
        checkpoint = None
    orbax_path = os.path.join(models_dir, f"{name}_best")
    torch_path = os.path.join(models_dir, _TORCH_CKPT_FILES.get(name, ""))
    # the port's trainer writes <preset>_best.pt (the reference's file name
    # for every family but the simple lineage)
    own_path = os.path.join(models_dir, f"{name}_best.pt")
    ckpt = None
    if checkpoint:
        # an explicit path must exist: falling back to another checkpoint
        # would report metrics for the wrong model on a typo
        if not os.path.exists(checkpoint):
            raise FileNotFoundError(f"checkpoint not found: {checkpoint}")
        ckpt = (orbax_conversion(checkpoint, name)
                if os.path.isdir(checkpoint)
                else load_checkpoint_file(checkpoint))
    elif os.path.isdir(orbax_path):
        ckpt = orbax_conversion(orbax_path, name)
    elif name in _TORCH_CKPT_FILES and os.path.isfile(torch_path):
        ckpt = load_checkpoint_file(torch_path)
    elif os.path.isfile(own_path):
        ckpt = load_checkpoint_file(own_path)
    elif require:
        raise FileNotFoundError(f"Checkpoint not found for {name} in "
                                f"{models_dir}")
    return _loaded(name, cfg, ckpt, fold_bn, device)


def _loaded(name: str, cfg: ModelConfig, ckpt: Optional[dict],
            fold_bn: bool, device: torch.device) -> LoadedModel:
    """Model ``name`` built from ``cfg`` (seeded), with the weights of the
    reference-layout checkpoint ``ckpt`` (None: the seeded ones), in eval
    mode on ``device``, with its sampling schedule."""
    kind = TRAINABLE[name]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        module = create_model(name, cfg)
    if ckpt is not None:
        load_reference_state_dict(module, ckpt)
    module = module.eval()
    schedule = None
    if name == "fastddpm_simple":
        schedule = FastNoiseSchedule.create(cfg.num_inference_steps)
    elif kind == "diffusion":
        # the sampling schedule comes from the model's config: the trained
        # fastddpm presets use cosine beta
        schedule = DiffusionSchedule.create(
            num_timesteps=cfg.num_timesteps,
            num_inference_steps=cfg.num_inference_steps,
            beta_schedule=cfg.beta_schedule,
            selection=cfg.timestep_selection)
    elif fold_bn and name in PAIR_UNETS:
        module = fold_unet_batchnorm(module)
    return LoadedModel(name=name, module=module.to(device), kind=kind,
                       device=device, schedule=schedule)


def _load_step_distilled(name: str, base: str, n_steps: int,
                         models_dir: str, cfg: Optional[ModelConfig],
                         device: DeviceLike) -> LoadedModel:
    """A step-distilled Fast-DDPM student (``cli distill-steps``,
    ``serve/distill_diffusion.py``): ``<base>_steps<N>`` is the base
    architecture with the weights of ``<models_dir>/<name>_best.pt`` and
    the timestep grid of ``<name>_grid.json`` (keys ``base``, ``factor``,
    ``timesteps``), sampled by DDIM over that grid."""
    if base == "fastddpm_simple":
        raise ValueError(
            "step-distillation targets the Fixed lineage ([pre, post, x] "
            "input order); fastddpm_simple is not supported")
    if TRAINABLE[base] != "diffusion":
        raise ValueError(f"{name}: step-distilled students must be diffusion "
                         f"models, {base} is kind={TRAINABLE[base]!r}")
    orbax_path = os.path.join(models_dir, f"{name}_best")
    # raises unless <name>_best.pt is the directory's conversion
    ckpt = (orbax_conversion(orbax_path, name) if os.path.isdir(orbax_path)
            else None)
    ckpt_path = os.path.join(models_dir, f"{name}_best.pt")
    grid_path = os.path.join(models_dir, f"{name}_grid.json")
    if not os.path.isfile(ckpt_path) or not os.path.exists(grid_path):
        raise FileNotFoundError(
            f"step-distilled checkpoint needs both {ckpt_path} and "
            f"{grid_path} (produced by: cli distill-steps --teacher {base})")
    with open(grid_path) as f:
        timesteps = json.load(f)["timesteps"]
    if len(timesteps) != n_steps:
        raise ValueError(
            f"{grid_path} carries {len(timesteps)} timesteps but the model "
            f"name says {n_steps}")
    if cfg is None:
        cfg = PRESETS[base].model if base in PRESETS else ModelConfig(
            name=base)
    # a corrupt sidecar must fail loudly: an out-of-range t would index
    # the wrong abar, and the sampler assumes a strictly ascending grid
    if not all(0 <= int(t) < cfg.num_timesteps for t in timesteps):
        raise ValueError(
            f"{grid_path}: timesteps must lie in [0, {cfg.num_timesteps}), "
            f"got {timesteps}")
    if any(b <= a for a, b in zip(timesteps, timesteps[1:])):
        raise ValueError(
            f"{grid_path}: timesteps must be strictly ascending, "
            f"got {timesteps}")
    if ckpt is None:
        ckpt = load_checkpoint_file(ckpt_path)
    loaded = _loaded(base, cfg, ckpt, False, resolve_device(device))
    schedule = replace(loaded.schedule, timesteps=torch.tensor(
        timesteps, dtype=torch.int32))
    return LoadedModel(name=name, module=loaded.module, kind="diffusion",
                       device=loaded.device, schedule=schedule,
                       sampler="ddim_grid")
