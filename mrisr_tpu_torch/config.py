"""Typed configuration system with per-model presets.

A copy of ``mrisr_tpu/config.py`` (no framework), so a config either
package writes reads in the other.

The reference had only ad-hoc module constants and in-notebook CONFIG dicts
(`reference/notebooks/FastDDPM_Training_Fixed.ipynb:cell3`,
`results/*_history.json: config`).  Here every run is described by a
:class:`Config` dataclass; configs are serialized into history JSON for parity
with the reference's artifact contract (SURVEY.md §5).

The six presets reproduce the six trained configurations recovered from
``results/*_history.json`` and the notebooks (SURVEY.md §6).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _asdict(obj) -> dict:
    return dataclasses.asdict(obj)


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline configuration.

    Mirrors the knobs of the reference's ``build_dataloader``
    (`reference/src/ModelDataGenerator.py:217-284`).
    """

    root: str = "data/packed"            # packed volume store (see data/volumes.py)
    batch_size: int = 4
    augment: bool = False
    # None -> both spacings; 2 -> (i, i+2) -> i+1 (3mm); 4 -> (i, i+4) -> i+2 (6mm)
    distance_filter: Optional[int] = None
    image_size: Tuple[int, int] = (256, 256)
    # patient-level split fractions; seeds match the reference's
    # train_test_split(test_size=0.3, random_state=42) then (0.6, 42)
    split_seed: int = 42
    test_val_fraction: float = 0.3
    test_within_fraction: float = 0.6
    # background-thread prefetch depth for train loaders (0 disables)
    prefetch: int = 2
    # augmentation menu: reference used hflip/vflip (ModelDataGenerator.py:97-115),
    # rot90 for the progressive pipeline (ModelDataGenerator_ProgressiveUNet.py:200-215),
    # and a lost ±5° rotation variant (README.md:60)
    hflip: bool = True
    vflip: bool = True
    rot90: bool = False
    rotate_degrees: float = 0.0
    # slice value range after per-slice z-score: 'zscore' (the reference's
    # convention, data/pipeline.py:preprocess_volume) or 'zscore_minmax11'
    # (additionally min-max each slice to [-1, 1] — the M10 lineage's
    # working range, whose DDIM sampler clamps to [-1, 1] every step,
    # `reference/src/ModelLoader.py:636`)
    value_range: str = "zscore"


@dataclass(frozen=True)
class ModelConfig:
    """Architecture selection + hyperparameters."""

    name: str = "unet"                   # registry key (models/registry.py)
    in_channels: int = 2
    out_channels: int = 1
    base_features: int = 64
    # rematerialize the double-conv blocks in backward: trades recompute
    # for activation memory, unlocking larger train batches
    remat: bool = False
    num_blocks: Tuple[int, ...] = (2, 2, 2, 2)   # DeepCNN only
    # diffusion-only knobs
    time_dim: int = 128
    num_timesteps: int = 1000
    num_inference_steps: int = 10
    beta_schedule: str = "linear"        # 'linear' | 'cosine'
    timestep_selection: str = "nonuniform-4060"  # see models/diffusion.py


@dataclass(frozen=True)
class LossConfig:
    """Loss composition.

    Combined loss = MSE + lambda_perceptual * VGG + lambda_ssim * (1 - SSIM)
    (reference README.md:82-85); GAN weights from
    ``results/unet_gan_history.json: config.loss_weights``.
    """

    kind: str = "mse"                    # 'mse' | 'combined' | 'gan' | 'progressive' | 'diffusion'
    # feature space of the perceptual term: 'auto' = real VGG16 when an npz
    # of converted weights exists, else the fixed Gabor/LoG distance
    # (losses/perceptual.py); 'vgg-random' is the explicit-only r1 fallback
    perceptual: str = "auto"             # 'auto' | 'gabor' | 'vgg' | 'vgg-random'
    lambda_l1: float = 1.0
    lambda_perceptual: float = 0.1
    lambda_ssim: float = 0.1
    lambda_adversarial: float = 0.01
    # Progressive multi-output weights (results/progressive_unet_history.json)
    w_i1: float = 0.5
    w_i2: float = 1.0
    w_i3: float = 0.5
    # serving distillation (serve/distill.py): weight of the
    # teacher-matching MSE vs the ground-truth MSE, plus an optional
    # (1 - SSIM(student, teacher)) term that optimizes the eval metric
    # directly (0.0 = off, the r2 behavior)
    distill_alpha: float = 0.5
    distill_lambda_ssim: float = 0.0
    # Polyak/EMA averaging of the student params (0.0 = off): per-step
    # ema = d*ema + (1-d)*params inside the fused train step; eval + the
    # `_best` checkpoint use the EMA weights (averaging the parameter
    # trajectory damps the rerun spread of bf16 training)
    distill_ema: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 50
    learning_rate: float = 1e-4
    learning_rate_d: float = 2e-4        # GAN discriminator
    optimizer: str = "adam"              # 'adam' | 'adamw'
    # torch AdamW's default decay (the reference notebooks used bare
    # torch.optim.AdamW, Fixed:cell15); set 0.0 explicitly to disable —
    # only the 'adamw' optimizer reads this
    weight_decay: float = 1e-2
    grad_clip_norm: float = 0.0          # 1.0 for diffusion (Fixed:cell11)
    lr_schedule: str = "constant"        # 'constant' | 'cosine'
    early_stopping_patience: int = 15
    seed: int = 0
    checkpoint_dir: str = "models"
    results_dir: str = "results"
    save_every_epoch: bool = True        # resumable per-epoch ckpt (Fixed:cell9)
    # campaign mode: only the best (async) + one final latest checkpoint.
    # Sweep runs that never resume don't need the per-epoch snapshots,
    # whose synchronous device-to-host fetches can dominate short epochs.
    light_checkpoints: bool = False
    # precision policy: params fp32; compute dtype for conv/matmul
    compute_dtype: str = "float32"       # 'float32' | 'bfloat16'
    donate_batch: bool = True


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for data / (optional) model parallelism (SURVEY.md §2.5)."""

    data: int = -1                       # -1 -> all remaining devices
    model: int = 1


@dataclass(frozen=True)
class Config:
    preset: str = "unet"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    @staticmethod
    def from_dict(d: dict) -> "Config":
        def mk(cls, sub: dict):
            # JSON round-trip turns tuples into lists; coerce them back
            sub = {
                k: tuple(v) if isinstance(v, list) else v
                for k, v in sub.items()
            }
            return cls(**sub)

        return Config(
            preset=d.get("preset", "custom"),
            data=mk(DataConfig, d.get("data", {})),
            model=mk(ModelConfig, d.get("model", {})),
            loss=mk(LossConfig, d.get("loss", {})),
            train=mk(TrainConfig, d.get("train", {})),
            mesh=mk(MeshConfig, d.get("mesh", {})),
        )


def _preset(name: str, **kw) -> Config:
    return Config(preset=name, **kw)


# The six trained configurations of the reference (SURVEY.md §6 / BASELINE.md).
PRESETS = {
    # DeepCNN: Adam 1e-4, batch 4, no augmentation, early stop patience 5
    # (results/deepcnn_history.json: config)
    "deepcnn": _preset(
        "deepcnn",
        data=DataConfig(batch_size=4, augment=False),
        model=ModelConfig(name="deepcnn", num_blocks=(2, 2, 2, 2)),
        loss=LossConfig(kind="mse"),
        train=TrainConfig(learning_rate=1e-4, early_stopping_patience=5),
    ),
    # UNet(MSE): Adam 1e-4, batch 4, augmentation on, 15 epochs best
    # (src/unet_model.py:148-298, results/training_history.json)
    "unet": _preset(
        "unet",
        data=DataConfig(batch_size=4, augment=True),
        model=ModelConfig(name="unet"),
        loss=LossConfig(kind="mse"),
        train=TrainConfig(learning_rate=1e-4, early_stopping_patience=10),
    ),
    # UNet combined: MSE + VGG-perceptual + SSIM (README.md:82-85; the lost
    # UNet_Training.ipynb's weights follow the GAN house style)
    "unet_combined": _preset(
        "unet_combined",
        data=DataConfig(batch_size=4, augment=True),
        model=ModelConfig(name="unet"),
        loss=LossConfig(kind="combined", lambda_perceptual=0.1, lambda_ssim=0.1),
        train=TrainConfig(learning_rate=1e-4, early_stopping_patience=10),
    ),
    # UNet-GAN: LSGAN + PatchGAN, lr_G = lr_D = 2e-4, λ = 1.0/0.1/0.01,
    # batch 4, 20 epochs, augment on (results/unet_gan_history.json: config)
    "unet_gan": _preset(
        "unet_gan",
        data=DataConfig(batch_size=4, augment=True),
        model=ModelConfig(name="unet_gan"),
        loss=LossConfig(
            kind="gan", lambda_l1=1.0, lambda_perceptual=0.1, lambda_adversarial=0.01
        ),
        train=TrainConfig(
            learning_rate=2e-4, learning_rate_d=2e-4, epochs=20,
            early_stopping_patience=5,
        ),
    ),
    # Progressive 3-stage UNet: lr 5e-4, weighted MSE 0.5/1.0/0.5, 27 epochs
    # (results/progressive_unet_history.json: config)
    "progressive_unet": _preset(
        "progressive_unet",
        data=DataConfig(batch_size=4, augment=True, rot90=True),
        model=ModelConfig(name="progressive_unet"),
        loss=LossConfig(kind="progressive", w_i1=0.5, w_i2=1.0, w_i3=0.5),
        train=TrainConfig(learning_rate=5e-4, epochs=27),
    ),
    # Fast-DDPM "Fixed" lineage: AdamW 2e-5, grad clip 1.0, 40 epochs,
    # non-uniform 10-step selection, batch 4, augment on.  NOTE: the
    # scheduler the training loop ACTUALLY used (``scheduler_device``,
    # Fixed:cell9) is COSINE β, even though cell5 displays a linear one.
    "fastddpm": _preset(
        "fastddpm",
        data=DataConfig(batch_size=4, augment=True),
        model=ModelConfig(
            name="fastddpm", in_channels=3, base_features=64, time_dim=128,
            num_timesteps=1000, num_inference_steps=10,
            beta_schedule="cosine", timestep_selection="nonuniform-4060",
        ),
        loss=LossConfig(kind="diffusion"),
        train=TrainConfig(
            learning_rate=2e-5, optimizer="adamw", grad_clip_norm=1.0, epochs=40,
        ),
    ),
    # Fast-DDPM "Simple" (M10, ModelLoader.py:466-636): compressed-T
    # schedule (T=10 subsampled from the 1000-step LINEAR β table, 40/60
    # split), 2-level UNet2D with the 256-dim time embedding concatenated
    # as channels, DDIM sampling, [x, cond] input order.  The training
    # notebook (FastDDPM_Simple.ipynb) is lost; optimizer settings follow
    # the surviving Fixed-lineage loop.  Checkpoint:
    # fastddpm_advanced_best.pth (ModelLoader.py:668).
    "fastddpm_simple": _preset(
        "fastddpm_simple",
        # value_range: the M10 sampler clamps to [-1, 1] every DDIM step
        # (ModelLoader.py:636) — z-scored targets exceed that interval and
        # cap achievable PSNR by construction, so this preset trains/evals
        # on per-slice [-1, 1]-mapped data (VERDICT r3 item 5)
        data=DataConfig(batch_size=4, augment=True,
                        value_range="zscore_minmax11"),
        model=ModelConfig(
            name="fastddpm_simple", in_channels=3, base_features=64,
            time_dim=256, num_timesteps=1000, num_inference_steps=10,
            beta_schedule="linear", timestep_selection="nonuniform-4060",
        ),
        loss=LossConfig(kind="diffusion"),
        train=TrainConfig(
            learning_rate=2e-5, optimizer="adamw", grad_clip_norm=1.0,
            epochs=40,
        ),
    ),
    # base_ch=128 / time_dim=256 variant, cosine β, lr 2e-5, 20 epochs
    # (FastDDPM_Training_cosine_sched.ipynb:cell3,cell8,cell10; 55.6 M params)
    "fastddpm_cosine128": _preset(
        "fastddpm_cosine128",
        data=DataConfig(batch_size=4, augment=True),
        model=ModelConfig(
            name="fastddpm", in_channels=3, base_features=128, time_dim=256,
            num_timesteps=1000, num_inference_steps=10,
            beta_schedule="cosine", timestep_selection="nonuniform-4060",
        ),
        loss=LossConfig(kind="diffusion"),
        train=TrainConfig(
            learning_rate=2e-5, optimizer="adamw", grad_clip_norm=1.0, epochs=20,
        ),
    ),
    # Serving distillation student (serve/distill.py): half-width UNet
    # (features=32, ~7.8 M params, ~4x fewer FLOPs than M2) trained against
    # a trained 'unet' teacher's outputs.  NOT a reference configuration —
    # a serving addition (BASELINE.md roofline section).
    "unet_distilled": _preset(
        "unet_distilled",
        data=DataConfig(batch_size=32, augment=True),
        model=ModelConfig(name="unet_distilled", base_features=32),
        loss=LossConfig(kind="distill", distill_alpha=0.5),
        train=TrainConfig(
            learning_rate=2e-4, epochs=20, early_stopping_patience=10,
            compute_dtype="bfloat16",
        ),
    ),
    # base_ch=128 variant, LINEAR β, lr 2e-4, 20 epochs
    # ("FastDDPM_Training_increased channel.ipynb":cell3,cell8,cell10)
    "fastddpm_large": _preset(
        "fastddpm_large",
        data=DataConfig(batch_size=4, augment=True),
        model=ModelConfig(
            name="fastddpm", in_channels=3, base_features=128, time_dim=256,
            num_timesteps=1000, num_inference_steps=10,
            beta_schedule="linear", timestep_selection="nonuniform-4060",
        ),
        loss=LossConfig(kind="diffusion"),
        train=TrainConfig(
            learning_rate=2e-4, optimizer="adamw", grad_clip_norm=1.0, epochs=20,
        ),
    ),
    # The DDPM UNet that Fast-DDPM publishes for its PMUB task
    # (arXiv:2405.14802; github.com/mirthAI/Fast-DDPM, its PMUB configuration:
    # ch 128, ch_mult (1, 1, 2, 2, 4, 4), 2 ResBlocks a level, attention at
    # 16^2, linear beta 1e-4 to 0.02 over 1000 steps; 113.7 M params,
    # models/ddpm_unet.py), sampled as the fastddpm preset is: 10 steps of
    # 'nonuniform-4060'.  The port's own: the JAX package has no such model.
    # Training settings follow the fastddpm preset's.
    "fastddpm_pmub": _preset(
        "fastddpm_pmub",
        data=DataConfig(batch_size=4, augment=True),
        model=ModelConfig(
            name="fastddpm_pmub", in_channels=3, base_features=128,
            time_dim=512, num_timesteps=1000, num_inference_steps=10,
            beta_schedule="linear", timestep_selection="nonuniform-4060",
        ),
        loss=LossConfig(kind="diffusion"),
        train=TrainConfig(
            learning_rate=2e-5, optimizer="adamw", grad_clip_norm=1.0, epochs=40,
        ),
    ),
    # ADM's 256^2 diffusion UNet (Dhariwal & Nichol 2021, arXiv:2105.05233;
    # github.com/openai/guided-diffusion unet.py: num_channels 256,
    # channel_mult (1, 1, 2, 2, 4, 4), 2 ResBlocks a level, resblock_updown,
    # use_scale_shift_norm, attention at 32^2, 16^2 and 8^2 in heads of 64
    # channels, learn_sigma; 552.8 M params, models/adm_unet.py), sampled as
    # the fastddpm_pmub preset is: linear beta 1e-4 to 0.02 over 1000 steps,
    # 10 steps of 'nonuniform-4060'.  The port's own.  Training settings
    # follow the fastddpm preset's.
    "fastddpm_adm": _preset(
        "fastddpm_adm",
        data=DataConfig(batch_size=4, augment=True),
        model=ModelConfig(
            name="fastddpm_adm", in_channels=3, base_features=256,
            time_dim=1024, num_timesteps=1000, num_inference_steps=10,
            beta_schedule="linear", timestep_selection="nonuniform-4060",
        ),
        loss=LossConfig(kind="diffusion"),
        train=TrainConfig(
            learning_rate=2e-5, optimizer="adamw", grad_clip_norm=1.0, epochs=40,
        ),
    ),
    # DiT-XL/8, the Diffusion Transformer (Peebles & Xie 2023,
    # arXiv:2212.09748; github.com/facebookresearch/DiT models.py:DiT_XL_8:
    # hidden 1152, 28 blocks, 16 heads, patch 8, MLP ratio 4, learn_sigma;
    # 674.0 M params, models/dit.py) as a pixel-space denoiser of 256^2
    # slices (1024 tokens), sampled as the fastddpm_pmub preset is: linear
    # beta 1e-4 to 0.02 over 1000 steps, 10 steps of 'nonuniform-4060'.
    # time_dim is the width (DiT's TimestepEmbedder is hidden wide).  The
    # port's own.  Training settings follow the fastddpm preset's.
    "fastddpm_dit": _preset(
        "fastddpm_dit",
        data=DataConfig(batch_size=4, augment=True),
        model=ModelConfig(
            name="fastddpm_dit", in_channels=3, base_features=1152,
            time_dim=1152, num_timesteps=1000, num_inference_steps=10,
            beta_schedule="linear", timestep_selection="nonuniform-4060",
        ),
        loss=LossConfig(kind="diffusion"),
        train=TrainConfig(
            learning_rate=2e-5, optimizer="adamw", grad_clip_norm=1.0, epochs=40,
        ),
    ),
}
