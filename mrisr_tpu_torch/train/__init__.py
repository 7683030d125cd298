"""Training: optimizer and state, the steps of every family, the epoch loop
with checkpoints and history, the GAN and diffusion trainers, and epochs
gathered on the card."""

from mrisr_tpu_torch.train.diffusion import DiffusionTrainer  # noqa: F401
from mrisr_tpu_torch.train.gan import GANTrainer  # noqa: F401
from mrisr_tpu_torch.train.history import TrainingHistory  # noqa: F401
from mrisr_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizer,
)
from mrisr_tpu_torch.train.steps import make_supervised_steps  # noqa: F401
from mrisr_tpu_torch.train.trainer import SupervisedTrainer  # noqa: F401
