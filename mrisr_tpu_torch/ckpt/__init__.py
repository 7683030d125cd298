from mrisr_tpu_torch.ckpt.fold_bn import fold_unet_batchnorm  # noqa: F401
from mrisr_tpu_torch.ckpt.from_jax import unet_state_dict_from_flax  # noqa: F401
