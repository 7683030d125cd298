from mrisr_tpu_torch.models.unet import UNet  # noqa: F401
