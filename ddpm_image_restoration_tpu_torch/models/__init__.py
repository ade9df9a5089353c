from ddpm_image_restoration_tpu_torch.models.unet import (  # noqa: F401
    CodecDiffusionModel,
    build_model,
)
