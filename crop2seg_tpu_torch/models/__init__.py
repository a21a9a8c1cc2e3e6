from crop2seg_tpu_torch.models.timeunet import TimeUNet  # noqa: F401
