from crop2seg_tpu_torch.inference.tile import make_tile_predictor  # noqa: F401
