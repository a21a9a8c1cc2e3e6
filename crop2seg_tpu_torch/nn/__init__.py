from crop2seg_tpu_torch.nn.blocks3d import (  # noqa: F401
    ConvBlock3D, ConvLayer3D, DownConvBlock3D, TemporalAggregator3D)
