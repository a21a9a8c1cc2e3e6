from crop2seg_tpu_torch.models.timeunet import TimeUNet  # noqa: F401
from crop2seg_tpu_torch.models.utae import UTAE  # noqa: F401
from crop2seg_tpu_torch.models.wtae import WTAE  # noqa: F401
