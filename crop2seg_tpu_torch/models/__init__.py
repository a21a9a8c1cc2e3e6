from crop2seg_tpu_torch.models.convgru import ConvGRUSeg  # noqa: F401
from crop2seg_tpu_torch.models.convlstm import BConvLSTMSeg, ConvLSTMSeg  # noqa: F401
from crop2seg_tpu_torch.models.recunet import RecUNet  # noqa: F401
from crop2seg_tpu_torch.models.timeunet import TimeUNet  # noqa: F401
from crop2seg_tpu_torch.models.timeunet_v2 import TimeUNetV2  # noqa: F401
from crop2seg_tpu_torch.models.unet import Unet, UnetNaive  # noqa: F401
from crop2seg_tpu_torch.models.unet3d import UNet3D  # noqa: F401
from crop2seg_tpu_torch.models.utae import UTAE  # noqa: F401
from crop2seg_tpu_torch.models.wtae import WTAE  # noqa: F401
from crop2seg_tpu_torch.models.unet_ex import UNetEx  # noqa: F401
from crop2seg_tpu_torch.models.mlp_mixer import MLPMixer  # noqa: F401
