from crop2seg_tpu_torch.data.batcher import (  # noqa: F401
    DEFAULT_T_BUCKETS, BatchLoader, DeviceCacheLoader, PrefetchLoader, collate)
from crop2seg_tpu_torch.data.s2tsczcrop import (  # noqa: F401
    LABELS, PASTIS_CHANNEL_ORDER, S2TSCZCropDataset, load_norm_values)
from crop2seg_tpu_torch.data.synthetic import (  # noqa: F401
    make_synthetic_dataset, make_synthetic_pastis)
from crop2seg_tpu_torch.data.transforms import Transform  # noqa: F401
