"""Device milliseconds a sample of the aggregator's kernel pair
(``crop2seg_tpu_torch/csrc/temporal_aggregate.cu``): its forward kernels,
launched under the span ``aggregate``, and its backward kernels, under
``aggregate.bwd`` on autograd's thread, every route. The attention's
resample around them (the bilinear upsample and its backward, PyTorch's own
kernels) is left out on both sides. A program without the pair reads
nothing."""
from portbench.harness import readers

KERNELS = ("agg_fwd_", "agg_bwd_")


def read(r):
    return readers.device_ms_of_kernels(r, KERNELS)
