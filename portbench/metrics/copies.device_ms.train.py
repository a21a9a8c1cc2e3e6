"""Device milliseconds a sample of the layout copies and casts: PyTorch's copy
kernels (permutes made contiguous, dtype casts) and cuDNN's NCHW/NHWC
conversions. The maps' fetch to the host (Memcpy) is not among them."""
from portbench.harness import readers

KERNELS = ("copy_kernel_cuda", "nchwToNhwc", "nhwcToNchw")


def read(r):
    return readers.device_ms_of_kernels(r, KERNELS)
