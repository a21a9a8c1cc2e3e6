"""Device milliseconds a sample of the kernels launched under the host ops
below: the cuDNN convolutions forward, recomputed, and backward."""
from portbench.harness import readers

HOST_OPS = ("aten::convolution", "aten::convolution_backward")


def read(r):
    return readers.device_ms_under(r, HOST_OPS)
