"""Device milliseconds a patch of the kernels launched under the host ops
below: the cuDNN convolutions and transposed convolutions of a tile's
forward."""
from portbench.harness import readers

HOST_OPS = ("aten::convolution",)


def read(r):
    return readers.device_ms_under(r, HOST_OPS)
