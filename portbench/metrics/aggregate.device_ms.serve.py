"""Device milliseconds a patch of the kernels launched under the span
``aggregate`` (``nn/aggregator.py::temporal_aggregate``: the attention's
resample and the weighted sums over T), over the program's
``tile.patches``."""
from portbench.harness import spans


def read(r):
    return spans.device_ms(r, ("aggregate",), "tile.patches")
