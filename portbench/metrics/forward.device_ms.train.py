"""Device milliseconds a sample of the kernels launched under the span
``step.forward`` (the autocast forward), over the program's
``step.samples``. Autograd launches the backward from its own thread,
which no span of the step's thread parents, so a step's device time less
this is its backward and Adam."""
from portbench.harness import spans


def read(r):
    return spans.device_ms(r, ("step.forward",), "step.samples")
