"""Host milliseconds a sample of the train step's call (the span ``step``,
over the program's ``step.samples``), to be set beside 1000 /
``train_samples_per_s``."""
from portbench.harness import spans


def read(r):
    return spans.host_ms(r, ("step",), "step.samples")
