"""Host milliseconds a sample of the L-TAE kernel pair's wrappers (the spans
``ltae.pool.fwd`` and ``ltae.pool.bwd``, self time; the second on
autograd's backward thread), over the program's ``step.samples``."""
from portbench.harness import spans


def read(r):
    return spans.host_ms(r, ("ltae.pool.fwd", "ltae.pool.bwd"), "step.samples", own=True)
