"""Host milliseconds a patch of the L-TAE eval wrapper's own work (the span
``ltae.eval``'s self time: checks, folds, aligned copies, the launch of
kernel 1), over the program's ``tile.patches``."""
from portbench.harness import spans


def read(r):
    return spans.host_ms(r, ("ltae.eval",), "tile.patches", own=True)
