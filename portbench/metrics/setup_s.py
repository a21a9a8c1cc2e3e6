"""Seconds from the process's start to the first timed unit: imports, the
kernels' build or load, weights and inputs, the warm-up (for training the
first steps)."""


def read(r):
    return r.setup_s
