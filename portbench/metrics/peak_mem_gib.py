"""torch.cuda.max_memory_allocated() over the window (reset after the
warm-up), in GiB: what stays resident (tiles or batches, weights, Adam
state) and the largest working set of a unit."""


def read(r):
    return r.peak_bytes / 2 ** 30 if r.peak_bytes else None
