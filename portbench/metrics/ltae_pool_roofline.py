"""Kernels 2-3, the L-TAE's training pair (``csrc/ltae_pool.cu``): the
forward kernels' and the backward kernels' bounds at the cell's launch
shape times their launches, over the summed device time of both and of the
backward's reduce."""
from portbench.harness import counts

FORWARD = ("ltae_pool_fwd_group_kernel", "ltae_pool_fwd_general_kernel")
BACKWARD = ("ltae_pool_bwd_kernel", "ltae_pool_bwd_general_kernel")
REDUCE = ("ltae_pool_bwd_reduce",)


def _rows(r, names):
    return [row for row in r.trace["device_ops"] if any(k in row[0] for k in names)]


def read(r):
    if r.trace is None:
        return None
    fwd, bwd, red = _rows(r, FORWARD), _rows(r, BACKWARD), _rows(r, REDUCE)
    seconds = sum(row[1] for row in fwd + bwd + red)
    n_fwd, n_bwd = sum(row[2] for row in fwd), sum(row[2] for row in bwd)
    if not n_fwd + n_bwd or seconds <= 0:
        return None
    bound = (n_fwd * counts.ltae_pool_bound_s(r.ltae_shape, r.dtype, backward=False)
             + n_bwd * counts.ltae_pool_bound_s(r.ltae_shape, r.dtype, backward=True))
    return 100.0 * bound / seconds
