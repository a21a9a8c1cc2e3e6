"""Kernel 1, the L-TAE's eval kernel (``csrc/ltae_fused_fwd.cu``, every
``ltae_fused_*`` variant): its bound (the larger of bytes over the memory
bandwidth and operations over the dtype's peak, at the cell's launch
shape) times its launches, over their summed device time."""
from portbench.harness import counts

KERNELS = ("ltae_fused_group_kernel", "ltae_fused_wide_kernel", "ltae_fused_queries_kernel",
           "ltae_fused_general_kernel")


def read(r):
    if r.trace is None:
        return None
    rows = [row for row in r.trace["device_ops"] if any(k in row[0] for k in KERNELS)]
    seconds, launches = sum(row[1] for row in rows), sum(row[2] for row in rows)
    if not launches or seconds <= 0:
        return None
    return 100.0 * launches * counts.ltae_eval_bound_s(r.ltae_shape, r.dtype) / seconds
