"""The temporal aggregator's weighted sum over T: a CUDA C++ kernel pair for
Hopper (``csrc/temporal_aggregate.cu``) and its plain version.

x (B, T, H, W, C) channels last, w (B, T, K, H, W) with K dividing C, k(c) =
c // (C/K), pad_mask (B, T) bool or None, den (B,) fp32 or None:

    out[b, h, w, c] = sum_{t not padded} w[b, t, k(c), h, w] * x[b, t, h, w, c]
                      (/ den[b]), in fp32, rounded once to x's dtype

``weighted_sum`` runs ``weighted_sum_reference``, the loop of per-date
PyTorch ops, for a CPU tensor, and the kernel pair (``_Aggregate``, a
``torch.autograd.Function``) for a CUDA tensor in fp32 or bf16; another
dtype on the card raises. The pair does the loop's arithmetic: each product
and sum rounded to fp32 on its own, the dates in ascending order, so the
output and dx equal the loop's bit for bit; dw (the weights' gradient, in
their dtype, as (B, T, K, H, W)) sums a head's channels in another order,
within one rounding of the loop's. The kernels skip a padded date where the
loop adds 0 * x: the two differ only where x is not finite at a padded
date. The backward saves x and w alone, and moves O(T) bytes where the
loop's moved O(T^2) (a zero-filled gradient of the whole x for each date,
then their sum).

Each forward on the card adds one to the counter ``aggregate.kernel``, and
the backward is the span ``aggregate.bwd`` on autograd's thread
(``utils/profiling.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from crop2seg_tpu_torch.ops._build import load_library
from crop2seg_tpu_torch.utils.profiling import count, span

MAX_SHUFFLE = 32    # a head spans at most one warp of vector threads


def _check(x, w, pad_mask, den) -> None:
    if x.dim() != 5 or w.dim() != 5:
        raise ValueError(f"x must be (B, T, H, W, C) and w (B, T, K, H, W), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    b, t, h, wd, c = x.shape
    k = w.shape[2]
    if k < 1 or c % k:
        raise ValueError(f"the weights' K={k} heads must divide the C={c} channels")
    if tuple(w.shape) != (b, t, k, h, wd):
        raise ValueError(f"w is {tuple(w.shape)}, expected {(b, t, k, h, wd)}")
    if pad_mask is not None and tuple(pad_mask.shape) != (b, t):
        raise ValueError(f"pad_mask is {tuple(pad_mask.shape)}, expected {(b, t)}")
    if den is not None and tuple(den.shape) != (b,):
        raise ValueError(f"den is {tuple(den.shape)}, expected {(b,)}")


def weighted_sum_reference(x, w, pad_mask=None, den=None) -> torch.Tensor:
    """Plain PyTorch version (differentiable by torch autograd): the padded
    dates' weights zeroed, then one fp32 product and add a date; arguments
    and result as ``weighted_sum``."""
    b, t, h, wd, c = x.shape
    k = w.shape[2]
    a = w.permute(0, 1, 3, 4, 2)                                    # (B, T, H, W, K)
    if pad_mask is not None:
        a = a * (~pad_mask).to(a.dtype)[:, :, None, None, None]
    xs = x.reshape(b, t, h, wd, k, c // k)
    out = torch.zeros((b, h, wd, k, c // k), dtype=torch.float32, device=x.device)
    for i in range(t):
        out += a[:, i, ..., None].float() * xs[:, i]
    if den is not None:
        out = out / den[:, None, None, None, None]
    return out.reshape(b, h, wd, c).to(x.dtype)


def kernel_route(c: int, k: int, dtype: torch.dtype) -> int:
    """The kernels' route for C channels in K heads of x's ``dtype``: the
    vector route's L (channels of a head within a thread's 16-byte vector of
    V values: min(C/K, V)) where V divides C and a head either fits a vector
    (C/K divides V) or spans a power of two of vectors, at most 32; else 0,
    the general route. The wrapper takes 0 too where a pointer is not
    16-byte aligned."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    cpk = c // k
    if c % v:
        return 0
    if cpk <= v:
        return cpk if v % cpk == 0 else 0
    g = cpk // v
    return v if cpk % v == 0 and g <= MAX_SHUFFLE and g & (g - 1) == 0 else 0


@functools.cache
def _kernels():
    """The C entries of csrc/temporal_aggregate.cu: (forward, backward)."""
    lib = load_library("temporal_aggregate")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd, bwd = lib.temporal_aggregate_fwd, lib.temporal_aggregate_bwd
    # x, w, pad, den, out | x_is_bf16, route, B T H W C K | w's 5 strides | stream
    fwd.argtypes = [vp] * 5 + [ci] * 8 + [cl] * 5 + [vp]
    # x, w, pad, den, dout, dx, dw | ...
    bwd.argtypes = [vp] * 7 + [ci] * 8 + [cl] * 5 + [vp]
    fwd.restype = bwd.restype = ci
    return fwd, bwd


def _ptr(a):
    return None if a is None else a.data_ptr()


def _route(x, w, *vectors) -> int:
    b, t, h, wd, c = x.shape
    route = kernel_route(c, w.shape[2], x.dtype)
    return route if all(a.data_ptr() % 16 == 0 for a in vectors) else 0


def _launch(entry, direction, x, w, pad, den, tensors, route) -> None:
    b, t, h, wd, c = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = entry(x.data_ptr(), w.data_ptr(), _ptr(pad), _ptr(den), *map(_ptr, tensors),
                   int(x.dtype == torch.bfloat16), route, b, t, h, wd, c, w.shape[2],
                   *w.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"temporal_aggregate_{direction} kernel launch failed: "
                           f"cudaError {rc}")


class _Aggregate(torch.autograd.Function):
    """The kernel pair; pad (B, T) bool (one byte an element, which the
    kernels read as 0 or 1) or None, den (B,) fp32 or None."""

    @staticmethod
    def forward(ctx, x, w, pad, den):
        out = torch.empty(x.shape[:1] + x.shape[2:], dtype=x.dtype, device=x.device)
        _launch(_kernels()[0], "fwd", x, w, pad, den, (out,), _route(x, w, x, out))
        count("aggregate.kernel")
        ctx.save_for_backward(x, w, pad, den)
        return out

    @staticmethod
    def backward(ctx, dout):
        with span("aggregate.bwd"):
            x, w, pad, den = ctx.saved_tensors
            dout = dout.contiguous()
            dx = torch.empty_like(x)
            dw = (torch.empty(w.shape, dtype=w.dtype, device=w.device)
                  if ctx.needs_input_grad[1] else None)
            _launch(_kernels()[1], "bwd", x, w, pad, den, (dout, dx, dw),
                    _route(x, w, x, dout, dx))
            return dx, dw, None, None


def weighted_sum(x, w, pad_mask=None, den=None) -> torch.Tensor:
    """``sum_t w[:, t, k(c)] * x[:, t, ..., c]`` over the dates that
    ``pad_mask`` leaves, divided by ``den`` where given (module docstring),
    differentiable in x and w.

    x: (B, T, H, W, C); w: (B, T, K, H, W) in x's dtype, any strides (the
    mean's mask may come expanded with stride 0), K dividing C (else
    ValueError, before any launch); pad_mask: (B, T) bool; den: (B,) fp32.
    Returns (B, H, W, C) in x's dtype. A CPU tensor runs
    ``weighted_sum_reference``; a CUDA tensor of fp32 or bf16 launches the
    kernels of ``csrc/temporal_aggregate.cu``."""
    _check(x, w, pad_mask, den)
    if x.device.type == "cpu":
        return weighted_sum_reference(x, w, pad_mask, den)
    if x.device.type != "cuda":
        raise ValueError(f"weighted_sum runs on cuda or cpu, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"the aggregate kernels take float32 or bfloat16 x and weights of "
                        f"its dtype, got {x.dtype} and {w.dtype}")
    if den is not None and den.dtype != torch.float32:
        raise TypeError(f"den must be float32, got {den.dtype}")
    if any(a is not None and a.device != x.device for a in (w, pad_mask, den)):
        raise ValueError("weighted_sum's tensors must all lie on x's device")
    pad = None if pad_mask is None else pad_mask.to(torch.bool).contiguous()
    return _Aggregate.apply(x.contiguous(), w, pad,
                            None if den is None else den.contiguous())
