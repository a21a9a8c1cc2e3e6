"""L-TAE stage dump: CUDA C++ kernel for Hopper + plain version (port of
scripts/debug_ltae_stages.py::_kernel, the fused eval kernel's stages each
written out, for checking a rebuilt kernel stage by stage).

Per pixel row over T steps, fp32 (eps 1e-5):

    xn     = GroupNorm_G(x) over (T, C/G), no affine, one-pass variance
             (E[x^2] - E[x]^2)
    h      = xn @ win + bin + pe[t]                   (T, D)   -> h0 = h[t=0]
    scores = h @ u + cs                               (G, T)   before the mask
    attn   = softmax_T(scores, -1e6 where mask > 0.5) (G, T)
    o[d]   = sum_t attn[g(d), t] h[t, d]              (D,)

``ltae_stages`` launches the kernel of ``csrc/ltae_stages.cu`` on a CUDA
tensor and runs ``ltae_stages_reference`` on a CPU tensor;
``ltae_stages.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from crop2seg_tpu_torch.ops._build import load_library

MAX_T = 64          # one warp holds a (row, head)'s softmax: lanes own t and t + 32
MAX_C = 128


def ltae_stages_reference(x, pe, mask, win, bin_, u, cs, *, n_head: int = 16,
                          eps: float = 1e-5):
    """Plain fp32 PyTorch version, the formulas of the stage kernel.

    x (B, T, N, C), pe (B, T, D), mask (B, 1, T) (> 0.5 at pads), win (C, D),
    bin_ (D,), u (D, G), cs (1, G). Returns h0 (B, N, D), scores and attn
    (B, N, G, T), o (B, N, D), all fp32."""
    b, t, n, c = x.shape
    g = n_head
    xf = x.float()
    xg = xf.reshape(b, t, n, g, c // g)
    cnt = t * (c // g)
    mean = xg.sum(dim=(1, 4), keepdim=True) / cnt
    var = xg.square().sum(dim=(1, 4), keepdim=True) / cnt - mean.square()
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, t, n, c)
    h = (xn @ win.float() + bin_.float()) + pe.float()[:, :, None, :]  # (B, T, N, D)
    d = h.shape[-1]
    scores = (h @ u.float() + cs.float()).permute(0, 2, 3, 1)          # (B, N, G, T)
    masked = scores.masked_fill(mask.float()[:, :, None, :] > 0.5, -1e6)
    attn = torch.softmax(masked, dim=-1)
    o = torch.einsum("bngt,btngv->bngv", attn,
                     h.reshape(b, t, n, g, d // g)).reshape(b, n, d)
    return h[:, 0], scores, attn, o


@functools.cache
def _kernel():
    lib = load_library("ltae_stages")
    fn = lib.ltae_stages
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 11 + [ci] * 6 + [ctypes.c_float, vp]
    fn.restype = ci
    return fn


def ltae_stages(x, pe, mask, win, bin_, u, cs, *, n_head: int = 16,
                eps: float = 1e-5):
    """The stage dump: arguments and results as ``ltae_stages_reference``.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return ltae_stages_reference(x, pe, mask, win, bin_, u, cs,
                                     n_head=n_head, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"ltae_stages runs on cuda or cpu, got {x.device}")
    b, t, n, c = x.shape
    d, g = win.shape[1], n_head
    if not (t <= MAX_T and c <= MAX_C and c % g == 0 and d % g == 0):
        raise ValueError(f"unsupported shape T={t} C={c} D={d} G={g}: the kernel "
                         f"takes T<={MAX_T}, C<={MAX_C}, G dividing C and D")
    shapes = {"pe": (pe, (b, t, d)), "mask": (mask, (b, 1, t)), "win": (win, (c, d)),
              "bin": (bin_, (d,)), "u": (u, (d, g)), "cs": (cs, (1, g))}
    for name, (a, want) in shapes.items():
        if tuple(a.shape) != want:
            raise ValueError(f"{name} is {tuple(a.shape)}, expected {want}")
    args = [a.to(x.device, torch.float32).contiguous()
            for a in (x, pe, mask, win, bin_, u, cs)]
    h0 = torch.empty(b, n, d, device=x.device)
    scores = torch.empty(b, n, g, t, device=x.device)
    attn = torch.empty_like(scores)
    o = torch.empty(b, n, d, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*(a.data_ptr() for a in args), h0.data_ptr(), scores.data_ptr(),
                attn.data_ptr(), o.data_ptr(), b, t, n, c, d, g, eps, stream)
    if rc != 0:
        raise RuntimeError(f"ltae_stages kernel launch failed: cudaError {rc}")
    ltae_stages.launches += 1
    return h0, scores, attn, o


ltae_stages.launches = 0
