"""Fused masked L-TAE eval forward: CUDA C++ kernel for Hopper + plain version
(port of crop2seg_tpu/ops/ltae_pallas.py::ltae_fused_forward).

Per pixel row over T steps, for each of nq learnable queries per head:

    [max(x*sc + sh, 0)] -> GroupNorm_G over (T, C/G) -> 1x1 proj C->D + PE
    -> masked softmax over T per (head, query) -> head-grouped weighted sum
    -> MLP (eval BN folded) + ReLU per query
    -> GroupNorm_G pooling each group's channels over all nq queries -> affine

``ltae_fused_forward`` does the offline folds in fp32 and launches a kernel
of ``csrc/ltae_fused_fwd.cu`` on a CUDA tensor; on a CPU tensor it calls
``ltae_fused_forward_reference``, the plain PyTorch version that
materializes the projected sequence h. ``kernel_route`` picks the kernel:
the row-group kernels (S = ``launch_shape`` persistent blocks per batch
item, each walking its ``row_ranges`` in groups of rows) take T <= 64, C <=
128 with C % 8 == 0, G <= 16, D and d_out <= 256 and nq <= 8
(``kernel_takes``): "group" for one query at C <= 64, "wide" for one query
above, "queries" for nq > 1; the "general" kernel takes every other shape
at which the L-TAE is defined (G dividing C, D and d_out), T > 64 above all,
on ``blocks_per_item`` blocks a batch item in groups of rows, x in chunks
of T kept on chip where it fits (``general_plan``).
``ltae_fused_forward.launches`` counts launches, and ``.route_launches``
counts them per route.
With nq = 1 (q of shape (G, d_k) or (G, 1, d_k)) out is (B, N, d_out) and
attn (B, N, G, T); with nq > 1 they gain a query axis, (B, N, nq, d_out) and
(B, N, G, nq, T), the JAX package's ranks.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Dict, Mapping, Optional

import torch

from crop2seg_tpu_torch.ops._build import load_library
from crop2seg_tpu_torch.ops.ltae_pool import aligned16, blocks_per_item

# The row-group kernels' limits; the general kernel takes the rest.
MAX_T = 64          # one warp holds a row's scores: lanes own t and t + 32
MAX_C = 128         # the x tile of a row group fits in shared memory
MAX_HEADS = 16      # per-head accumulators live in registers
MAX_QUERIES = 8     # queries per head: the group's MLP outputs of all queries
                    # stay in shared memory for the out-GroupNorm
GROUP_MAX_C = 64    # one query: 8-row groups at C <= GROUP_MAX_C, 4-row above
MAX_D = 256         # the projection gives a thread to each (d, half of the sum)
MAX_D_OUT = 256     # the group's MLP outputs stay in shared memory
ROUTES = ("group", "wide", "queries", "general")   # the C entry's route ids


def fold_batchnorm(wm, bm, bn_scale, bn_bias, bn_mean, bn_var, eps: float = 1e-5):
    """Fold eval BatchNorm1d into the MLP Dense: y = (xW + b - m)/s*g + B."""
    s = bn_scale * torch.rsqrt(bn_var + eps)
    return wm * s[None, :], (bm - bn_mean) * s + bn_bias


def params_from_ltae_variables(sd: Mapping[str, torch.Tensor],
                               prefix: str = "") -> Dict[str, torch.Tensor]:
    """The kernel's parameter dict from an LTAE state dict (reference torch
    names), in the JAX package's layout: in_scale, in_bias (C,), win (C, D),
    bin, wk (D, G*d_k), bk, q (G, nq, d_k), wm_folded (D, d_out), bm_folded,
    out_scale, out_bias."""
    def p(name):
        return sd[prefix + name].float()

    wm, bm = fold_batchnorm(
        p("mlp.0.weight").t(), p("mlp.0.bias"), p("mlp.2.weight"),
        p("mlp.2.bias"), p("mlp.2.running_mean"), p("mlp.2.running_var"))
    return {
        "in_scale": p("in_norm.weight"), "in_bias": p("in_norm.bias"),
        "win": p("inconv.weight")[:, :, 0].t(), "bin": p("inconv.bias"),
        "wk": p("attention_head.fc1_k.weight").t(),
        "bk": p("attention_head.fc1_k.bias"),
        "q": p("attention_head.Q"),
        "wm_folded": wm, "bm_folded": bm,
        "out_scale": p("out_norm.weight"), "out_bias": p("out_norm.bias"),
    }


def _query(params, n_head: int) -> torch.Tensor:
    """The learnable queries as (G, nq, d_k) fp32; q (G, d_k) is nq = 1."""
    q = params["q"]
    if q.dim() == 2:
        q = q[:, None]
    if q.shape[0] != n_head:
        raise ValueError(f"q has {q.shape[0]} heads, expected {n_head}")
    return q.float()


def ltae_fused_forward_reference(x, pe, pad_mask, params, *, n_head: int = 16,
                                 d_k: int = 4, eps: float = 1e-5,
                                 need_attn: bool = True,
                                 tail_affine: Optional[tuple] = None):
    """Plain fp32 PyTorch version of the kernel, on the same arguments.

    x (B, T, N, C), pe (B, T, D), pad_mask (B, T) bool. Returns out in x's
    dtype and attn fp32 or None: (B, N, d_out) and (B, N, G, T) for one query,
    (B, N, nq, d_out) and (B, N, G, nq, T) for nq > 1. Query q of head g
    weighs head g's values; the out GroupNorm pools group g's channels over
    all queries, with the affine shared across queries."""
    b, t, n, c = x.shape
    g = n_head
    xf = x.float()
    if tail_affine is not None:
        sc, sh = tail_affine
        xf = torch.relu(xf * sc.float()[:, :, None, :] + sh.float()[:, :, None, :])
    xg = xf.reshape(b, t, n, g, c // g)
    mean = xg.mean(dim=(1, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 4), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, t, n, c)
    xn = xn * params["in_scale"].float() + params["in_bias"].float()
    h = xn @ params["win"].float() + params["bin"].float() + pe.float()[:, :, None, :]
    d = h.shape[-1]
    k = (h @ params["wk"].float() + params["bk"].float()).reshape(b, t, n, g, d_k)
    hv = h.reshape(b, t, n, g, d // g)
    q = _query(params, g)
    nq = q.shape[1]
    ms, attns = [], []
    for qi in range(nq):                     # the kernel's loop over queries
        scores = torch.einsum("btngk,gk->bngt", k, q[:, qi]) / math.sqrt(d_k)
        scores = scores.masked_fill(pad_mask.to(torch.bool)[:, None, None, :], -1e6)
        attn = torch.softmax(scores, dim=-1)                      # (B, N, G, T)
        o = torch.einsum("bngt,btngv->bngv", attn, hv).reshape(b, n, d)
        ms.append(torch.relu(o @ params["wm_folded"].float()
                             + params["bm_folded"].float()))
        attns.append(attn)
    m = torch.stack(ms, dim=2)                                    # (B, N, nq, d_out)
    d_out = m.shape[-1]
    mg = m.reshape(b, n, nq, g, d_out // g).transpose(2, 3).reshape(b, n, g, -1)
    mmean = mg.mean(dim=-1, keepdim=True)
    mvar = (mg - mmean).square().mean(dim=-1, keepdim=True)
    out = ((mg - mmean) * torch.rsqrt(mvar + eps)).reshape(
        b, n, g, nq, d_out // g).transpose(2, 3).reshape(b, n, nq, d_out)
    out = out * params["out_scale"].float() + params["out_bias"].float()
    attn = torch.stack(attns, dim=3)                              # (B, N, G, nq, T)
    if nq == 1:
        out, attn = out[:, :, 0], attn[:, :, :, 0]
    return out.to(x.dtype), (attn if need_attn else None)


def _fold(pe, pad_mask, params, n_head: int, d_k: int):
    """The offline folds, fp32: in-GN affine into W_in, the queries into the
    key projection (U = W_k q / sqrt(d_k), one column per (head, query),
    head-major: column g*nq + q), U through W_in (Ws = W_in U) and through
    bias + PE (pes = (b_in + pe) U + cs, -1e6 at pads)."""
    f = {k: v.float() for k, v in params.items()}
    d = f["win"].shape[1]
    win = f["win"] * f["in_scale"][:, None]
    bin_ = f["bin"] + f["in_bias"] @ f["win"]
    q = _query(params, n_head)
    u = (torch.einsum("dgk,gqk->dgq", f["wk"].reshape(d, n_head, d_k), q)
         / math.sqrt(d_k)).reshape(d, -1)
    cs = (torch.einsum("gk,gqk->gq", f["bk"].reshape(n_head, d_k), q)
          / math.sqrt(d_k)).reshape(-1)
    pes = pe.float() @ u + (bin_ @ u + cs)
    pes = pes - 1e6 * pad_mask.float()[:, :, None]
    return {"pe": pe.float(), "win": win, "bin": bin_, "ws": win @ u,
            "pes": pes.transpose(1, 2), "wm": f["wm_folded"],
            "bm": f["bm_folded"], "osc": f["out_scale"], "obi": f["out_bias"]}


def _check_defined(c: int, d: int, g: int, d_out: int) -> None:
    """The L-TAE is defined where its G heads divide C, D and d_out (the
    GroupNorms' groups and the heads' channels); ValueError elsewhere."""
    if g < 1 or c % g or d % g or d_out % g:
        raise ValueError(f"unsupported shape C={c} G={g} D={d} d_out={d_out}: "
                         f"G must divide C, D and d_out")


def kernel_takes(t: int, c: int, d: int, g: int, d_out: int, nq: int) -> bool:
    """Whether a row-group kernel takes T steps, C channels, D = d_model, G
    heads, d_out MLP outputs and nq queries per head (``launch_shape``
    raises past these limits); the general kernel takes the other shapes."""
    return (t <= MAX_T and c <= MAX_C and c % 8 == 0 and g <= MAX_HEADS
            and c % g == 0 and d % g == 0 and d_out % g == 0
            and nq <= MAX_QUERIES and d <= MAX_D and d_out <= MAX_D_OUT)


def kernel_route(t: int, c: int, d: int, g: int, d_out: int, nq: int) -> str:
    """The kernel that serves a shape, one of ``ROUTES``: a row-group kernel
    where ``kernel_takes`` says so ("group" for one query at C <=
    GROUP_MAX_C, "wide" for one query above, "queries" for nq > 1), else
    "general". ValueError where the L-TAE is not defined."""
    _check_defined(c, d, g, d_out)
    if not kernel_takes(t, c, d, g, d_out, nq):
        return "general"
    if nq > 1:
        return "queries"
    return "group" if c <= GROUP_MAX_C else "wide"


def launch_shape(b: int, t: int, c: int, d: int, g: int, d_out: int, nq: int,
                 sm_count: int) -> int:
    """Check a launch against the row-group kernels' limits (``kernel_takes``;
    ValueError past them) and return S, their persistent blocks per batch
    item (``blocks_per_item``: one wave of B * S <= sm_count blocks, each
    taking ``ltae_pool.row_ranges(N, S)[i]``)."""
    if not kernel_takes(t, c, d, g, d_out, nq):
        raise ValueError(
            f"unsupported shape T={t} C={c} G={g} D={d} d_out={d_out} nq={nq}: "
            f"the row-group kernels take T<={MAX_T}, C<={MAX_C} with C%8==0, "
            f"G<={MAX_HEADS} dividing C, D and d_out, nq<={MAX_QUERIES}, "
            f"D<={MAX_D}, d_out<={MAX_D_OUT}")
    return blocks_per_item(b, sm_count)


@functools.cache
def _kernel():
    """The C entries: (ltae_fused_fwd, ltae_fused_general_scratch_floats,
    ltae_fused_general_plan)."""
    lib = load_library("ltae_fused_fwd")
    fn, scratch = lib.ltae_fused_fwd, lib.ltae_fused_general_scratch_floats
    plan = lib.ltae_fused_general_plan
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # x, x_is_bf16 | pe .. attn | B T N C D G DOUT NQ route S | scratch, eps, stream
    fn.argtypes = [vp, ci] + [vp] * 13 + [ci] * 10 + [vp, ctypes.c_float, vp]
    scratch.argtypes = [ci] * 8
    plan.argtypes = [ci] * 8 + [vp]
    fn.restype = scratch.restype = plan.restype = ci
    return fn, scratch, plan


def general_plan(t: int, c: int, d: int, g: int, d_out: int, nq: int,
                 dtype: torch.dtype, need_attn: bool) -> tuple:
    """The general kernel's plan for x of ``dtype``, from the C entry
    (csrc/ltae_fused_fwd.cu::ge_plan): (rows a group, x resident, scores on
    chip, W_in in shared memory, W_m in shared memory, workspace floats).
    Builds the library, so it needs nvcc."""
    out = (ctypes.c_int * 6)()
    if rc := _kernel()[2](t, c, d, g, d_out, nq, int(dtype == torch.bfloat16),
                          int(need_attn), out):
        raise RuntimeError(f"ltae_fused_general_plan failed (error {rc})")
    return tuple(out)


def ltae_fused_forward(x: torch.Tensor, pe: torch.Tensor,
                       pad_mask: torch.Tensor, params: Dict[str, torch.Tensor],
                       *, n_head: int = 16, d_k: int = 4, eps: float = 1e-5,
                       need_attn: bool = True,
                       tail_affine: Optional[tuple] = None):
    """Fused L-TAE eval forward, nq queries per head.

    x: time-major rows (B, T, N, C), fp32 or bf16 (N = H*W, a free reshape of
    (B, T, H, W, C)); pe (B, T, D); pad_mask (B, T) bool; params as
    ``params_from_ltae_variables`` returns (q (G, nq, d_k)). tail_affine:
    optional (sc, sh) of (B, T, C), applied as ``max(x*sc + sh, 0)`` on load.
    Returns (out (B, N, d_out) in x's dtype, attn (B, N, G, T) fp32 or None)
    for nq = 1; (B, N, nq, d_out) and (B, N, G, nq, T) for nq > 1.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    of ``kernel_route``. A shape where G does not divide C, D and d_out
    raises on either.
    """
    nq = _query(params, n_head).shape[1]
    _check_defined(x.shape[-1], params["win"].shape[1], n_head,
                   params["wm_folded"].shape[1])
    if x.device.type == "cpu":
        return ltae_fused_forward_reference(
            x, pe, pad_mask, params, n_head=n_head, d_k=d_k, eps=eps,
            need_attn=need_attn, tail_affine=tail_affine)
    if x.device.type != "cuda":
        raise ValueError(f"ltae_fused_forward runs on cuda or cpu, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned (B, T, N, C) tensor")
    b, t, n, c = x.shape
    g = n_head
    d, d_out = params["win"].shape[1], params["wm_folded"].shape[1]
    route = kernel_route(t, c, d, g, d_out, nq)
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    s = (blocks_per_item(b, sm_count) if route == "general"
         else launch_shape(b, t, c, d, g, d_out, nq, sm_count))
    if pe.shape != (b, t, d) or pad_mask.shape != (b, t):
        raise ValueError(f"pe {tuple(pe.shape)} / pad_mask {tuple(pad_mask.shape)} "
                         f"do not match x {tuple(x.shape)}, D={d}")
    with torch.autocast(x.device.type, enabled=False):
        f = _fold(pe, pad_mask, params, g, d_k)
        if tail_affine is not None:
            tsc, tsh = (a.float() for a in tail_affine)
            if tsc.shape != (b, t, c) or tsh.shape != (b, t, c):
                raise ValueError(f"tail_affine must be (B, T, C) = {(b, t, c)}")
            f["tsc"], f["tsh"] = tsc, tsh
    f = {k: aligned16(v.to(x.device).contiguous()) for k, v in f.items()}
    out = torch.empty(b, n, nq, d_out, dtype=x.dtype, device=x.device)
    attn = (torch.empty(b, n, g, nq, t, dtype=torch.float32, device=x.device)
            if need_attn else None)

    def ptr(name):
        return f[name].data_ptr() if name in f else None

    fn, scratch_floats, _ = _kernel()
    scratch = None
    if route == "general" and (per := scratch_floats(
            t, c, d, g, d_out, nq, int(x.dtype == torch.bfloat16), int(need_attn))):
        scratch = torch.empty(b * s * per, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                ptr("pe"), ptr("win"), ptr("bin"), ptr("ws"), ptr("pes"),
                ptr("wm"), ptr("bm"), ptr("osc"), ptr("obi"),
                ptr("tsc"), ptr("tsh"), out.data_ptr(),
                None if attn is None else attn.data_ptr(),
                b, t, n, c, d, g, d_out, nq, ROUTES.index(route), s,
                None if scratch is None else scratch.data_ptr(), eps, stream)
    if rc != 0:
        raise RuntimeError(f"ltae_fused_fwd kernel launch failed ({route}): cudaError {rc}")
    ltae_fused_forward.launches += 1
    ltae_fused_forward.route_launches[route] += 1
    if nq == 1:
        return out[:, :, 0], (None if attn is None else attn[:, :, :, 0])
    return out, attn


ltae_fused_forward.launches = 0
ltae_fused_forward.route_launches = collections.Counter()
