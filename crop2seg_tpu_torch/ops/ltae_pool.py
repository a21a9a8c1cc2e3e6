"""Masked L-TAE attention pooling with a hand-written backward, training path:
two CUDA C++ kernels for Hopper and their plain versions (port of
crop2seg_tpu/ops/ltae_pallas_train.py::ltae_pool and ::ltae_pool_tail, fp32
and bf16).

Per pixel row, T steps, C channels, G heads of D/G channels (eps 1e-5):

    xhat = GroupNorm_G(x) over (T, C/G), no affine   (folded into win_f, bin_f)
    h    = xhat @ win_f + bin_f + pe[t]               (T, D)
    s    = h @ u + cs, -1e6 at pads                   (T, G): the query folded into u
    a    = softmax_T(s);  a_d = a * keep / (1 - p)    attention dropout after softmax
    o[d] = sum_t a_d[t, g(d)] h[t, d]                 (D,)

``ltae_pool_tail`` takes the raw output z of the producing conv instead of x,
with that conv's deferred GroupNorm affine ``(tsc, tsh)`` of shape (B, T, C):
``x = where(z*tsc + tsh > 0, z*tsc + tsh, 0)``, applied inside the kernels,
so the normalized copy never reaches device memory in either direction, and
the backward also returns dtsc and dtsh.

``keep`` is a stateless hash of ``(seed, b, t, n, g)`` (``keep_mask``), so
the forward and the backward kernel draw the same mask, whatever their block
shapes, and the plain versions draw it too: the kernels and
``ltae_pool_reference`` agree at any ``drop_p``, not only in distribution.

``ltae_pool`` and ``ltae_pool_tail`` run the plain version under torch
autograd for a CPU tensor and the kernel pair of ``csrc/ltae_pool.cu`` (a
``torch.autograd.Function``) for a CUDA tensor, with x (z) in fp32 or bf16; o
and dx come back in x's dtype, every other gradient in fp32.
``ltae_pool.launches_fwd`` / ``.launches_bwd`` count the kernels' launches,
and ``ltae_pool.launches`` counts them per variant (``variant``). The pair's
wrappers are the spans ``ltae.pool.fwd`` and ``ltae.pool.bwd``, the second
on autograd's backward thread.

Routes: where ``kernel_takes`` (T <= 64, C <= 64 with C % 8 == 0, G <= 16,
D <= 256: TimeUNet's training path) the forward kernel runs S =
``fwd_launch_shape(...)`` persistent blocks per batch item, each walking its
``row_ranges`` in groups of 8 rows, and writes o in one pass over x; every
other shape at which the L-TAE is defined (G dividing C and D) takes the
general pair (variants ``..._general``). Both of its kernels run S =
``blocks_per_item`` persistent blocks per batch item, one an SM, each
walking its ``row_ranges`` in groups of rows, with x in chunks of 32 steps
kept on chip for the whole group where it fits (the plans
``general_fwd_plan`` and ``general_bwd_plan``). The forward runs an online
softmax over the chunks and saves each row's GroupNorm statistics and
softmax max and sum (B, N, 4, G) for its backward.

The folds and the small products around the kernels run in fp32 with
autocast off, from fp32 parameters, as the JAX package computes them, whatever
the caller's autocast state.

The backward kernel never builds h: per row and head it works in C-space
with ``Z[g] = win_f[:, d in g] @ go[d in g]`` and ``P[g] = sum_t a_d[t, g]
xhat[t]``, and it sums four row reductions over the whole grid: ``A = sum
xhat^T ds`` (C, G), ``F[c, d] = sum P[g(d), c] go[d]`` (C, D), ``Dsum_b =
sum ds`` (B, T, G) and ``E_b[t, d] = sum a_d[t, g(d)] go[d]`` (B, T, D); in
tail mode also ``dtsc = sum_rows live z`` and ``dtsh = sum_rows live`` (B,
T, C), with ``live = dxf * 1[z*tsc + tsh > 0]`` and ``dz = live * tsc``.
Its S persistent blocks per batch item (``blocks_per_item``) each sum a
contiguous range of rows (``row_ranges``) on chip and write one partial, and
a second small kernel adds the partials in a fixed order, so the sums are the
same from run to run; ``ltae_pool.launches`` counts the pair as one backward
launch. The six other gradients follow from the four sums in a few small
products here (``_finish_backward``):

    dW_f = A u^T + F          du  = W_f^T A + sum_b (bin_f + pe_b)^T Dsum_b
    dpe  = Dsum u^T + E       db_f = sum_{b,t} dpe      dcs = sum Dsum
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from crop2seg_tpu_torch.ops._build import load_library
from crop2seg_tpu_torch.utils.profiling import span

# The fast pair's limits; the general pair takes the rest.
MAX_T = 64          # one warp holds a row's scores: lanes own t and t + 32
MAX_C = 64          # lanes own channels c and c + 32
MAX_HEADS = 16      # per-head accumulators live in registers
MAX_D = 256         # the forward gives a thread to each (d, half of a row group);
                    # the backward holds win_f and bin_f + pe in shared memory
EPS = 1e-5          # the input GroupNorm's epsilon
_M32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit integer hash (xor-shift-multiply; both multipliers < 2**31, so
    the int64 products below never overflow). The kernels run the same
    arithmetic on uint32. Works on Python ints and int64 tensors."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def dropout_threshold(drop_p: float) -> int:
    """Keep an element when its 32-bit hash is >= this threshold."""
    if not 0.0 <= drop_p < 1.0:
        raise ValueError(f"drop_p must lie in [0, 1), got {drop_p}")
    return min(int(drop_p * 2.0 ** 32), _M32)


def keep_mask(seed: int, b: int, t: int, n: int, g: int, drop_p: float,
              device=None) -> torch.Tensor:
    """The attention-dropout keep mask, bool (B, T, N, G): element
    ``(b, t, n, g)`` is kept when ``mix32(mix32(i) ^ mix32(seed)) >=
    dropout_threshold(drop_p)``, with ``i = ((b*T + t)*N + n)*G + g`` mod 2**32."""
    i = torch.arange(b * t * n * g, dtype=torch.int64, device=device) & _M32
    h = _mix32(_mix32(i) ^ _mix32(int(seed) & _M32))
    return (h >= dropout_threshold(drop_p)).reshape(b, t, n, g)


def variant(tail: bool, dtype: torch.dtype, direction: str,
            general: bool = False) -> str:
    """A kernel variant's name, the key of ``ltae_pool.launches``:
    ``ltae_pool[_tail]_{fwd,bwd}[_bf16][_general]``."""
    return (f"ltae_pool{'_tail' if tail else ''}_{direction}"
            f"{'_bf16' if dtype == torch.bfloat16 else ''}"
            f"{'_general' if general else ''}")


def kernel_takes(t: int, c: int, d: int, g: int) -> bool:
    """Whether the fast kernel pair takes T steps, C channels, D = d_model
    and G heads (the limits above; ``_check_limits`` raises past them); the
    general pair takes the other shapes."""
    return (t <= MAX_T and c <= MAX_C and c % 8 == 0 and g <= MAX_HEADS
            and c % g == 0 and d % g == 0 and d <= MAX_D)


def _check_limits(t: int, c: int, d: int, g: int) -> None:
    if not kernel_takes(t, c, d, g):
        raise ValueError(
            f"unsupported shape T={t} C={c} G={g} D={d}: the kernels take "
            f"T<={MAX_T}, C<={MAX_C} with C%8==0, G<={MAX_HEADS} dividing C and D, "
            f"D<={MAX_D}")


def _check(x, pe, pad_mask, win_f, bin_f, u, cs, n_head, tail=None):
    b, t, n, c = x.shape
    d = win_f.shape[1]
    if n_head < 1 or c % n_head or d % n_head:
        raise ValueError(f"unsupported shape C={c} G={n_head} D={d}: G must divide "
                         f"C and D")
    want = {"pe": (b, t, d), "pad_mask": (b, t), "win_f": (c, d), "bin_f": (d,),
            "u": (d, n_head), "cs": (1, n_head)}
    got = {"pe": pe, "pad_mask": pad_mask, "win_f": win_f, "bin_f": bin_f,
           "u": u, "cs": cs}
    if tail is not None:
        want.update(tsc=(b, t, c), tsh=(b, t, c))
        got.update(tsc=tail[0], tsh=tail[1])
    for k, shape in want.items():
        if tuple(got[k].shape) != shape:
            raise ValueError(f"{k} is {tuple(got[k].shape)}, expected {shape}")


def ltae_pool_reference(x, pe, pad_mask, win_f, bin_f, u, cs, seed: int = 0, *,
                        n_head: int = 16, drop_p: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel pair (differentiable by torch
    autograd), in fp32 (fp64 for fp64 input) with autocast off: x (B, T, N,
    C), pe (B, T, D), pad_mask (B, T) bool, win_f (C, D), bin_f (D,), u (D,
    G), cs (1, G) -> o (B, N, D) in x's dtype."""
    b, t, n, c = x.shape
    g = n_head
    dt = torch.promote_types(x.dtype, torch.float32)   # fp32, or fp64 in tests
    with torch.autocast(x.device.type, enabled=False):
        xg = x.to(dt).reshape(b, t, n, g, c // g)
        mean = xg.mean(dim=(1, 4), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 4), keepdim=True)
        xhat = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(b, t, n, c)
        h = xhat @ win_f.to(dt) + bin_f.to(dt) + pe.to(dt)[:, :, None, :]
        s = h @ u.to(dt) + cs.to(dt)
        s = s.masked_fill(pad_mask.to(torch.bool)[:, :, None, None], -1e6)
        a = torch.softmax(s, dim=1)                             # (B, T, N, G)
        if drop_p > 0.0:
            keep = keep_mask(seed, b, t, n, g, drop_p, device=x.device)
            a = a * keep.to(dt) * (1.0 / (1.0 - drop_p))
        d = h.shape[-1]
        o = torch.einsum("btng,btngv->bngv", a, h.reshape(b, t, n, g, d // g))
    return o.reshape(b, n, d).to(x.dtype)


def ltae_pool_tail_reference(z, tsc, tsh, pe, pad_mask, win_f, bin_f, u, cs,
                             seed: int = 0, *, n_head: int = 16,
                             drop_p: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the tail-mode pair: ``ltae_pool_reference``
    of ``where(z*tsc + tsh > 0, z*tsc + tsh, 0)`` (the where-form ReLU, whose
    subgradient at 0 is 0, as the kernels' mask), tsc/tsh (B, T, C) applied to
    every row of frame (b, t). The product and the sum round one after the
    other, as the kernels round them. o (B, N, D) in z's dtype."""
    dt = torch.promote_types(z.dtype, torch.float32)
    with torch.autocast(z.device.type, enabled=False):
        pre = z.to(dt) * tsc.to(dt)[:, :, None] + tsh.to(dt)[:, :, None]
        xf = torch.where(pre > 0, pre, torch.zeros_like(pre))
    o = ltae_pool_reference(xf, pe, pad_mask, win_f, bin_f, u, cs, seed,
                            n_head=n_head, drop_p=drop_p)
    return o.to(z.dtype)


@functools.cache
def _kernels():
    """The C entries of csrc/ltae_pool.cu with their argument types:
    (forward, backward, partial-sum floats per backward block, general
    forward, general backward, general scratch floats per block, the general
    backward's plan, the general forward's plan)."""
    lib = load_library("ltae_pool")
    vp, ci, cf, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    fwd, bwd, part = lib.ltae_pool_fwd, lib.ltae_pool_bwd, lib.ltae_pool_bwd_part_floats
    gfwd, gbwd = lib.ltae_pool_fwd_general, lib.ltae_pool_bwd_general
    scratch, plan = lib.ltae_pool_general_scratch_floats, lib.ltae_pool_bwd_general_plan
    fplan = lib.ltae_pool_fwd_general_plan
    # x, x_is_bf16 | tsc, tsh, bpe, win, ws, pes, o | S B T N C D G |
    # seed_mix thresh scale eps stream
    fwd.argtypes = [vp, ci] + [vp] * 7 + [ci] * 7 + [cu, cu, cf, cf, vp]
    # x, x_is_bf16 | tsc, tsh, go, win, ws, pes, bpe, dx, A, F, Dsum, E,
    # dtsc, dtsh, part | S B T N C D G | ...
    bwd.argtypes = [vp, ci] + [vp] * 15 + [ci] * 7 + [cu, cu, cf, cf, vp]
    # general: ... o, st, scratch | S B T N C D G | ...
    gfwd.argtypes = [vp, ci] + [vp] * 9 + [ci] * 7 + [cu, cu, cf, cf, vp]
    # general: ... bpe, st, dx, A, F, Dsum, E, dtsc, dtsh, part, scratch | ...
    gbwd.argtypes = [vp, ci] + [vp] * 17 + [ci] * 7 + [cu, cu, cf, cf, vp]
    part.argtypes = [ci] * 5
    scratch.argtypes = [ci] * 6
    plan.argtypes = [ci] * 5 + [vp]                # T C D G x_is_bf16 | out[4]
    fplan.argtypes = [ci] * 5 + [vp]               # T C D G x_is_bf16 | out[5]
    for f in (fwd, bwd, part, gfwd, gbwd, scratch, plan, fplan):
        f.restype = ci
    return fwd, bwd, part, gfwd, gbwd, scratch, plan, fplan


def blocks_per_item(b: int, sm_count: int) -> int:
    """The persistent kernels' blocks per batch item, S: their B * S blocks
    (one per SM) form a single wave, so S = sm_count // B, and at least 1
    (then B > sm_count blocks run in more than one wave)."""
    return max(1, sm_count // b)


def row_ranges(n: int, s: int) -> list:
    """The rows [start, stop) of each of the S blocks of a batch item, in
    block order, as the kernels split them: contiguous, sizes differing by
    at most one, empty when n < s."""
    return [(i * n // s, (i + 1) * n // s) for i in range(s)]


def fwd_launch_shape(b: int, t: int, c: int, d: int, g: int, sm_count: int) -> int:
    """Check a forward launch against the kernels' limits (ValueError past
    them) and return S, the forward kernel's persistent blocks per batch item
    (``blocks_per_item``), each walking ``row_ranges(N, S)[i]`` in groups
    of 8 rows."""
    _check_limits(t, c, d, g)
    return blocks_per_item(b, sm_count)


def general_fwd_plan(t: int, c: int, d: int, g: int, dtype: torch.dtype) -> tuple:
    """The general forward's plan for x of ``dtype``, from the C entry
    (csrc/ltae_pool.cu::gf_plan): (rows a group, x resident, W_in in shared
    memory, steps a chunk, workspace floats). Builds the library, so it
    needs nvcc."""
    out = (ctypes.c_int * 5)()
    if rc := _kernels()[7](t, c, d, g, int(dtype == torch.bfloat16), out):
        raise RuntimeError(f"ltae_pool_fwd_general_plan failed (error {rc})")
    return tuple(out)


def general_bwd_plan(t: int, c: int, d: int, g: int, dtype: torch.dtype) -> tuple:
    """The general backward's plan for x of ``dtype``, from the C entry
    (csrc/ltae_pool.cu::gb_plan): (rows a group, x resident, steps a chunk,
    workspace floats). Builds the library, so it needs nvcc."""
    out = (ctypes.c_int * 4)()
    if rc := _kernels()[6](t, c, d, g, int(dtype == torch.bfloat16), out):
        raise RuntimeError(f"ltae_pool_bwd_general_plan failed (error {rc})")
    return tuple(out)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t itself if it starts on 16 bytes (the forward kernels copy tsc and tsh
    in 16-byte vectors), else a copy that does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _folds(pe, pad_mask, win_f, bin_f, u, cs):
    """Per-call folds in fp32: ws = win_f u (C, G); bpe = bin_f + pe (B, T, D);
    pes = bpe u + cs, -1e6 at pads, laid out (B, G, T)."""
    ws = win_f @ u
    bpe = bin_f + pe
    pes = bpe @ u + cs - 1e6 * pad_mask.float()[:, :, None]
    return ws.contiguous(), bpe.contiguous(), pes.transpose(1, 2).contiguous()


def _scalars(seed: int, drop_p: float):
    return (_mix32(int(seed) & _M32), dropout_threshold(drop_p),
            1.0 / (1.0 - drop_p))


def _ptr(a):
    return None if a is None else a.data_ptr()


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _general_scratch(t, c, d, g, backward: bool, blocks: int, x):
    """The general kernel's workspace in device memory where it does not fit
    in shared memory, else None."""
    per = _kernels()[5](t, c, d, g, int(backward), int(x.dtype == torch.bfloat16))
    return torch.empty(blocks * per, dtype=torch.float32, device=x.device) if per else None


def _count(tail: bool, dtype: torch.dtype, direction: str, general: bool) -> None:
    ltae_pool.launches[variant(tail, dtype, direction, general)] += 1
    if direction == "fwd":
        ltae_pool.launches_fwd += 1
    else:
        ltae_pool.launches_bwd += 1


class _LtaePool(torch.autograd.Function):
    """The kernel pair, the fast one where ``kernel_takes`` and the general
    one elsewhere; ``tsc``/``tsh`` None selects the untailed mode. The
    backward runs in the forward's autocast state (``custom_bwd``); the
    folds and the small products run in fp32 with autocast off either way."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, tsc, tsh, pe, pad_mask, win_f, bin_f, u, cs, seed,
                n_head, drop_p):
        with span("ltae.pool.fwd"):
            b, t, n, c = x.shape
            d = win_f.shape[1]
            with torch.autocast("cuda", enabled=False):
                ws, bpe, pes = _folds(pe, pad_mask, win_f, bin_f, u, cs)
            o = torch.empty(b, n, d, dtype=x.dtype, device=x.device)
            general = not kernel_takes(t, c, d, n_head)
            stats = None
            head = (x.data_ptr(), int(x.dtype == torch.bfloat16), _ptr(tsc), _ptr(tsh),
                    bpe.data_ptr(), win_f.data_ptr(), ws.data_ptr(), pes.data_ptr(),
                    o.data_ptr())
            tail_args = (b, t, n, c, d, n_head, *_scalars(seed, drop_p), EPS)
            kernels = _kernels()
            with torch.cuda.device(x.device):
                stream = torch.cuda.current_stream(x.device).cuda_stream
                if general:
                    s = blocks_per_item(b, _sm_count(x.device))
                    stats = torch.empty(b, n, 4, n_head, dtype=torch.float32, device=x.device)
                    scratch = _general_scratch(t, c, d, n_head, False, b * s, x)
                    rc = kernels[3](*head, stats.data_ptr(), _ptr(scratch), s, *tail_args,
                                    stream)
                else:
                    s = fwd_launch_shape(b, t, c, d, n_head, _sm_count(x.device))
                    rc = kernels[0](*head, s, *tail_args, stream)
            if rc != 0:
                raise RuntimeError(f"ltae_pool_fwd{'_general' if general else ''} kernel "
                                   f"launch failed: cudaError {rc}")
            _count(tsc is not None, x.dtype, "fwd", general)
            ctx.save_for_backward(x, tsc, tsh, win_f, u, ws, bpe, pes, stats)
            ctx.seed, ctx.n_head, ctx.drop_p = seed, n_head, drop_p
            return o

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, go):
        with span("ltae.pool.bwd"):
            x, tsc, tsh, win_f, u, ws, bpe, pes, stats = ctx.saved_tensors
            general = stats is not None
            tail = tsc is not None
            b, t, n, c = x.shape
            d, g = win_f.shape[1], ctx.n_head
            go = go.to(x.dtype).contiguous()
            dx = torch.empty_like(x)
            f32 = dict(dtype=torch.float32, device=x.device)
            acc_a, acc_f = torch.empty(c, g, **f32), torch.empty(c, d, **f32)
            dsum, acc_e = torch.empty(b, t, g, **f32), torch.empty(b, t, d, **f32)
            dtsc, dtsh = ((torch.empty(b, t, c, **f32), torch.empty(b, t, c, **f32))
                          if tail else (None, None))
            kernels = _kernels()
            s = blocks_per_item(b, _sm_count(x.device))
            part = torch.empty(b * s, kernels[2](t, c, d, g, int(tail)), **f32)
            args = (x.data_ptr(), int(x.dtype == torch.bfloat16), _ptr(tsc), _ptr(tsh),
                    go.data_ptr(), win_f.data_ptr(), ws.data_ptr(), pes.data_ptr(),
                    bpe.data_ptr())
            sums = (dx.data_ptr(), acc_a.data_ptr(), acc_f.data_ptr(), dsum.data_ptr(),
                    acc_e.data_ptr(), _ptr(dtsc), _ptr(dtsh), part.data_ptr())
            scalars = (b, t, n, c, d, g, *_scalars(ctx.seed, ctx.drop_p), EPS)
            with torch.cuda.device(x.device):
                stream = torch.cuda.current_stream(x.device).cuda_stream
                if general:
                    scratch = _general_scratch(t, c, d, g, True, b * s, x)
                    rc = kernels[4](*args, stats.data_ptr(), *sums, _ptr(scratch), s,
                                    *scalars, stream)
                else:
                    rc = kernels[1](*args, *sums, s, *scalars, stream)
            if rc != 0:
                raise RuntimeError(f"ltae_pool_bwd{'_general' if general else ''} kernel "
                                   f"launch failed: cudaError {rc}")
            _count(tail, x.dtype, "bwd", general)
            with torch.autocast("cuda", enabled=False):
                dpe, dwin, dbin, du, dcs = _finish_backward(acc_a, acc_f, dsum, acc_e,
                                                            win_f, u, bpe)
            return (dx, dtsc, dtsh, dpe, None, dwin, dbin, du, dcs, None, None,
                    None)


def _finish_backward(acc_a, acc_f, dsum, acc_e, win_f, u, bpe):
    """The six gradients but dx from the kernel's grid-wide sums (module
    docstring): products of (C, G), (B, T, G) and (B, T, D) tensors."""
    dpe = dsum @ u.t() + acc_e
    dwin = acc_a @ u.t() + acc_f
    du = win_f.t() @ acc_a + torch.einsum("btd,btg->dg", bpe, dsum)
    return dpe, dwin, dpe.sum(dim=(0, 1)), du, dsum.sum(dim=(0, 1))[None]


def _pool(x, tail, pe, pad_mask, win_f, bin_f, u, cs, seed, n_head, drop_p):
    """``ltae_pool`` (tail None) and ``ltae_pool_tail`` (tail = (tsc, tsh)):
    the plain version for a CPU tensor, the kernel pair for a CUDA tensor."""
    _check(x, pe, pad_mask, win_f, bin_f, u, cs, n_head, tail)
    dropout_threshold(drop_p)
    if x.device.type == "cpu":
        if tail is None:
            return ltae_pool_reference(x, pe, pad_mask, win_f, bin_f, u, cs, seed,
                                       n_head=n_head, drop_p=drop_p)
        return ltae_pool_tail_reference(x, *tail, pe, pad_mask, win_f, bin_f, u,
                                        cs, seed, n_head=n_head, drop_p=drop_p)
    if x.device.type != "cuda":
        raise ValueError(f"ltae_pool runs on cuda or cpu, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the ltae_pool kernels take float32 or bfloat16 x, got {x.dtype}")
    params = (pe, win_f, bin_f, u, cs) + (tail or ())
    if any(a.dtype != torch.float32 for a in params):
        raise TypeError("pe, the folded weights and the tail affine must be float32")
    if any(a.device != x.device for a in params + (pad_mask,)):
        raise ValueError("ltae_pool's tensors must all lie on x's device")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    tsc, tsh = (None, None) if tail is None else (aligned16(a.contiguous()) for a in tail)
    return _LtaePool.apply(x, tsc, tsh, pe.contiguous(), pad_mask,
                           win_f.contiguous(), bin_f.contiguous(), u.contiguous(),
                           cs.contiguous(), int(seed), n_head, float(drop_p))


def ltae_pool(x, pe, pad_mask, win_f, bin_f, u, cs, seed: int = 0, *,
              n_head: int = 16, drop_p: float = 0.0) -> torch.Tensor:
    """Masked attention pooling ``o = sum_t dropout(softmax_T(h u + cs)) h``
    with ``h = GN(x) @ win_f + bin_f + pe`` (module docstring), differentiable
    in x, pe, win_f, bin_f, u and cs.

    x: time-major rows (B, T, N, C), fp32 or bf16; pe (B, T, D) fp32;
    pad_mask (B, T) bool; win_f (C, D) with the input GroupNorm's affine
    folded in; bin_f (D,); u (D, G) with the query folded into the key
    projection; cs (1, G), all fp32; seed: int, the dropout mask's key.
    Returns o (B, N, D) in x's dtype. A CPU tensor runs
    ``ltae_pool_reference``; a CUDA tensor launches the kernels of
    ``csrc/ltae_pool.cu`` (another dtype raises)."""
    return _pool(x, None, pe, pad_mask, win_f, bin_f, u, cs, seed, n_head, drop_p)


def ltae_pool_tail(z, tsc, tsh, pe, pad_mask, win_f, bin_f, u, cs,
                   seed: int = 0, *, n_head: int = 16,
                   drop_p: float = 0.0) -> torch.Tensor:
    """``ltae_pool`` of ``max(z*tsc + tsh, 0)``, the producing conv's
    deferred GroupNorm + ReLU applied inside the kernels, differentiable in
    z, tsc, tsh, pe, win_f, bin_f, u and cs.

    z: the raw conv output as time-major rows (B, T, N, C), fp32 or bf16;
    tsc/tsh: (B, T, C) fp32, the per-frame affine, zero at pad frames (so
    their rows are exactly 0); the rest as ``ltae_pool``. Returns o (B, N, D)
    in z's dtype; dtsc and dtsh come back fp32. A CPU tensor runs
    ``ltae_pool_tail_reference``."""
    return _pool(z, (tsc, tsh), pe, pad_mask, win_f, bin_f, u, cs, seed, n_head,
                 drop_p)


ltae_pool.launches = collections.Counter()
ltae_pool.launches_fwd = 0
ltae_pool.launches_bwd = 0
