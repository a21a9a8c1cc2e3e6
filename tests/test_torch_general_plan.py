"""The general kernels' plans (csrc/ltae_pool.cu::gf_plan for the training
forward, ::gb_plan for the training backward, csrc/ltae_fused_fwd.cu::ge_plan
for the eval kernel): rows a group, the group's x resident in shared memory
or streamed in chunks, the workspace in shared memory or in a scratch buffer.

The plans are made in C, on the host, before each launch. This file mirrors
them in Python (``fwd_plan``, ``bwd_plan``, ``eval_plan``: the same layouts
and the same order of choice) so that the CPU can check them: at the L-TAE widths of
tests/test_torch_shape_routing.py (the LTAE, TimeUNet and U-TAE test models
and the two wide modules) and TimeUNet's, at T = 65, 128 and 1200, each
plan takes at least one row and its workspace fits the 227 KB a block may
use, or the plan is the scratch buffer's (one row, x streamed), taken only
where not even that fits; every one of these shapes is the general kernels'
(``kernel_route``, ``kernel_takes``). The plans at T = 128, TimeUNet's
width, are also counted by hand. The card test holds the mirrors and the
hand count against the C entries (``ltae_pool.general_fwd_plan``,
``ltae_pool.general_bwd_plan``, ``ltae_fused.general_plan``) and checks
the eval entry's refusals.
"""
import pytest
import torch

from crop2seg_tpu_torch.ops import ltae_fused as tk
from crop2seg_tpu_torch.ops import ltae_pool as lp

# (C, D, G, d_out): tests/test_torch_shape_routing.py's LTAE, TimeUNet and
# U-TAE L-TAEs, its two wide modules, and TimeUNet's factory width
WIDTHS = [(16, 32, 4, 16), (8, 32, 4, 8), (128, 32, 4, 128), (64, 64, 32, 32),
          (192, 256, 16, 192), (64, 256, 16, 64)]
STEPS = [65, 128, 1200]
DTYPES = [torch.float32, torch.bfloat16]

# the constants of the two sources
CHUNK = 32            # kGenChunk: steps of x on chip at a time
FWD_MAX_ROWS = 4      # kGfMaxRows
FWD_THREADS = 512     # kGfThreads
FWD_MAX_PARTS = 8     # kGfMaxParts
BWD_MAX_ROWS = 4      # kGbMaxRows
EVAL_MAX_ROWS = 4     # kGeMaxRows
EVAL_THREADS = 512    # kGeThreads
EVAL_MAX_PARTS = 8    # kGeMaxParts
SMEM_LIMIT = 232448   # kSmemLimit: 227 KB


def _round4(n):
    return (n + 3) & ~3


def _eb(dtype):
    return 2 if dtype == torch.bfloat16 else 4


def _fwd_parts(items):
    return max(1, min(FWD_MAX_PARTS, FWD_THREADS // max(items, 1)))


def fwd_floats(t, c, d, g, elem_bytes, rows, resident, win):
    """gf_layout in floats: the raw x of every chunk of T (``resident``) or
    of two, a chunk's xhat (row stride C | 1) and scores (heads rounded up
    to 4, then to 4 more than a multiple of 8), per (row, head) max, sum and
    rescale, P, the PE term, the split sums, the GroupNorm statistics, Ws
    (heads rounded up to 8), and with ``win`` W_in."""
    tc = min(t, CHUNK)
    nch = -(-t // tc)
    gp = _round4(g)
    slot = -(-(tc * rows * c * elem_bytes) // 16) * 4
    red = max(_fwd_parts(c) * rows * c, _fwd_parts(d) * rows * d)
    sizes = ((nch if resident else 2) * slot, rows * tc * (c | 1), rows * tc * (gp | 4),
             rows * gp, rows * gp, rows * gp, rows * gp * c, rows * d, red,
             rows * 2 * g, c * ((g + 7) & ~7), c * d if win else 0)
    return sum(_round4(n) for n in sizes)


def fwd_plan(t, c, d, g, dtype):
    """gf_plan: (rows, resident, W_in in shared memory, steps a chunk,
    floats); x resident before streamed, the most rows first, then W_in
    where it fits beside; where nothing fits, one row streamed in the
    scratch buffer."""
    eb = _eb(dtype)
    for resident in (True, False):
        for rows in range(FWD_MAX_ROWS, 0, -1):
            if 4 * fwd_floats(t, c, d, g, eb, rows, resident, False) > SMEM_LIMIT:
                continue
            win = 4 * fwd_floats(t, c, d, g, eb, rows, resident, True) <= SMEM_LIMIT
            return (rows, resident, win, min(t, CHUNK),
                    fwd_floats(t, c, d, g, eb, rows, resident, win))
    return 1, False, False, min(t, CHUNK), fwd_floats(t, c, d, g, eb, 1, False, False)


def bwd_floats(t, c, d, g, elem_bytes, rows, resident):
    """gb_layout in floats: the raw x of every chunk of T (``resident``) or
    of two, a chunk's xhat, per row and step ds and a_d, Z, Ws, P or each
    row's A, go (a pad float a head), the saved statistics, tot, the sums
    over t of ds and a_d, and the group means."""
    tc = min(t, CHUNK)
    nch = -(-t // tc)
    gp = _round4(g)
    zp, cp = gp + 4, c | 1
    slot = -(-(tc * rows * c * elem_bytes) // 16) * 4
    sizes = ((nch if resident else 2) * slot, rows * tc * cp, rows * t * gp,
             rows * t * gp, rows * c * zp, c * zp, rows * c * gp, rows * g * (d // g + 1),
             rows * 4 * g, rows * gp, rows * 2 * gp, rows * 2 * g)
    return sum(_round4(n) for n in sizes)


def bwd_plan(t, c, d, g, dtype):
    """gb_plan: (rows, resident, steps a chunk, floats); x resident before
    streamed, the most rows first; where nothing fits, one row streamed in
    the scratch buffer."""
    eb = _eb(dtype)
    for resident in (True, False):
        for rows in range(BWD_MAX_ROWS, 0, -1):
            f = bwd_floats(t, c, d, g, eb, rows, resident)
            if 4 * f <= SMEM_LIMIT:
                return rows, resident, min(t, CHUNK), f
    return 1, False, min(t, CHUNK), bwd_floats(t, c, d, g, eb, 1, False)


def _parts(items):
    return max(1, min(EVAL_MAX_PARTS, EVAL_THREADS // max(items, 1)))


def eval_floats(t, c, d, g, d_out, nq, elem_bytes, rows, resident, scores, win, wm):
    """ge_layout in floats: the raw x of every chunk of T (``resident``) or
    of two, a chunk's normalized x and scores, with ``scores`` every score
    of the group, per (row, column) max, sum and rescale, P, per (row,
    query) the PE term, o and m, the split sums, the GroupNorm statistics,
    Ws, and with ``win`` / ``wm`` W_in and W_m."""
    gq = g * nq
    tc = min(t, CHUNK)
    nch = -(-t // tc)
    gp = _round4(gq)
    slot = -(-(tc * rows * c * elem_bytes) // 16) * 4
    red = max(_parts(c) * rows * c, _parts(nq * d) * rows * nq * d,
              _parts(nq * d_out) * rows * nq * d_out)
    sizes = ((nch if resident else 2) * slot, rows * tc * (c | 1), rows * tc * (gp | 4),
             rows * gq * t if scores else 0, rows * gp, rows * gp, rows * gp,
             rows * gq * c, rows * nq * d, rows * nq * d, rows * nq * d_out, red,
             rows * 2 * g, rows * 2 * g, c * (gp + 4), c * d if win else 0,
             d * d_out if wm else 0)
    return sum(_round4(n) for n in sizes)


def eval_plan(t, c, d, g, d_out, nq, dtype, need_attn):
    """ge_plan: (rows, resident, scores on chip, W_in, W_m in shared memory,
    floats); x resident before streamed, with the attention out the scores
    on chip before raw ones, the most rows first, then W_in and W_m where
    they fit beside; where nothing fits, one row streamed in the scratch
    buffer."""
    eb = _eb(dtype)

    def floats(*k):
        return eval_floats(t, c, d, g, d_out, nq, eb, *k)
    for resident in (True, False):
        for scores in ((True, False) if need_attn else (False,)):
            for rows in range(EVAL_MAX_ROWS, 0, -1):
                if 4 * floats(rows, resident, scores, False, False) > SMEM_LIMIT:
                    continue
                win = 4 * floats(rows, resident, scores, True, False) <= SMEM_LIMIT
                wm = 4 * floats(rows, resident, scores, win, True) <= SMEM_LIMIT
                return (rows, resident, scores, win, wm,
                        floats(rows, resident, scores, win, wm))
    return 1, False, False, False, False, floats(1, False, False, False, False)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("t", STEPS)
@pytest.mark.parametrize("c,d,g,d_out", WIDTHS)
def test_general_fwd_plan_fits_or_takes_the_scratch_buffer(c, d, g, d_out, t, dtype):
    rows, resident, win, tc, floats = fwd_plan(t, c, d, g, dtype)
    assert not lp.kernel_takes(t, c, d, g)          # the general pair's shape
    assert 1 <= rows <= FWD_MAX_ROWS and 1 <= tc <= min(t, CHUNK)
    if 4 * floats > SMEM_LIMIT:                      # the scratch buffer
        assert (rows, resident, win) == (1, False, False)
        assert 4 * fwd_floats(t, c, d, g, _eb(dtype), 1, False, False) > SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("t", STEPS)
@pytest.mark.parametrize("c,d,g,d_out", WIDTHS)
def test_general_bwd_plan_fits_or_takes_the_scratch_buffer(c, d, g, d_out, t, dtype):
    rows, resident, tc, floats = bwd_plan(t, c, d, g, dtype)
    assert not lp.kernel_takes(t, c, d, g)          # the general pair's shape
    assert 1 <= rows <= BWD_MAX_ROWS and 1 <= tc <= min(t, CHUNK)
    if 4 * floats > SMEM_LIMIT:                      # the scratch buffer
        assert (rows, resident) == (1, False)
        assert 4 * bwd_floats(t, c, d, g, _eb(dtype), 1, False) > SMEM_LIMIT


@pytest.mark.parametrize("need_attn", [False, True], ids=["no-attn", "attn"])
@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("t", STEPS)
@pytest.mark.parametrize("c,d,g,d_out", WIDTHS)
def test_general_eval_plan_fits_or_takes_the_scratch_buffer(c, d, g, d_out, t, dtype, nq,
                                                            need_attn):
    rows, resident, scores, win, wm, floats = eval_plan(t, c, d, g, d_out, nq, dtype,
                                                        need_attn)
    assert tk.kernel_route(t, c, d, g, d_out, nq) == "general"
    assert 1 <= rows <= EVAL_MAX_ROWS and (need_attn or not scores)
    if 4 * floats > SMEM_LIMIT:                      # the scratch buffer
        assert (rows, resident, scores, win, wm) == (1, False, False, False, False)
        assert 4 * eval_floats(t, c, d, g, d_out, nq, _eb(dtype), 1, False, False, False,
                               False) > SMEM_LIMIT


# T = 128 at TimeUNet's width (C = 64, D = 256, G = 16, d_out = 64), counted
# by hand from the layouts: the forward holds 4 rows with x resident either
# way (bf16: raw 4 x 4096, xh 4 * 32 * 65, e 4 * 32 * 20, max, sum and
# rescale 3 * 64, P 4 * 16 * 64, the PE term 4 * 256, the split sums 2048,
# the statistics 128, Ws 64 * 16 and W_in 64 * 256 floats; fp32: raw 4 x
# 8192 and W_in from L2, the same total); the backward in bf16 holds 4 rows with x
# resident (raw 4 x 4096, xh 4 * 32 * 65, ds and ad 4 * 128 * 16 each, Z 4 *
# 64 * 20, Ws 64 * 20, P 4096, go 4 * 16 * 17, the statistics 256, tot 64,
# the sums of ds and a_d 128, gm 128 floats), in fp32 3 rows; the eval
# kernel 4 rows either way, x resident, with W_in in shared memory in bf16.
HAND_BWD = {torch.bfloat16: (4, 1, 32, 16384 + 8320 + 2 * 8192 + 5120 + 1280 + 4096
                             + 1088 + 256 + 64 + 128 + 128),
            torch.float32: (3, 1, 32)}
HAND_EVAL = {torch.bfloat16: (4, 1, 0, 1, 0), torch.float32: (4, 1, 0, 0, 0)}
HAND_FWD = {torch.bfloat16: (4, 1, 1, 32, 16384 + 8320 + 2560 + 192 + 4096 + 1024 + 2048
                             + 128 + 1024 + 16384),
            torch.float32: (4, 1, 0, 32, 32768 + 8320 + 2560 + 192 + 4096 + 1024 + 2048
                            + 128 + 1024)}


def test_plans_at_timeunet_width_by_hand():
    assert HAND_BWD[torch.bfloat16][3] == 53248
    assert HAND_FWD[torch.bfloat16][4] == HAND_FWD[torch.float32][4] == 52160
    for dtype in DTYPES:
        assert fwd_plan(128, 64, 256, 16, dtype) == HAND_FWD[dtype]
        assert bwd_plan(128, 64, 256, 16, dtype)[:len(HAND_BWD[dtype])] == HAND_BWD[dtype]
        assert eval_plan(128, 64, 256, 16, 64, 1, dtype, False)[:5] == HAND_EVAL[dtype]


@pytest.mark.cuda
def test_cuda_plans_match_the_c_entries():
    """On the card, the C entries give the hand count at T = 128 and each
    mirror's plan for every width, T and dtype above (and the eval kernel's
    for nq = 1, 3 and the attention on and off), and the eval C entry
    refuses every row-group route at these shapes, as ``kernel_route`` does
    not pick them, before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the plans' C entries are built with nvcc")
    for dtype in DTYPES:
        assert lp.general_fwd_plan(128, 64, 256, 16, dtype) == HAND_FWD[dtype]
        assert lp.general_bwd_plan(128, 64, 256, 16, dtype)[:len(HAND_BWD[dtype])] == \
            HAND_BWD[dtype]
        assert tk.general_plan(128, 64, 256, 16, 64, 1, dtype, False)[:5] == HAND_EVAL[dtype]
    fn = tk._kernel()[0]
    dev = torch.device("cuda")
    big = torch.zeros(1 << 16, device=dev)
    for c, d, g, d_out in WIDTHS:
        for t in STEPS:
            for dtype in DTYPES:
                assert lp.general_fwd_plan(t, c, d, g, dtype) == tuple(
                    int(v) for v in fwd_plan(t, c, d, g, dtype))
                assert lp.general_bwd_plan(t, c, d, g, dtype) == tuple(
                    int(v) for v in bwd_plan(t, c, d, g, dtype))
                for nq in (1, 3):
                    for attn in (False, True):
                        assert tk.general_plan(t, c, d, g, d_out, nq, dtype, attn) == tuple(
                            int(v) for v in eval_plan(t, c, d, g, d_out, nq, dtype, attn))
            for route in (0, 1, 2):   # group, wide, queries
                rc = fn(big.data_ptr(), 0, *[big.data_ptr()] * 11, None, None, 1, t, 1, c,
                        d, g, d_out, 1, route, 1, None, 1e-5,
                        torch.cuda.current_stream().cuda_stream)
                assert rc != 0
