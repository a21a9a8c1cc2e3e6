"""Split the time of a row-group kernel into its steps, on one card: the
fused eval L-TAE kernel's (crop2seg_tpu_torch/csrc/ltae_fused_fwd.cu::
ltae_fused_group_kernel, C <= 64 with one query), with --kernel wide its
wide sibling's (ltae_fused_wide_kernel, 64 < C <= 128 with one query),
with --kernel pool_fwd the training forward's (csrc/ltae_pool.cu::
ltae_pool_fwd_group_kernel, all four variants) or, with --kernel
pool_bwd_general, the general training backward's by pass
(ltae_pool_bwd_general_kernel, tail mode, groups of rows; cycles are given
per row), or with --kernel general the general eval kernel's
(ltae_fused_general_kernel at T = 128, B = 4, TimeUNet's width; per row).

    python3 scripts/split_ltae_fused_steps.py
        [--kernel fused|wide|general|pool_fwd|pool_bwd_general]
        [--launches 5]

Copies this checkout's crop2seg_tpu_torch into the gitignored
_archive/steps/, adds clock64() stamps to the copy's kernel at each step
boundary (thread 0 of every block, summed over the block's row groups, one
atomicAdd per block into a __device__ array read back through an extra C
entry), builds it there and runs it: the fused kernel at the TimeUNet
main-path shape of scripts/bench_ltae_fused_torch.py (B=10, T=61,
N=128*128, C=64, D=256, G=16, d_out=64, tail affine, no attention), the
wide kernel at its U-TAE shape (--width utae: N=16*16, C=d_out=128,
attention out), the training forward at that of
scripts/bench_ltae_pool_torch.py (B=4, T=61, N=128*128, C=64, D=256, G=16,
drop_p 0.1), the general backward at chip_smoke.py's timing shape for it
(B=4, T=128, N=128*128, C=64, D=256, G=16, tail mode, drop_p 0.1; a launch
is the whole backward under autograd). Prints the card (nvidia-smi name and
power limit), then per dtype (and mode) one JSON line: the instrumented
launch's ms (CUDA events; the stamps cost a few per cent) and each step's
cycles per row group (8 rows, 4 for the wide kernel; per row for the
general backward, whose groups hold its plan's rows) with its share. The stamps never reach the package itself.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "_archive" / "steps"
WAIT = "    cp_async_wait_all();\n    __syncthreads();\n\n    // 1. tail affine"

# Per kernel: its source, the text that opens its body and the text after
# it, its rows per group, its steps, and the (anchor, text put before it)
# pairs; a stamp closes the step that ends there. Anchors are the kernel's
# step comments and barriers; the end of the row-group loop closes the last
# step.
FUSED_STEPS = dict(
    lib="ltae_fused_fwd", rows=8,
    steps=("wait for x", "GroupNorm", "scores + softmax", "P", "projection + PE",
           "MLP", "out GroupNorm"),
    stamps=((WAIT, "    STEP_T0 = clock64();\n"),
            ("\n    // 1. tail affine", "    STAMP(0)\n"),
            ("    // 2. scores", "    STAMP(1)\n"),
            ("    // 3. P = a @ xn", "    STAMP(2)\n"),
            ("    // 4. o[d] = b_in[d]", "    STAMP(3)\n"),
            ("    // 5. m = relu", "    STAMP(4)\n"),
            ("    // 6. out GroupNorm", "    STAMP(5)\n")))
KERNELS = {
    "fused": dict(FUSED_STEPS, head="ltae_fused_group_kernel(const Args a) {",
                  after="cudaError_t launch_group("),
    "wide": dict(FUSED_STEPS, rows=4, head="ltae_fused_wide_kernel(const Args a) {",
                 after="cudaError_t launch_wide("),
    "pool_fwd": dict(
        lib="ltae_pool", rows=8, head="ltae_pool_fwd_group_kernel(const Args a) {",
        after="// ---- backward",
        steps=("wait for x", "GroupNorm", "scores + softmax + dropout", "P",
               "projection + PE + store"),
        stamps=((WAIT, "    STEP_T0 = clock64();\n"),
                ("\n    // 1. tail affine", "    STAMP(0)\n"),
                ("    // 2. scores", "    STAMP(1)\n"),
                ("    // 3. P = a_d @ xhat", "    STAMP(2)\n"),
                ("    // 4. o[d] = P[g(d)]", "    STAMP(3)\n"))),
    "pool_bwd_general": dict(
        lib="ltae_pool", rows=1,
        head="ltae_pool_bwd_general_kernel(const Args a, const GbLayout L, const float* const st,",
        after="template <bool Tail, typename Tin>\ncudaError_t launch_general_fwd",
        decl_after="  for (int k = 0; k < kGbFRegs; ++k) freg[k] = 0.f;\n",
        end="    __syncthreads();   // the group's buffers are free",
        steps=("group start: statistics, go", "Z", "p1's PE term", "pass 1: wait, xhat",
               "pass 1: scores, a, a_d, p1", "pass 1: P", "ds",
               "rows' sums of ds and a_d", "F", "E", "Dsum", "pass 2: wait, xhat",
               "pass 2: each row's A", "group means, A", "pass 3: dx"),
        stamps=(("    // ---- the group's statistics, go, Z", "    STEP_T0 = clock64();\n"),
                ("    // Z[r][c, g] = sum_{d in g} W[c, d] go_r[d]", "    STAMP(0)\n"),
                ("    // ds[r][t, g] = sum_{d in g} go_r[d] bpe[t, d]", "    STAMP(1)\n"),
                ("    // 1. a, a_d and p1 of every step", "    STAMP(2)\n"),
                ("      // thread (r, t, four heads): s = xhat Ws", "      STAMP(3)\n"),
                ("      // thread (r, four heads, c): P[r][g, c]", "      STAMP(4)\n"),
                ("    }\n\n    // 2. ds = a_d p1", "      STAMP(5)\n"),
                ("    // per row sum_t ds and sum_t a_d", "    STAMP(6)\n"),
                ("    // 3. the group's share of F", "    STAMP(7)\n"),
                ("    const int npe = max(1, kGbThreads / D);", "    STAMP(8)\n"),
                ("    // Dsum[t, g] += sum_r ds_r[t, g]", "    STAMP(9)\n"),
                ("    // 4. each row's A_r = xhat^T ds", "    STAMP(10)\n"),
                ("      for (int i = tid; i < rows * G4 * C; i += kGbThreads) {\n"
                 "        const int c = i % C, k = i / C, gq = k % G4, r = k / G4;\n"
                 "        const float* xc = xh + r * TC * CP + c;\n"
                 "        const float* dr", "      STAMP(11)\n"),
                ("    }\n    __syncthreads();\n    for (int i = tid; i < rows * G; i += kGbThreads) {"
                 "   // the group means", "      STAMP(12)\n"),
                ("    // 5. dx = inv", "    STAMP(13)\n"))),
    "general": dict(
        lib="ltae_fused_fwd", rows=1,
        head="ltae_fused_general_kernel(const Args a, const GeLayout L, float* const scratch) {",
        after="template <typename Tin>\ncudaError_t launch_general(",
        decl_after="  const float* const wm = L.wm_on ? w + L.wm : a.wm;\n",
        end="    __syncthreads();   // the group's buffers are free",
        steps=("GroupNorm statistics (two passes)", "chunk: wait, normalized x",
               "chunk: scores", "chunk: online softmax", "chunk: P, PE term",
               "o", "MLP", "out GroupNorm, store, attention"),
        stamps=(("    float* attn_g = a.attn != nullptr", "    STEP_T0 = clock64();\n"),
                ("    for (int i = tid; i < rows * GP; i += kGeThreads) {\n      mx[i]",
                 "    STAMP(0)\n"),
                ("      // thread (r, t, four columns); column", "      STAMP(1)\n"),
                ("      // warp (r, column), lane t: the chunk's max", "      STAMP(2)\n"),
                ("      // thread (r, four columns, c): P[r][col, c]", "      STAMP(3)\n"),
                ("    }\n    __syncthreads();\n\n    // 3. o[r][q, d]", "      STAMP(4)\n"),
                ("    // 4. m[r][q] = relu", "    STAMP(5)\n"),
                ("    // 5. out GroupNorm: head g", "    STAMP(6)\n"))),
}
ROW_GROUP_START = "  if (n0 >= n1) return;   // the whole block: no barrier is reached\n"


def instrument(src: str, spec: dict) -> str:
    head = src.index(spec["head"])
    body_end = src.index(spec["after"])
    kernel = src[head:body_end]
    nsteps = len(spec["steps"])
    start = spec.get("decl_after", ROW_GROUP_START)
    if start not in kernel:
        raise RuntimeError(f"anchor not found in {spec['head']}: {start!r}")
    kernel = kernel.replace(
        start, start +
        "  long long step_acc[16] = {};\n"
        "  long long STEP_T0 = 0, step_t1 = 0;\n"
        "#define STAMP(i) step_t1 = clock64(); step_acc[i] += step_t1 - STEP_T0; "
        "STEP_T0 = step_t1;\n", 1)
    for anchor, text in spec["stamps"]:
        if anchor not in kernel:
            raise RuntimeError(f"anchor not found in {spec['head']}: {anchor!r}")
        kernel = kernel.replace(anchor, text + anchor, 1)
    # the loop's end (or the spec's `end` anchor) closes the last step; the
    # kernel's end adds the sums
    last = f"    STAMP({nsteps - 1})\n"
    if "end" in spec:
        kernel = kernel.replace(spec["end"], last + spec["end"], 1)
        last = ""
    tail = kernel.rindex("  }\n}\n")
    kernel = (kernel[:tail] + last + "  }\n"
              "  if (threadIdx.x == 0) {\n"
              f"    for (int i = 0; i < {nsteps}; ++i)\n"
              "      atomicAdd(&g_steps[i], (unsigned long long)step_acc[i]);\n"
              f"    atomicAdd(&g_steps[15], (unsigned long long)((n1 - n0 + {spec['rows'] - 1}) / {spec['rows']}));\n"
              "  }\n}\n" + kernel[tail + len("  }\n}\n"):])
    src = src[:head] + kernel + src[body_end:]
    src = src.replace("namespace {\n", "__device__ unsigned long long g_steps[16];\n\n"
                      "namespace {\n", 1)
    return src + """
extern "C" int ltae_steps_read(unsigned long long* host) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(host, g_steps, sizeof(g_steps));
  unsigned long long z[16] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_steps, z, sizeof(z));
  return (int)e;
}
"""


def _bench(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fused_launches(dev, width: str, t: int = 61, b: int = 10):
    """(label, launch) per dtype of the fused kernel at TimeUNet's or
    U-TAE's width, as scripts/bench_ltae_fused_torch.py runs it (at T = t,
    B = b)."""
    from crop2seg_tpu_torch.ops import ltae_fused as lf
    bench = _bench("bench_ltae_fused_torch")
    w = bench.WIDTHS[width]
    x, pe, pad, params, tail = bench.inputs(w, 1, dev, t, b)
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        yield str(dtype)[6:], lambda xd=xd: lf.ltae_fused_forward(
            xd, pe, pad, params, n_head=bench.G, d_k=bench.D_K, need_attn=w["attn"],
            tail_affine=tail)


def pool_fwd_launches(dev):
    """(label, launch) per variant of the training forward."""
    from crop2seg_tpu_torch.ops import ltae_pool as lp
    bench = _bench("bench_ltae_pool_torch")
    x, ts, pe, pad, params, _ = bench.inputs(dev)
    for tail in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)

            def launch(xd=xd, tail=tail):
                with torch.no_grad():
                    if tail:
                        return lp.ltae_pool_tail(xd, *ts, pe, pad, *params, 99,
                                                 n_head=bench.G, drop_p=bench.DROP_P)
                    return lp.ltae_pool(xd, pe, pad, *params, 99, n_head=bench.G,
                                        drop_p=bench.DROP_P)
            yield lp.variant(tail, dtype, "fwd"), launch


def pool_bwd_general_launches(dev):
    """(label, launch) per dtype of the general backward in tail mode at
    T = 128, on chip_smoke.py's inputs (the seeded TimeUNet's folded L-TAE)."""
    from crop2seg_tpu_torch.models.factory import get_model
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    model = get_model({"model": "timeunet"}, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(15)
    x, ts, pe, pad, params = cs.pool_inputs(model, cs.TRAIN_B, gen, dev, t=cs.T_GENERAL)
    go = torch.randn(cs.TRAIN_B, cs.HW, cs.D, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        leaves = cs.pool_leaves(True, x.to(dtype), ts, pe, params)
        o = cs.pool_apply(True, False, leaves, pad, 99, 0.1)
        god = go.to(o.dtype)
        yield (f"ltae_pool_tail_bwd{'_bf16' if dtype == torch.bfloat16 else ''}_general",
               lambda o=o, leaves=leaves, god=god: torch.autograd.grad(
                   o, leaves, god, retain_graph=True))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="fused")
    ap.add_argument("--launches", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0])
    spec = KERNELS[args.kernel]
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "crop2seg_tpu_torch", COPY / "crop2seg_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = COPY / "crop2seg_tpu_torch" / "csrc" / f"{spec['lib']}.cu"
    cu.write_text(instrument(cu.read_text(), spec))
    sys.path.insert(0, str(COPY))
    from crop2seg_tpu_torch.ops import _build
    assert Path(_build.__file__).is_relative_to(COPY), _build.__file__

    dev = torch.device("cuda")
    read = _build.load_library(spec["lib"]).ltae_steps_read
    read.argtypes = [ctypes.c_void_p]
    sums = (ctypes.c_ulonglong * 16)()
    nsteps = len(spec["steps"])
    runs = (pool_fwd_launches(dev) if args.kernel == "pool_fwd" else
            pool_bwd_general_launches(dev) if args.kernel == "pool_bwd_general" else
            fused_launches(dev, "timeunet", 128, 4) if args.kernel == "general" else
            fused_launches(dev, "utae" if args.kernel == "wide" else "timeunet"))
    for label, launch in runs:
        for _ in range(2):
            launch()
        if read(sums) != 0:
            raise RuntimeError("reading the step sums failed")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.launches):
            launch()
        end.record()
        torch.cuda.synchronize()
        if read(sums) != 0:
            raise RuntimeError("reading the step sums failed")
        cycles, groups = list(sums[:nsteps]), sums[15]
        total = sum(cycles)
        print(json.dumps({
            "kernel": args.kernel, "run": label,
            "ms_instrumented": start.elapsed_time(end) / args.launches,
            "groups": groups, "cycles_per_group": total / groups,
            "steps": {name: {"cycles_per_group": c / groups, "share": c / total}
                      for name, c in zip(spec["steps"], cycles)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
