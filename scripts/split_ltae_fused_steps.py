"""Split the time of the fused eval L-TAE kernel's row-group kernel
(crop2seg_tpu_torch/csrc/ltae_fused_fwd.cu::ltae_fused_group_kernel, C <= 64
with one query) into its steps, on one card.

    python3 scripts/split_ltae_fused_steps.py [--launches 5]

Copies this checkout's crop2seg_tpu_torch into the gitignored
_archive/steps/, adds clock64() stamps to the copy's group kernel at each
step boundary (thread 0 of every block, summed over the block's row groups,
one atomicAdd per block into a __device__ array read back through an extra
C entry), builds it there and runs it at the TimeUNet main-path shape of
scripts/bench_ltae_fused_torch.py (B=10, T=61, N=128*128, C=64, D=256, G=16,
d_out=64, tail affine, no attention). Prints the card (nvidia-smi name and
power limit), then per dtype one JSON line: the instrumented launch's ms
(CUDA events; the stamps cost a few per cent) and each step's cycles per
8-row group with its share. The stamps never reach the package itself.
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
STEPS = ("wait for x", "GroupNorm", "scores + softmax", "P", "projection + PE",
         "MLP", "out GroupNorm")
GROUP_ROWS = 8

# (anchor in the group kernel, text put before it); a stamp closes the step
# that ends there. Anchors are the kernel's step comments and barriers.
STAMPS = (
    ("    cp_async_wait_all();\n    __syncthreads();\n\n    // 1. tail affine",
     "    STEP_T0 = clock64();\n"),
    ("\n    // 1. tail affine", "    STAMP(0)\n"),
    ("    // 2. scores", "    STAMP(1)\n"),
    ("    // 3. P = a @ xn", "    STAMP(2)\n"),
    ("    // 4. o[d] = b_in[d]", "    STAMP(3)\n"),
    ("    // 5. m = relu", "    STAMP(4)\n"),
    ("    // 6. out GroupNorm", "    STAMP(5)\n"),
)


def instrument(src: str) -> str:
    head = src.index("ltae_fused_group_kernel(const Args a) {")
    body_end = src.index("cudaError_t launch_group(")
    kernel = src[head:body_end]
    kernel = kernel.replace(
        "  if (n0 >= n1) return;   // the whole block: no barrier is reached\n",
        "  if (n0 >= n1) return;   // the whole block: no barrier is reached\n"
        "  long long step_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
        "  long long STEP_T0 = 0, step_t1 = 0;\n"
        "#define STAMP(i) step_t1 = clock64(); step_acc[i] += step_t1 - STEP_T0; "
        "STEP_T0 = step_t1;\n", 1)
    for anchor, text in STAMPS:
        if anchor not in kernel:
            raise RuntimeError(f"anchor not found in the group kernel: {anchor!r}")
        kernel = kernel.replace(anchor, text + anchor, 1)
    # the loop's end closes the out GroupNorm; the kernel's end adds the sums
    tail = kernel.rindex("  }\n}\n")
    kernel = (kernel[:tail] + "    STAMP(6)\n  }\n"
              "  if (threadIdx.x == 0) {\n"
              "    for (int i = 0; i < 7; ++i)\n"
              "      atomicAdd(&g_steps[i], (unsigned long long)step_acc[i]);\n"
              "    atomicAdd(&g_steps[7], (unsigned long long)((n1 - n0 + 7) / 8));\n"
              "  }\n}\n" + kernel[tail + len("  }\n}\n"):])
    src = src[:head] + kernel + src[body_end:]
    src = src.replace("namespace {\n", "__device__ unsigned long long g_steps[8];\n\n"
                      "namespace {\n", 1)
    return src + """
extern "C" int ltae_steps_read(unsigned long long* host) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(host, g_steps, sizeof(g_steps));
  unsigned long long z[8] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_steps, z, sizeof(z));
  return (int)e;
}
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launches", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0])
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "crop2seg_tpu_torch", COPY / "crop2seg_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = COPY / "crop2seg_tpu_torch" / "csrc" / "ltae_fused_fwd.cu"
    cu.write_text(instrument(cu.read_text()))
    sys.path.insert(0, str(COPY))
    from crop2seg_tpu_torch.ops import _build
    from crop2seg_tpu_torch.ops import ltae_fused as lf
    assert Path(lf.__file__).is_relative_to(COPY), lf.__file__
    spec = importlib.util.spec_from_file_location(
        "bench", ROOT / "scripts" / "bench_ltae_fused_torch.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    dev = torch.device("cuda")
    width = bench.WIDTHS["timeunet"]
    x, pe, pad, params, tail = bench.inputs(width, 1, dev)
    read = _build.load_library("ltae_fused_fwd").ltae_steps_read
    read.argtypes = [ctypes.c_void_p]
    sums = (ctypes.c_ulonglong * 8)()
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)

        def launch():
            lf.ltae_fused_forward(xd, pe, pad, params, n_head=bench.G, d_k=bench.D_K,
                                  need_attn=False, tail_affine=tail)
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
        cycles, groups = list(sums[:7]), sums[7]
        total = sum(cycles)
        print(json.dumps({
            "dtype": str(dtype)[6:], "ms_instrumented": start.elapsed_time(end) / args.launches,
            "groups": groups, "cycles_per_group": total / groups,
            "steps": {name: {"cycles_per_group": c / groups, "share": c / total}
                      for name, c in zip(STEPS, cycles)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
