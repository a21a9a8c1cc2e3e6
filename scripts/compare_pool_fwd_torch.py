"""Compare this checkout's training forward kernel (crop2seg_tpu_torch/csrc/
ltae_pool.cu, the C entry ltae_pool_fwd) with another checkout's, on one card.

    python3 scripts/compare_pool_fwd_torch.py --other <checkout> [--grad-check]

Builds the other checkout's csrc/ltae_pool.cu into the gitignored
_archive/compare_pool/, then, on chip_smoke.py's full-width pool inputs (the
seeded TimeUNet's folded L-TAE parameters and PE, T=61, N=128*128, C=64,
B=2 and B=4, sample 1 padded to 55, the tail affine zeroed there), runs both
forwards in all four variants (untailed or tail mode, x fp32 or bf16) at
drop_p 0 and 0.1 and prints whether o agrees bit for bit; in fp32 at B=2
also each kernel's and the fp32 plain version's error against the plain
version in fp64 (max, rms, mean). With --grad-check it then runs chip_smoke.py's
phase_train (the train runs and the B=2 whole-model gradient check) with
this checkout's forward and again with the other's in its place (this
checkout's backward either way) and prints each check's line; a failed check
is printed, not raised. Prints the card (nvidia-smi name and power limit)
first.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from crop2seg_tpu_torch.models.factory import get_model  # noqa: E402
from crop2seg_tpu_torch.ops import _build  # noqa: E402
from crop2seg_tpu_torch.ops import ltae_pool as lp  # noqa: E402

OUT = ROOT / "_archive" / "compare_pool"


def other_forward(checkout: Path):
    """The other checkout's ltae_pool_fwd, called with this checkout's
    arguments (a C entry that takes no S gets them without it)."""
    src = checkout / "crop2seg_tpu_torch" / "csrc" / "ltae_pool.cu"
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "ltae_pool_other.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).ltae_pool_fwd
    takes_s = "void* o, int S," in src.read_text()
    vp, ci, cf, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    fn.argtypes = [vp, ci] + [vp] * 7 + [ci] * (7 if takes_s else 6) + [cu, cu, cf, cf, vp]
    fn.restype = ci

    def call(*args):   # this checkout's order: ..., o, S, B, T, N, C, D, G, ...
        return fn(*args) if takes_s else fn(*args[:9], *args[10:])
    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--grad-check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0])
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    mine = lp._kernels()
    other = other_forward(args.other.resolve())

    def use(fwd):
        lp._kernels = lambda: (fwd, *mine[1:])

    model = get_model({"model": "timeunet"}, generator=torch.Generator().manual_seed(0))
    for b in (2, 4):
        gen = torch.Generator(device=dev).manual_seed(3)
        x, ts, pe, pad, params = cs.pool_inputs(model, b, gen, dev)
        for (tail, dtype), p in ((v, p) for v in cs.VARIANTS for p in (0.0, 0.1)):
            xd = x.to(dtype)
            with torch.no_grad():
                outs = []
                for fwd in (mine[0], other):
                    use(fwd)
                    outs.append(cs.pool_apply(tail, False, [xd, *ts, pe, *params]
                                              if tail else [xd, pe, *params], pad, 1234, p))
                use(mine[0])
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                same = torch.equal(outs[0].view(bits), outs[1].view(bits))
                line = (f"B={b} {lp.variant(tail, dtype, 'fwd')} drop_p={p}: this vs other "
                        + ("bit for bit" if same else
                           f"differ, max {(outs[0].float() - outs[1].float()).abs().max():.3e}"))
                if dtype == torch.float32 and b == 2:
                    want = cs.pool_apply(tail, True, [a.double() for a in (
                        [x, *ts, pe, *params] if tail else [x, pe, *params])], pad, 1234, p)
                    plain = cs.pool_apply(tail, True, [x, *ts, pe, *params] if tail
                                          else [x, pe, *params], pad, 1234, p)
                    for name, o in (("this", outs[0]), ("other", outs[1]), ("plain fp32", plain)):
                        e = o.double() - want
                        line += (f"; {name} vs fp64: max {e.abs().max():.3e} rms "
                                 f"{e.pow(2).mean().sqrt():.3e} mean {e.mean():.3e}")
                print(line, flush=True)
            del xd, outs
        del x, ts, pe, pad, params
        torch.cuda.empty_cache()
    del model
    if args.grad_check:
        for label, fwd in (("this checkout's forward", mine[0]), ("the other's forward", other)):
            print(f"phase_train with {label}:", flush=True)
            use(fwd)
            try:
                cs.phase_train(dev)
            except RuntimeError as err:
                print(f"  {err}", flush=True)
            torch.cuda.empty_cache()
        use(mine[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
