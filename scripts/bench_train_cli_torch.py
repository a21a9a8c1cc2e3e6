"""The train CLI's epoch on one card: epoch seconds, steps/s, and where an
epoch's time goes.

    python3 scripts/bench_train_cli_torch.py [--patches 176] [--epochs 3]
        [--batch 4] [--model timeunet|utae] [--fp32] [--data DIR]
        [--device cuda|cpu] [--narrow]

Writes a synthetic S2TSCzCrop dataset of ``--patches`` patches at 128^2,
T 27-61 (split 70/15/15: 176 patches give 123 train patches, 30 steps an
epoch at B = 4) into ``--data`` (a temporary directory by default), builds
the CUDA sources the path runs (timed apart: otherwise the first step pays
for it), then:

1. the host's loaders alone, no card: ``BatchLoader`` (read, reorder,
   standardize, pad to the T bucket) ms a batch by T bucket, and an epoch
   of ``PrefetchLoader`` (the CLI's train loader) with nothing consuming
   it but the loop; on the native C++ loader (the CLI's default) and on
   the Python collate path;
2. ``python -m crop2seg_tpu_torch.train``'s ``main`` in process from disk,
   ``--epochs`` epochs at the model's factory defaults, bf16 unless
   ``--fp32``: each epoch's seconds (trainlog.json's ``train_epoch_time``,
   the CLI's own clock, which starts before the first batch is read) and
   steps/s;
3. the same with ``--device_cache`` (epoch 1 uploads, later epochs gather
   their batches on the card);
4. one epoch from disk under torch.profiler (a fresh run with
   ``--profile``; cuDNN's first-use costs were paid in 2): the device's
   busy share (kernels, copies and sets merged, over the epoch's time),
   the kernels' and the host-to-device copies' device ms a step, and the
   time from the epoch's start to its first kernel (the first batch's
   read, which no prefetch hides).

Prints the card's name and power limit first and one JSON line last (the
profiler trace stays in the temporary directory). ``--device cpu --narrow`` runs the same
on the CPU at narrow widths and 16^2 patches (a check of the script).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crop2seg_tpu_torch import train as cli  # noqa: E402
from crop2seg_tpu_torch.data import (  # noqa: E402
    BatchLoader, PrefetchLoader, make_synthetic_dataset)

NARROW = ["--encoder_widths", "[8,8]", "--decoder_widths", "[8,8]",
          "--out_conv", "[8,15]", "--n_head", "2", "--d_model", "16"]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def loaders_alone(config, batch: int) -> dict:
    """Phase 1: the host's BatchLoader ms a batch by T bucket, and one
    PrefetchLoader epoch's seconds, with no step: on the native C++ loader
    (the CLI's default) and on the Python collate path (``native=False``),
    under the keys "native" and "python"."""
    dt_train = cli.build_datasets(config)[0]
    out = {}
    for name, native in (("native", True), ("python", False)):
        kw = dict(t_buckets=tuple(config.t_buckets), pad_value=config.pad_value,
                  native=native)
        by_t: dict = {}
        loader = BatchLoader(dt_train, batch, shuffle=True, drop_last=True, seed=1, **kw)
        if native and loader._plan is None:
            raise SystemExit("the train BatchLoader holds no native plan")
        it = iter(loader)
        while True:
            start = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                break
            by_t.setdefault(int(b["x"].shape[1]), []).append(
                (time.perf_counter() - start) * 1e3)
        start = time.perf_counter()
        n = sum(1 for _ in PrefetchLoader(BatchLoader(dt_train, batch, shuffle=True,
                                                      drop_last=True, seed=1, **kw)))
        prefetch_s = time.perf_counter() - start
        out[name] = {"batch_ms_by_t": {t: float(np.mean(v)) for t, v in sorted(by_t.items())},
                     "batches_by_t": {t: len(v) for t, v in sorted(by_t.items())},
                     "batch_ms_mean": float(np.mean([x for v in by_t.values() for x in v])),
                     "prefetch_epoch_s": prefetch_s, "prefetch_batches": n}
        print(f"loaders alone ({name}): BatchLoader ms a batch by T bucket "
              f"{json.dumps({t: round(v, 1) for t, v in out[name]['batch_ms_by_t'].items()})} "
              f"(batches {json.dumps(out[name]['batches_by_t'])}); a PrefetchLoader epoch "
              f"with no step {prefetch_s:.3f} s for {n} batches", flush=True)
    return out


def epochs_of(run, steps: int) -> dict:
    return {e: {"seconds": m["train_epoch_time"],
                "steps_per_s": steps / m["train_epoch_time"]}
            for e, m in sorted(run.trainlog.items())}


def trace_breakdown(path: str, epoch_s: float, steps: int) -> dict:
    """Phase 4's numbers from a chrome trace: the device's events merged
    into busy intervals, the host-to-device copies, the first kernel."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    start = min(e["ts"] for e in events)
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATS)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    kernels = sum(e["dur"] for e in events if e.get("cat") == "kernel")
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    first_kernel = min((e["ts"] for e in events if e.get("cat") == "kernel"),
                       default=start)
    return {"busy_ms": busy / 1e3, "busy_share": busy / 1e6 / epoch_s,
            "kernel_ms_per_step": kernels / 1e3 / steps,
            "h2d_ms_per_step": sum(e["dur"] for e in h2d) / 1e3 / steps,
            "h2d_gb": sum(e.get("args", {}).get("bytes", 0) for e in h2d) / 1e9,
            "first_kernel_after_ms": (first_kernel - start) / 1e3,
            "trace_span_ms": (max(e["ts"] + e["dur"] for e in events) - start) / 1e3}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--patches", type=int, default=176)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--model", choices=("timeunet", "utae"), default="timeunet")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--data", default=None, help="dataset folder (default: a temp dir)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--narrow", action="store_true",
                    help="narrow widths and 16^2 patches (a CPU check)")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("needs a CUDA card (or --device cpu --narrow)", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0],
              flush=True)
    tmp = tempfile.TemporaryDirectory()
    data = args.data or os.path.join(tmp.name, "data")
    start = time.perf_counter()
    if not os.path.exists(os.path.join(data, "metadata.json")):
        make_synthetic_dataset(data, n_patches=args.patches,
                               **({"hw": 16, "t_range": (5, 12)} if args.narrow else {}))
    write_s = time.perf_counter() - start
    if args.device == "cuda":
        from crop2seg_tpu_torch.ops import _build

        start = time.perf_counter()
        _build.build_all(["ltae_fused_fwd", "ltae_pool"])
        print(f"kernels built in {time.perf_counter() - start:.1f} s", flush=True)
    common = (["--device", args.device, "--dataset", "synthetic", "--dataset_folder", data,
               "--model", args.model, "--batch_size", str(args.batch), "--display_step",
               "1000"] + ([] if args.fp32 else ["--bf16"])
              + (NARROW + ["--t_buckets", "[8,12]"] if args.narrow else []))
    config = cli.parse_config(common)
    sizes = [len(d) for d in cli.build_datasets(config)]
    steps = sizes[0] // args.batch
    print(f"dataset: {args.patches} patches (train/val/test {sizes}) written in "
          f"{write_s:.1f} s; {steps} train steps an epoch at B={args.batch}, "
          f"{'fp32' if args.fp32 else 'bf16'}", flush=True)
    result = {"patches": args.patches, "sizes": sizes, "batch": args.batch,
              "steps_per_epoch": steps, "model": args.model,
              "dtype": "fp32" if args.fp32 else "bf16"}
    result["loaders"] = loaders_alone(config, args.batch)

    for key, extra in (("disk", []), ("device_cache", ["--device_cache"])):
        run = cli.main(cli.parse_config(common + extra + [
            "--epochs", str(args.epochs), "--res_dir", os.path.join(tmp.name, key)]))
        result[key] = epochs_of(run, steps)
        for e, v in result[key].items():
            print(f"{key} epoch {e}: {steps} steps in {v['seconds']:.3f} s, "
                  f"{v['steps_per_s']:.3f} steps/s", flush=True)

    trace_dir = os.path.join(tmp.name, "trace")
    run = cli.main(cli.parse_config(common + [
        "--epochs", "1", "--profile", trace_dir,
        "--res_dir", os.path.join(tmp.name, "profiled")]))
    epoch_s = run.trainlog[1]["train_epoch_time"]
    result["profiled"] = {"seconds": epoch_s, "steps_per_s": steps / epoch_s,
                          **trace_breakdown(os.path.join(trace_dir, "epoch_1.json"),
                                            epoch_s, steps)}
    p = result["profiled"]
    print(f"profiled epoch (from disk): {epoch_s:.3f} s, device busy {p['busy_ms']:.1f} ms "
          f"= {100 * p['busy_share']:.1f} %; kernels {p['kernel_ms_per_step']:.2f} ms a "
          f"step, host-to-device copies {p['h2d_ms_per_step']:.2f} ms a step "
          f"({p['h2d_gb']:.2f} GB in the epoch); first kernel "
          f"{p['first_kernel_after_ms']:.1f} ms after the epoch's start", flush=True)
    tmp.cleanup()
    print(json.dumps({"bench_train_cli": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
