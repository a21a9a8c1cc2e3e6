"""Training cells (mix kind "train"): the trainer's step,
``make_train_step(...)(batch, generator)``, on a pool of seeded batches
resident on the card, taken in turn, with one dropout generator.

Set-up builds one step object (model, Adam state), drives it through its
first CHECK_STEPS steps on distinct batches through the window's own call,
and hands that same object to the window. From those steps it keeps the
first step's output (a forward hook on the model), the losses, each
parameter's first gradient as Adam got it (its first moment after one step
over 1 - beta1) and each parameter's and BatchNorm statistic's change
after the last of them. Once the window has closed and the program is
freed, the plain reference takes the same steps from the same state dict,
batches and dropout draws (float32, TF32 off), and the readings are held
against it:

- ``proba_median_err``: the first step's class probabilities, per pixel
  the largest |probability - reference probability|, its median over the
  batch's pixels (an output of another shape reads inf);
- ``loss_first_gap``: the first step's loss against the plain reference's
  loss (weighted cross entropy in float32) of that step's own output,
  |loss - reference loss| / reference loss: the loss stage held by itself,
  so that bfloat16's rounding of the forward, which ``proba_median_err``
  holds, does not blur it (a loss over part of the batch reads the spread
  of the rows' losses);
- ``change_gap_median``: per leaf |norm - reference norm| of its change
  after the steps, over the larger of the reference leaf's and the median
  leaf's; its median over the leaves (a state left unchanged reads 1).

Read beside them and held to no limit (PERF.md gives the readings and the
look): ``change_gap``, the worst leaf's gap of the change; ``loss_gap``,
the largest gap of the steps' losses against the reference's; ``grad_gap``, the worst leaf's gap of
the first gradient's norm, as ``change_gap``; ``proba_max_err``. Under
bfloat16 rounding the encoder's first gradients differ from float32's by
about their own norm (a reference rounded to bfloat16 does the same), Adam
moves every element by about the rate whatever its gradient's size, and a
parameter change of that size moves the next forward far more than the
rounding of the first did (the published key init saturates the
attention): so the worst leaf and the later steps read the noise of small
leaves and of the later steps, in float32 as in bfloat16.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a bias before a BatchNorm, the keys' bias under the softmax) move
under Adam by round-off alone, and are left out of the gaps.
"""
from __future__ import annotations

import json
import statistics
import time

import torch

from portbench import reference
from portbench.harness import common, counts, inputs, serve
from portbench.reference import ops

CHECK_STEPS = 3
TRACED_UNITS = 3
BETA1 = 0.9
ROUND_OFF = 1e-3      # a leaf whose gradient is under this share of the median's


def _running(model) -> dict:
    return {k: v for k, v in model.named_buffers() if "running_" in k}


def _changes(model, state: dict) -> dict:
    out = {k: (p.detach().float() - state[k]).norm().item() for k, p in model.named_parameters()}
    out.update({k: (v.float() - state[k]).norm().item() for k, v in _running(model).items()})
    return out


def program_steps(step, model, batches: list, gen, state: dict) -> dict:
    """The first CHECK_STEPS steps of the program's step object: losses,
    first gradients' norms (from Adam's state) and changes."""
    losses, grads, outs = [], None, []
    for k in range(CHECK_STEPS):
        batch = batches[k]
        hook = (model.register_forward_hook(lambda m, i, o: outs.append(o.detach()))
                if k == 0 else None)
        losses.append(float(step(batch, gen)["loss"]))
        if hook is not None:
            hook.remove()
        if k == 0:
            opt_state = step.optimizer.state
            grads = {name: (opt_state[p]["exp_avg"].float() / (1 - BETA1)).norm().item()
                     if p in opt_state else 0.0
                     for name, p in model.named_parameters()}
    proba = torch.softmax(outs[0].float(), dim=-1) if outs else None
    return {"losses": losses, "grads": grads, "changes": _changes(model, state), "proba": proba,
            "logits": outs[0] if outs else None}


def class_weight(run: common.Run) -> torch.Tensor:
    weight = torch.ones(run.mix["classes"], device=run.device)
    weight[run.mix["ignore_class"]] = 0.0
    return weight


def add_output_loss(run: common.Run, got: dict, batch: dict) -> None:
    """Adds to the program's readings ``got`` the plain reference's loss of
    its own first output (the first batch's), and drops that output."""
    logits = got.pop("logits")
    got["output_loss"] = (float("nan") if logits is None else
                          ops.weighted_cross_entropy(logits.float(), batch["y"],
                                                     class_weight(run)).item())


def reference_steps(run: common.Run, state: dict, batches: list, seed: int,
                    precision: str = "fp32") -> dict:
    """The same steps of the plain reference: its forward (the frame-wise
    encoder and the L-TAE's chunks recomputed in the backward pass, to fit),
    the weighted cross entropy, backward, Adam."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mix = run.mix
    ref = reference.build(run.cfg, precision).to(run.device)
    ref.load_state_dict(state)
    ref.train()
    adam = ops.Adam(ref.parameters(), lr=mix["lr"])
    weight = class_weight(run)
    gen = inputs.generator(seed, "dropout", run.device)
    losses, grads = [], None
    for k in range(CHECK_STEPS):
        b = batches[k]
        for p in ref.parameters():
            p.grad = None
        logits = ref(b["x"], b["dates"], b["pad_mask"], generator=gen, checkpointed=True)
        loss = ops.weighted_cross_entropy(logits.float(), b["y"], weight)
        loss.backward()
        losses.append(loss.item())
        if k == 0:
            grads = {n: p.grad.norm().item() for n, p in ref.named_parameters()}
            proba = torch.softmax(logits.detach().float(), dim=-1)
        del logits, loss
        adam.step()
    out = {"losses": losses, "grads": grads, "changes": _changes(ref, state), "proba": proba,
           "output_loss": losses[0]}
    del ref, adam
    common.free(run.device)
    return out


def gaps(got: dict, want: dict) -> dict:
    """The compared numbers of a run's readings ``got`` against the
    reference's ``want``."""
    med_g = statistics.median(want["grads"].values())
    leaves = [k for k, v in want["grads"].items() if v >= ROUND_OFF * med_g]
    moved = leaves + [k for k in want["changes"] if k not in want["grads"]]
    med_c = statistics.median(want["changes"][k] for k in moved)
    change = [abs(got["changes"][k] - want["changes"][k]) / max(want["changes"][k], med_c)
              for k in moved]
    proba = ({"proba_median_err": float("inf"), "proba_max_err": float("inf")}
             if got["proba"] is None else serve.proba_gaps(got["proba"], want["proba"]))
    return dict(proba, change_gap_median=statistics.median(change), change_gap=max(change),
                loss_first_gap=abs(got["losses"][0] - got["output_loss"]) / abs(got["output_loss"]),
                loss_gap=max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
                grad_gap=max(abs(got["grads"][k] - want["grads"][k]) / max(want["grads"][k], med_g)
                             for k in leaves))


def _setup(run: common.Run, seed: int):
    template = reference.build(run.cfg)
    state = inputs.seeded_state(template, seed, run.device)
    run.mark("weights")
    batches = inputs.make_batches(run.mix, run.cfg["input_dim"], seed, run.device)
    run.mark("batches")
    step, model = run.program.train_step(run.cfg, state, run.mix, run.device)
    run.mark("program built")
    return state, batches, step, model


def run_cell(run: common.Run) -> dict:
    mix = run.mix
    run.mark("imports")
    state, batches, step, model = _setup(run, run.seed)
    gen = inputs.generator(run.seed, "dropout", run.device)
    got = program_steps(step, model, batches, gen, state)
    common.sync(run.device)
    run.mark("check steps")
    setup_peak = common.peak_bytes(run.device)
    common.reset_peak(run.device)
    setup_s = time.time() - run.t_start

    losses = []

    def unit(i):
        aux = step(batches[(CHECK_STEPS + i) % len(batches)], gen)
        losses.append(aux["loss"])
        return mix["batch"]

    units, work, window_s, tracer, traced_work = common.window(run, unit, TRACED_UNITS)
    window_peak = common.peak_bytes(run.device)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    del step, model, losses
    common.free(run.device)

    add_output_loss(run, got, batches[0])
    want = reference_steps(run, state, batches, run.seed)
    correct, checks = common.judge(gaps(got, want), run.limits)
    trace = flops = None
    if tracer is not None:
        trace = tracer.summary()
        flops = counts.model_flops(reference.build(run.cfg), (1, mix["t"], mix["side"],
                                                              mix["side"], run.cfg["input_dim"]),
                                   train=True)
    shape = reference.build(run.cfg).ltae_launch(mix["batch"], mix["t"], mix["side"])
    r = common.Readings(cfg=run.cfg, mix=mix, dtype=run.dtype, setup_s=setup_s,
                        window_s=window_s, units=units, work=work, peak_bytes=window_peak,
                        flops_per_work=flops, ltae_shape=shape, trace=trace,
                        traced_work=traced_work)
    return {"correct": correct and failed == 0, "attempted": units, "failed": failed,
            "metrics": common.read_metrics(run, r),
            "device": common.device_info(run, max(setup_peak, window_peak), trace),
            "trace": trace, "checks": checks}


def half_batch(step, ignore_class: int):
    """A fault: ``step`` with the labels of the second half of each batch's
    rows set to the ignored class, so that its loss is the mean over the
    first half while the forward still sees every row."""
    def half(batch, generator):
        y = batch["y"].clone()
        y[y.shape[0] // 2:] = ignore_class
        return step(dict(batch, y=y), generator)
    half.optimizer = step.optimizer
    return half


def calibrate(run: common.Run, seeds: list) -> None:
    """The readings that the limits are set from, one JSON line a seed: the
    program's gaps ("program"); on the first CONTROLS seeds the
    control's (the reference in float8, "control") and those of the
    program's step with half of each batch left out of the loss
    ("half_batch", ``half_batch``). A state left unchanged reads
    ``change_gap_median`` 1 and needs no run."""
    for i, seed in enumerate(seeds):
        state, batches, step, model = _setup(run, seed)
        gen = inputs.generator(seed, "dropout", run.device)
        got = program_steps(step, model, batches, gen, state)
        add_output_loss(run, got, batches[0])
        del step, model
        common.free(run.device)
        want = reference_steps(run, state, batches, seed)
        line = {"seed": seed, "program": gaps(got, want)}
        if i < common.CONTROLS:
            line["control"] = gaps(reference_steps(run, state, batches, seed, "fp8"), want)
            step, model = run.program.train_step(run.cfg, state, run.mix, run.device)
            gen = inputs.generator(seed, "dropout", run.device)
            half = program_steps(half_batch(step, run.mix["ignore_class"]), model, batches, gen,
                                 state)
            add_output_loss(run, half, batches[0])
            line["half_batch"] = gaps(half, want)
            del step, model
        print(json.dumps(line), flush=True)
        del state, batches
        common.free(run.device)
