"""Entry points of the port (the counterpart of __graft_entry__.py):
``entry`` (the flagship U-TAE's forward) and ``dryrun_multichip`` (every
data-parallel and patch-parallel path over a group, at small widths).

    python -m crop2seg_tpu_torch.graft_entry            # entry on the card
    python -c "from crop2seg_tpu_torch.graft_entry import dryrun_multichip; \\
               dryrun_multichip(2, device='cpu')"      # two gloo processes
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

SMALL = dict(input_dim=10, encoder_widths=(8, 8, 16), decoder_widths=(4, 8, 16),
             out_conv=(8, 15), n_head=4, d_model=32, d_k=4)
B_T_HW_C = (8, 16, 10)           # the dry run's T, H = W and C


def _flagship(small: bool = False, seed: int = 1, **kw):
    """The flagship U-TAE (15 classes), or its small widths, its weights
    drawn from ``seed``."""
    from crop2seg_tpu_torch.models import UTAE
    from crop2seg_tpu_torch.models.factory import init_weights

    model = UTAE(**SMALL, **kw) if small else UTAE(input_dim=10, out_conv=(32, 15), **kw)
    return init_weights(model, torch.Generator().manual_seed(seed))


def entry(device=None):
    """Returns ``(fn, args)``: the flagship U-TAE's forward in eval mode at
    (1, 30, 128, 128, 10), length 27 (the JAX ``entry``'s shapes), seeded
    inputs and weights on ``device`` (the card unless "cpu"): ``fn(*args)``
    gives the (1, 128, 128, 15) logits."""
    from crop2seg_tpu_torch.device import resolve_device
    from crop2seg_tpu_torch.nn.temporal import pad_mask_from_lengths

    dev = resolve_device(device)
    model = _flagship().to(dev).eval()
    b, t, h, w, c = 1, 30, 128, 128, 10
    x = torch.randn(b, t, h, w, c, generator=torch.Generator().manual_seed(0)).to(dev)
    dates = (torch.arange(t, dtype=torch.float32) * 5 + 3)[None].to(dev)
    pad_mask = pad_mask_from_lengths(torch.tensor([27], device=dev), t)

    def fn(x, dates, pad_mask):
        with torch.inference_mode():
            return model(x, dates, pad_mask)

    return fn, (x, dates, pad_mask)


def _global_batch(seed: int, b: int, rng=None) -> dict:
    """A global batch of ``b`` samples at the dry run's shapes (the JAX dry
    run's: the last frame of every sample a pad)."""
    t, hw, c = B_T_HW_C
    rng = rng if rng is not None else np.random.default_rng(seed)
    pad = np.zeros((b, t), bool)
    pad[:, t - 1] = True
    return {"x": rng.standard_normal((b, t, hw, hw, c)).astype(np.float32),
            "dates": np.tile(np.arange(t, dtype=np.float32)[None] * 5, (b, 1)),
            "pad_mask": pad,
            "y": rng.integers(0, 15, (b, hw, hw)).astype(np.int64)}


def _no_dropout(model):
    """``model`` with its L-TAE's dropout rates at 0."""
    model.temporal_encoder.attn_dropout = 0.0
    model.temporal_encoder.mlp[1].p = 0.0
    return model


def _dryrun_worker(rank: int, world: int, store_dir: str, dev_type: str) -> dict:
    """One rank of ``dryrun_multichip``: the blocks of
    __graft_entry__.py:38-249; rank 0 prints."""
    from crop2seg_tpu_torch.learning import checkpoint as ckpt
    from crop2seg_tpu_torch.learning.trainer import (
        StepConfig, create_train_state, run_epoch)
    from crop2seg_tpu_torch.learning.weight_init import apply_reference_init
    from crop2seg_tpu_torch.models import TimeUNet, WTAE
    from crop2seg_tpu_torch.models.factory import init_weights
    from crop2seg_tpu_torch.ops.patchify import np_stitch_inference_tile
    from crop2seg_tpu_torch.parallel import (
        barrier, data_parallel_eval, data_parallel_step, data_space_parallel_step,
        init_group, make_mesh, make_mesh_2d, patch_parallel_infer, rank_seed, replicate,
        shard_batch, shard_batch_2d)

    dev = torch.device(f"cuda:{rank}" if dev_type == "cuda" else "cpu")
    group = init_group(rank, world, store_dir, dev)
    # repeatable on the card too: the checkpoint block compares two runs at 1e-6
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def say(msg):
        if rank == 0:
            print(f"dryrun_multichip({world}): {msg}", flush=True)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(rank_seed(seed, rank))

    b = world
    t, hw, c = B_T_HW_C
    rng = np.random.default_rng(0)
    batch = _global_batch(0, b, rng)
    shard = shard_batch(batch, group)
    cfg = StepConfig(num_classes=15, ignore_index=-1,
                     class_weights=tuple([0.0] + [1.0] * 13 + [0.0]), label_smoothing=0.1)
    out = {}

    model = apply_reference_init(_flagship(small=True, seed=2),
                                 torch.Generator().manual_seed(3))
    utae_state = {k: v.clone() for k, v in model.state_dict().items()}
    replicate(model.to(dev), group)
    step = data_parallel_step(model, cfg, device=dev)
    aux = step(shard, gen(4))
    loss = float(aux["loss"])
    assert math.isfinite(loss), loss
    assert int(aux["cm"].sum()) == b * hw * hw, int(aux["cm"].sum())
    out["dp_loss"] = loss
    say(f"dp loss={loss:.4f} OK")

    mesh2 = make_mesh_2d(world // 2, 2, group) if world % 2 == 0 else None

    def two_d(build, state: dict, seed: int) -> list:
        """A 2-D block of __graft_entry__.py: the losses of a step of
        ``build()`` from ``state`` on the 1-D mesh and on the (n / 2, 2)
        mesh, dropout 0 on both (within 1e-3), and on the 2-D mesh with
        dropout (finite)."""
        losses = []
        for on_2d, dropout in ((False, False), (True, False), (True, True)):
            m = build().to(dev)
            m.load_state_dict(state)
            if not dropout:
                _no_dropout(m)
            replicate(m, group)
            if on_2d:
                st = data_space_parallel_step(m, cfg, mesh2, device=dev)
                part = shard_batch_2d(batch, mesh2, m)
            else:
                st, part = data_parallel_step(m, cfg, device=dev), shard
            losses.append(float(st(part, gen(seed))["loss"]))
        one, two, dropped = losses
        assert abs(two - one) < 1e-3 and math.isfinite(dropped), losses
        return losses

    if mesh2 is not None:
        out["dp_sp_losses"] = one, two, dropped = two_d(
            lambda: _flagship(small=True), utae_state, 4)
        say(f"dp x sp loss={two:.4f} (1-D mesh {one:.4f}, dropout 0; with dropout "
            f"{dropped:.4f}) OK")

    # the kernel pair's training route over the group
    def tu_pair():
        return TimeUNet(use_pallas=False, use_pallas_train=True, **SMALL)
    tu_ker = init_weights(tu_pair(), torch.Generator().manual_seed(5)).to(dev)
    tu_state = {k: v.clone() for k, v in tu_ker.state_dict().items()}
    replicate(tu_ker, group)
    aux_k = data_parallel_step(tu_ker, cfg, device=dev)(shard, gen(6))
    assert math.isfinite(float(aux_k["loss"])), aux_k["loss"]
    out["pair_train_loss"] = float(aux_k["loss"])
    if mesh2 is not None:
        out["pair_sp_losses"] = one, two, dropped = two_d(tu_pair, tu_state, 6)
        say(f"pallas-train pool on data x space mesh loss={two:.4f} (1-D mesh "
            f"{one:.4f}, dropout 0; with dropout {dropped:.4f}) OK")

    wt = init_weights(WTAE(**SMALL), torch.Generator().manual_seed(7)).to(dev)
    replicate(wt, group)
    aux_wt = data_parallel_step(wt, cfg, device=dev)(shard, gen(8))
    loss_wt = float(aux_wt["loss"])
    assert math.isfinite(loss_wt), loss_wt
    assert int(aux_wt["cm"].sum()) == b * hw * hw
    out["wtae_dp_loss"] = loss_wt
    say(f"wtae dp loss={loss_wt:.4f} OK")

    # the eval loss: the pair's route in eval against the plain ops
    losses = {}
    for name, flags in (("pair", (False, True)), ("plain", (False, False))):
        m = TimeUNet(use_pallas=flags[0], use_pallas_train=flags[1], **SMALL).to(dev)
        m.load_state_dict(tu_state)
        losses[name] = float(data_parallel_eval(m, cfg, device=dev)(shard)["loss"])
    assert abs(losses["pair"] - losses["plain"]) < 1e-4 * max(1.0, abs(losses["plain"])), losses
    out["eval_loss"] = losses
    say(f"pallas-train pool on mesh loss={losses['pair']:.4f} (plain {losses['plain']:.4f}) OK")

    # sharded whole-tile inference, one process over every device of the run
    n_patches = 16 if world in (1, 2, 4, 8, 16) else world
    if rank == 0 and n_patches % world == 0 and int(np.sqrt(n_patches)) ** 2 == n_patches:
        mesh = make_mesh([torch.device(dev_type, i) if dev_type == "cuda" else "cpu"
                          for i in range(world)])
        px = torch.from_numpy(rng.standard_normal((n_patches, t, hw, hw, c)).astype(np.float32))
        pdates = torch.from_numpy(batch["dates"][:1]).expand(n_patches, t)
        pmask = torch.from_numpy(batch["pad_mask"][:1]).expand(n_patches, t)
        model.eval()
        with torch.inference_mode():
            out_sh = patch_parallel_infer(model, mesh)(px.to(dev), pdates.to(dev),
                                                       pmask.to(dev)).cpu().numpy()
            out_1d = model(px.to(dev), pdates.to(dev), pmask.to(dev)).cpu().numpy()
        np.testing.assert_allclose(out_sh, out_1d, rtol=1e-4, atol=1e-5)
        side = int(np.sqrt(n_patches)) * hw
        np.testing.assert_array_equal(np_stitch_inference_tile(out_sh.argmax(-1), out_hw=side),
                                      np_stitch_inference_tile(out_1d.argmax(-1), out_hw=side))
        say(f"sharded tile inference {n_patches} patches -> {side}^2 stitch OK")

    def quiet(*a, **k):
        pass

    def epoch(seed):
        return [shard_batch(_global_batch(seed * 10 + i, b), group) for i in range(2)]

    model = apply_reference_init(_flagship(small=True, seed=2),
                                 torch.Generator().manual_seed(3)).to(dev)
    replicate(model, group)
    opt = create_train_state(model, 1e-3)
    step = data_parallel_step(model, cfg, optimizer=opt, device=dev)
    ev = data_parallel_eval(model, cfg, device=dev)
    tr_m, _ = run_epoch(step, epoch(11), cfg, mode="train", generator=gen(9), log_fn=quiet)
    val_m, _ = run_epoch(ev, epoch(12), cfg, mode="val", log_fn=quiet)
    assert np.isfinite(tr_m["train_loss"]) and np.isfinite(val_m["val_IoU"])
    say(f"epoch loop on mesh train_loss={tr_m['train_loss']:.4f} "
        f"val_IoU={val_m['val_IoU']:.4f} OK")

    # rank 0 writes the checkpoint; every rank resumes from it
    ckpt_dir = os.path.join(store_dir, "ckpt")
    if rank == 0:
        os.makedirs(ckpt_dir)
        ckpt.save_state(ckpt_dir, model, opt, epoch=1, best_miou=float(val_m["val_IoU"]))
    barrier(group)
    m_direct, _ = run_epoch(step, epoch(13), cfg, mode="train", generator=gen(10),
                            log_fn=quiet)
    payload = ckpt.load_state(ckpt_dir)
    resumed = _flagship(small=True).to(dev)
    resumed.load_state_dict(payload["model"])
    opt_r = create_train_state(resumed, 1e-3)
    opt_r.load_state_dict(payload["optimizer"])
    step_r = data_parallel_step(resumed, cfg, optimizer=opt_r, device=dev)
    m_resume, _ = run_epoch(step_r, epoch(13), cfg, mode="train", generator=gen(10),
                            log_fn=quiet)
    assert abs(m_resume["train_loss"] - m_direct["train_loss"]) < 1e-6, (
        m_direct["train_loss"], m_resume["train_loss"])
    assert abs(m_resume["train_IoU"] - m_direct["train_IoU"]) < 1e-6
    out["resume_loss"] = (m_direct["train_loss"], m_resume["train_loss"])
    say(f"rank-0 checkpoint resume-identical (loss {m_resume['train_loss']:.6f}) OK")
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One train step, eval and epoch of every data-parallel path over a
    group of ``n_devices`` processes at small widths (__graft_entry__.py:
    38-249): the U-TAE step (finite loss, ``cm`` summing to B*H*W), and for
    an even ``n_devices`` its step on the (n / 2, 2) data x space mesh
    within 1e-3 of the 1-D mesh's loss, TimeUNet's step on the kernel pair,
    and the same 2-D block for it, W-TAE's step, the eval loss of the pair's
    route against
    the plain ops (1e-4), the patch-parallel tile against one device's
    (1e-4 / 1e-5, the stitched classes equal), ``run_epoch`` train and val,
    and a rank-0 checkpoint whose resumed continuation equals the direct one
    (1e-6). The 2-D blocks hold their loss with the dropout rates at 0 on
    both meshes: a 2-D rank draws the masks of its own rows from its own
    generator, so with dropout the two meshes drop other values (their step
    with dropout must be finite); without, they differ by the order of fp32
    sums. On the card (``device`` None or "cuda") one process a card over
    NCCL, and it raises when fewer than ``n_devices`` are visible; with
    ``device="cpu"`` gloo processes. Returns rank 0's numbers."""
    from crop2seg_tpu_torch.device import resolve_device
    from crop2seg_tpu_torch.ops import _build
    from crop2seg_tpu_torch.parallel import run_workers

    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} cards; "
                               f"{torch.cuda.device_count()} are visible")
        _build.build_all(["ltae_fused_fwd", "ltae_pool"])
    threads = 1 if dev.type == "cpu" else None
    return run_workers(_dryrun_worker, n_devices, dev.type, threads=threads)[0]


if __name__ == "__main__":
    fn, args = entry()
    print("entry forward:", tuple(fn(*args).shape))
