"""crop2seg_tpu_torch.ops.preprocess against crop2seg_tpu.ops.preprocess on
the CPU: the cases of tests/test_preprocess_ops.py, with the JAX draws (its
flips, rotations and drop mask, recomputed from its keys) fed to the port;
the port's own draws from a torch.Generator; and
ops/patchify.py::patchify_training_tile against JAX on a full 10980^2 tile."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crop2seg_tpu.ops import preprocess as jp
from crop2seg_tpu.ops.patchify import patchify_training_tile as j_patchify_training
from crop2seg_tpu_torch.ops import preprocess as pp
from crop2seg_tpu_torch.ops.patchify import TRAIN_TILE, patchify_training_tile

B, T, H, W, C = 2, 5, 8, 8, 10


def _jax_geometry(key, b):
    """The flips and rotations jax's augment_geometric draws from ``key``."""
    return (np.asarray(jax.random.randint(key, (b,), 0, 3)),
            np.asarray(jax.random.randint(jax.random.fold_in(key, 1), (b,), 0, 4)))


def test_reorder_matches_jax():
    x = np.random.default_rng(0).normal(0, 1, (B, T, H, W, C)).astype(np.float32)
    np.testing.assert_array_equal(pp.reorder_channels(torch.tensor(x)).numpy(),
                                  np.asarray(jp.reorder_channels(jnp.asarray(x))))


def test_ndvi_matches_jax():
    x = np.random.default_rng(1).uniform(0, 4000, (B, T, H, W, C)).astype(np.float32)
    x[0, 0, 0, 0, [6, 2]] = 0.0                # undefined -> 0
    x[0, 0, 0, 1, [6, 2]] = (1.0, -3.0)        # outside [-1, 1] -> 0
    got = pp.add_ndvi(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jp.add_ndvi(jnp.asarray(x))), rtol=1e-6)
    assert got.shape[-1] == C + 1 and got[0, 0, 0, 0, -1] == 0 and got[0, 0, 0, 1, -1] == 0


@pytest.mark.parametrize("skip_last", [0, 1])
def test_standardize_matches_jax(skip_last):
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 4000, (B, T, H, W, 3)).astype(np.float32)
    mean = np.asarray([1.0, 1.0, 99.0], np.float32)
    std = np.asarray([2.0, 2.0, 99.0], np.float32)
    got = pp.standardize(torch.tensor(x), mean, std, skip_last=skip_last).numpy()
    want = np.asarray(jp.standardize(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(std),
                                     skip_last=skip_last))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if skip_last:
        np.testing.assert_array_equal(got[..., 2], x[..., 2])    # untouched


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_augment_matches_jax_for_its_draws(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (12, T, H, W, 2)).astype(np.float32)
    y = rng.integers(0, 15, (12, H, W)).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    jx, jy = jp.augment_geometric(jnp.asarray(x), jnp.asarray(y), key)
    flip, rot = _jax_geometry(key, 12)
    px, py = pp.augment_geometric(torch.tensor(x), torch.tensor(y), flip, rot)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))


def test_augment_covers_every_flip_and_rotation():
    """All 12 (flip, rotation) pairs against numpy, image and target
    together (the marker y stays the image's sign pattern)."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (12, T, H, W, 2)).astype(np.float32)
    y = (x[:, 0, :, :, 0] > 0).astype(np.int32)
    flip = np.repeat([0, 1, 2], 4)
    rot = np.tile([0, 1, 2, 3], 3)
    px, py = pp.augment_geometric(torch.tensor(x), torch.tensor(y), torch.tensor(flip),
                                  torch.tensor(rot))
    for i in range(12):
        xi = x[i] if flip[i] == 0 else np.flip(x[i], axis=-1 - flip[i])
        np.testing.assert_array_equal(px[i].numpy(), np.rot90(xi, rot[i], axes=(-3, -2)))
    np.testing.assert_array_equal(py.numpy(), (px[:, 0, :, :, 0] > 0).int().numpy())


@pytest.mark.parametrize("rate", [0.2, 0.95])
def test_temporal_dropout_mask_matches_jax(rate):
    pad = np.zeros((8, T), bool)
    pad[:, T - 1:] = True
    pad[3, 1:] = True                                   # a length-1 sample
    key = jax.random.PRNGKey(5)
    want = np.asarray(jp.temporal_dropout_mask(jnp.asarray(pad), key, rate))
    drop = np.asarray(jax.random.uniform(key, pad.shape) < rate)
    got = pp.temporal_dropout_mask(torch.tensor(pad), torch.tensor(drop)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (~got).any(axis=1).all()                     # every sample keeps a step
    assert got[:, T - 1].all()                          # pads stay padded


def test_temporal_dropout_never_unmasks_pads():
    """A length-1 sample whose only valid frame is dropped gets that frame
    back and keeps every pad frame masked."""
    pad = np.zeros((1, 8), bool)
    pad[0, 1:] = True
    got = pp.temporal_dropout_mask(torch.tensor(pad), torch.ones(1, 8, dtype=torch.bool))
    assert not got[0, 0] and got[0, 1:].all()


def test_preprocess_batch_matches_jax_for_its_draws():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 4000, (B, T, H, W, C)).astype(np.float32)
    y = rng.integers(0, 15, (B, H, W)).astype(np.int32)
    pad = np.zeros((B, T), bool)
    pad[1, 3:] = True
    mean = rng.uniform(100, 2000, C).astype(np.float32)
    std = rng.uniform(10, 500, C).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = jax.jit(lambda x, y, m: jp.preprocess_batch(
        x, jnp.asarray(mean), jnp.asarray(std), y=y, pad_mask=m, rng=key, reorder=True,
        ndvi=True, augment=True, temporal_dropout=0.2))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(pad))
    flip, rot = _jax_geometry(jax.random.fold_in(key, 7), B)
    drop = np.asarray(jax.random.uniform(jax.random.fold_in(key, 11), (B, T)) < 0.2)
    got = pp.preprocess_batch(torch.tensor(x), mean, std, y=torch.tensor(y),
                              pad_mask=torch.tensor(pad), reorder=True, ndvi=True,
                              augment=True, temporal_dropout=0.2, flip=flip, rot=rot,
                              drop=torch.tensor(drop))
    assert got["x"].shape == (B, T, H, W, C + 1)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got["x"][1, 3:].numpy(), 0.0)       # pads zeroed
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
    np.testing.assert_array_equal(got["pad_mask"].numpy(), np.asarray(want["pad_mask"]))


def test_preprocess_batch_draws_from_the_generator():
    """Without draws given, preprocess_batch takes them from the generator,
    in the order draw_geometry then draw_temporal_dropout."""
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.uniform(0, 4000, (4, T, H, W, C)).astype(np.float32))
    y = torch.tensor(rng.integers(0, 15, (4, H, W)).astype(np.int32))
    pad = torch.zeros(4, T, dtype=torch.bool)
    mean, std = np.full(C, 1000, np.float32), np.full(C, 300, np.float32)
    kw = dict(y=y, pad_mask=pad, augment=True, temporal_dropout=0.3)
    got = pp.preprocess_batch(x, mean, std, generator=torch.Generator().manual_seed(9), **kw)
    gen = torch.Generator().manual_seed(9)
    flip, rot = pp.draw_geometry(4, gen)
    drop = pp.draw_temporal_dropout((4, T), 0.3, gen)
    assert flip.dtype == torch.int64 and 0 <= flip.min() and flip.max() <= 2
    assert 0 <= rot.min() and rot.max() <= 3
    want = pp.preprocess_batch(x, mean, std, flip=flip, rot=rot, drop=drop, **kw)
    for k in ("x", "y", "pad_mask"):
        assert torch.equal(got[k], want[k])


def test_patchify_training_tile_matches_jax():
    tile = np.random.default_rng(7).integers(0, 255, (TRAIN_TILE, TRAIN_TILE, 1),
                                             dtype=np.uint8)
    got = patchify_training_tile(torch.from_numpy(tile))
    assert got.shape == (6724, 128, 128, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_patchify_training(jnp.asarray(tile))))
