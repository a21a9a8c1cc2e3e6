"""crop2seg_tpu_torch whole-tile inference: patchify / stitch against the JAX
package's ops (exact: both only move data), and the tile predictor on the
CPU with a tiny TimeUNet over a full 1098^2 tile."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crop2seg_tpu.ops import patchify as jp
from crop2seg_tpu_torch.inference.tile import make_tile_predictor
from crop2seg_tpu_torch.models.factory import get_model
from crop2seg_tpu_torch.ops import patchify as tp


@pytest.fixture(scope="module")
def tile():
    rng = np.random.default_rng(0)
    return rng.standard_normal((3, 1098, 1098, 10)).astype(np.float32)


def test_patchify_matches_jax(tile):
    got = tp.patchify_inference_tile(torch.tensor(tile[:2, ..., :3]))
    want = np.asarray(jp.patchify_inference_tile(jnp.asarray(tile[:2, ..., :3])))
    assert got.shape == (100, 2, 128, 128, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stitch_matches_jax_and_numpy_twin():
    patches = np.random.default_rng(1).standard_normal(
        (100, 128, 128, 4)).astype(np.float32)
    got = tp.stitch_inference_tile(torch.tensor(patches))
    want = np.asarray(jp.stitch_inference_tile(jnp.asarray(patches)))
    assert got.shape == (1098, 1098, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tp.np_stitch_inference_tile(patches), want)
    np.testing.assert_array_equal(tp.np_stitch_inference_tile(patches[..., 0]),
                                  want[..., 0])


def test_stitch_inverts_patchify(tile):
    x = torch.tensor(tile[0, ..., :4])                     # (1098, 1098, 4)
    patches = tp.patchify_inference_tile(x[None])[:, 0]    # (100, 128, 128, 4)
    torch.testing.assert_close(tp.stitch_inference_tile(patches), x, rtol=0, atol=0)


TINY = {"model": "timeunet", "encoder_widths": [8, 8, 16],
        "decoder_widths": [8, 8, 16], "out_conv": [8, 5], "n_head": 4,
        "d_model": 16, "d_k": 4}


def test_tile_predictor_on_cpu(tile):
    """Shapes, proba sums to 1, and the result is the stitch of the model's
    own per-patch forward (batch 32: the last batch of 4 is padded)."""
    model = get_model(TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    dates = np.arange(3, dtype=np.float32) * 10.0
    predict = make_tile_predictor(model, batch_size=32, device="cpu")
    res = predict(tile, dates, 2)
    proba, classes = res["proba"], res["classes"]
    assert proba.shape == (1098, 1098, 5) and proba.dtype == np.float32
    assert classes.shape == (1098, 1098) and classes.dtype == np.uint8
    np.testing.assert_allclose(proba.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(classes, proba.argmax(-1))

    patches = tp.patchify_inference_tile(torch.tensor(tile))
    mask = torch.tensor([[False, False, True]])
    with torch.inference_mode():
        per_patch = [torch.softmax(model(patches[i:i + 1], torch.tensor(dates)[None],
                                         mask), dim=-1)[0]
                     for i in range(patches.shape[0])]
    want = tp.stitch_inference_tile(torch.stack(per_patch)).numpy()
    # 1e-5: batch 1 vs batch 32 convolutions sum in other orders
    np.testing.assert_allclose(proba, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_hw", [1098, 512])
def test_tile_predictor_out_hw_matches_jax(tile, out_hw):
    """The JAX make_tile_predictor(out_hw=...) against the port's 1098 map
    cropped to (out_hw, out_hw) (the port's predictor has no out_hw), with
    the same weights (utils/convert.py). TINY's L-TAE ends in a GroupNorm
    of two channels a group, which maps a pixel's two values to about +-1
    and turns a near-tie between them into a jump (fp32 sums taken in other
    orders move the L-TAE output by up to ~0.8 at ~3 in 10^4 pixels, where
    the JAX and port in_conv outputs differ by ~7e-4). So: proba within
    1e-3 (tests/test_torch_timeunet.py's TimeUNet tolerance) on >= 99.9 %
    of the pixels and within 2e-2 on all; classes equal on >= 99.9 %."""
    import jax

    from crop2seg_tpu.inference.tile import make_tile_predictor as jax_predictor
    from crop2seg_tpu.models import TimeUNet
    from crop2seg_tpu_torch.utils.convert import timeunet_state_dict_from_flax

    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in TINY.items() if k != "model"}
    jax_model = TimeUNet(input_dim=10, **cfg)
    x = jnp.zeros((1, 2, 128, 128, 10))
    init = jax.jit(lambda key, x, d: jax_model.init(key, x, d, train=False))
    variables = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(1), x,
                                                        jnp.zeros((1, 2))))
    model = get_model(TINY, device="cpu")
    model.load_state_dict(timeunet_state_dict_from_flax(variables))
    dates = np.arange(2, dtype=np.float32) * 10.0
    full = make_tile_predictor(model, batch_size=50, device="cpu")(tile[:2], dates, 2)
    got = {k: v[:out_hw, :out_hw] for k, v in full.items()}
    want = jax_predictor(jax_model, batch_size=50, out_hw=out_hw)(variables, tile[:2],
                                                                  dates, 2)
    assert want["proba"].shape == got["proba"].shape == (out_hw, out_hw, 5)
    err = np.abs(got["proba"] - want["proba"]).max(-1)
    assert (err <= 1e-3).mean() >= 0.999 and err.max() <= 2e-2, (err.max(), (err > 1e-3).mean())
    assert (got["classes"] == want["classes"]).mean() >= 0.999
