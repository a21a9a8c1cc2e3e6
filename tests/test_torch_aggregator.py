"""crop2seg_tpu_torch temporal aggregator: the reference goldens (the
tolerance of tests/test_ltae_parity.py, 1e-4) and each mode against
crop2seg_tpu.nn.aggregator.temporal_aggregate on seeded inputs with pads,
upsampling the attention (8^2 -> 32^2) and downsampling it (8^2 -> 4^2), at
1e-5 (fp32 sums of T=7 terms in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crop2seg_tpu.nn.aggregator import temporal_aggregate as jax_aggregate
from crop2seg_tpu_torch.nn.aggregator import temporal_aggregate
from tests.parity_utils import attn_from_torch, from_nhwc, load_fixture, to_nhwc_seq


@pytest.mark.parametrize("name,mode", [
    ("aggregator_att_group", "att_group"),
    ("aggregator_att_group_down", "att_group"),
    ("aggregator_att_mean", "att_mean"),
    ("aggregator_mean", "mean")])
def test_golden(name, mode):
    arrays, _ = load_fixture(name)
    y = temporal_aggregate(
        torch.tensor(to_nhwc_seq(arrays["x"])),
        attn=torch.tensor(attn_from_torch(arrays["attn"])),
        pad_mask=torch.tensor(arrays["pad_mask"]), mode=mode)
    np.testing.assert_allclose(from_nhwc(y.numpy()), arrays["y"], rtol=1e-4,
                               atol=1e-4, err_msg=name)


@pytest.mark.parametrize("mode", ["att_group", "att_mean", "mean"])
@pytest.mark.parametrize("size", [32, 8, 4], ids=["up", "same", "down"])
@pytest.mark.parametrize("padded", [True, False], ids=["pads", "nopads"])
def test_matches_jax(mode, size, padded):
    rng = np.random.default_rng(size)
    b, t, c, heads = 2, 7, 32, 8
    x = rng.standard_normal((b, t, size, size, c)).astype(np.float32)
    logits = rng.standard_normal((b, 8, 8, heads, t)).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    pad = np.zeros((b, t), bool)
    if padded:
        pad[0, 5:] = True
        x[pad] = 0.0
    want = jax_aggregate(jnp.asarray(x), attn=jnp.asarray(attn),
                         pad_mask=jnp.asarray(pad) if padded else None, mode=mode)
    got = temporal_aggregate(torch.tensor(x), attn=torch.tensor(attn),
                             pad_mask=torch.tensor(pad) if padded else None,
                             mode=mode)
    assert got.shape == (b, size, size, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bf16_keeps_the_dtype_and_sums_in_fp32():
    """bf16 x: the result is bf16 and within one bf16 rounding of the fp32
    result on the same bf16-rounded inputs."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, 5, 16, 16, 16)).astype(np.float32))
    attn = torch.softmax(torch.tensor(rng.standard_normal((2, 8, 8, 4, 5)),
                                      dtype=torch.float32), -1)
    pad = torch.tensor([[False] * 5, [False] * 3 + [True] * 2])
    xb = x.bfloat16()
    got = temporal_aggregate(xb, attn=attn.bfloat16().float(), pad_mask=pad)
    want = temporal_aggregate(xb.float(), attn=attn.bfloat16().float(), pad_mask=pad)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown aggregation mode"):
        temporal_aggregate(torch.zeros(1, 2, 4, 4, 8), mode="max")
