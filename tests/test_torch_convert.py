"""crop2seg_tpu_torch/utils/convert.py on conv layers with no norm: U-TAE
and TimeUNet built with ``encoder_norm="none"`` (any value but batch,
instance or group gives no norm, in both packages) hold each encoder unit as
conv, ReLU, so the Sequential indices are conv 2i, not the 3i of a unit
with a norm. The JAX model's converted weights must load with
``strict=True`` and give the JAX model's eval logits.

Size: two stages, narrow widths (in 6, encoder (8, 16), decoder (8, 16),
4 heads, d_model 32), B=2, T=7, 16x16 with a padded sample. Tolerance 1e-3,
the whole-model tolerance of tests/test_torch_timeunet.py.
"""
import jax
import numpy as np
import pytest
import torch

from crop2seg_tpu.models import TimeUNet as JTimeUNet
from crop2seg_tpu.models import UTAE as JUTAE
from crop2seg_tpu_torch.models.timeunet import TimeUNet
from crop2seg_tpu_torch.models.utae import UTAE
from crop2seg_tpu_torch.utils.convert import utae_state_dict_from_flax

KW = dict(input_dim=6, encoder_widths=(8, 16), decoder_widths=(8, 16), out_conv=(8, 5),
          n_head=4, d_model=32, d_k=4, encoder_norm="none")
TOL = dict(rtol=1e-3, atol=1e-3)


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["utae", "timeunet"])
def test_no_norm_encoder_weights_load_strictly_and_match_jax(name):
    jcls, tcls = {"utae": (JUTAE, UTAE), "timeunet": (JTimeUNet, TimeUNet)}[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 16, 16, 6)).astype(np.float32)
    pad = np.zeros((2, 7), bool)
    pad[1, 5:] = True
    x[pad] = 0.0
    dates = np.tile((np.arange(7) * 9.0 + 4).astype(np.float32), (2, 1))
    m = jcls(**KW)
    v = jax.jit(lambda x: m.init(jax.random.PRNGKey(1), x, dates, pad_mask=pad,
                                 train=False))(x)
    v = jax.tree_util.tree_map(np.asarray, v)
    want = np.asarray(jax.jit(lambda v, x: m.apply(v, x, dates, pad_mask=pad,
                                                   train=False))(v, x))
    model = tcls(**KW).eval()
    sd = utae_state_dict_from_flax(v)
    assert "in_conv.conv.conv.2.weight" in sd and "in_conv.conv.conv.3.weight" not in sd
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = model(_t(x), _t(dates), _t(pad), fused=False).numpy()
    np.testing.assert_allclose(got, want, **TOL)
