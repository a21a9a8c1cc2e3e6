"""crop2seg_tpu_torch's metrics, losses and boundary classes against the JAX
package on the same numpy inputs.

- ``iou_from_cm``, ``confusion_matrix_analysis`` and ``IoUMeter`` (numpy on
  the host in both packages) on random confusion matrices: equal to 1e-12;
- the focal, soft, boundary-smoothed and recall cross entropies on (2, 8, 8,
  15) logits, over weights, gamma, smoothing and ignore index: 1e-6
  relative (fp32 on both sides);
- ``dilate_classes`` and ``boundary_mask`` at 4- and 8-connectivity, labels
  outside [0, K) included: exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crop2seg_tpu.learning import losses as jlosses
from crop2seg_tpu.learning import metrics as jmetrics
from crop2seg_tpu.ops import boundary as jboundary
from crop2seg_tpu_torch.learning import losses as tlosses
from crop2seg_tpu_torch.learning import metrics as tmetrics
from crop2seg_tpu_torch.ops import boundary as tboundary

K = 15
RTOL = 1e-6


def _cm(seed, k=K, zero_rows=(4,)):
    cm = np.random.default_rng(seed).integers(0, 50, (k, k)).astype(np.int64)
    for r in zero_rows:          # a class absent from the targets and the predictions
        cm[r, :] = 0
        cm[:, r] = 0
    return cm


@pytest.mark.parametrize("ignore", [None, 0, K - 1])
def test_iou_from_cm_matches_jax(ignore):
    cm = _cm(ignore or 1)
    iou_j, miou_j, acc_j = jmetrics.iou_from_cm(cm, ignore)
    iou_t, miou_t, acc_t = tmetrics.iou_from_cm(cm, ignore)
    np.testing.assert_allclose(iou_t, iou_j, rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose([miou_t, acc_t], [miou_j, acc_j], rtol=1e-12)


def test_confusion_matrix_analysis_matches_jax():
    per_j, overall_j = jmetrics.confusion_matrix_analysis(_cm(2))
    per_t, overall_t = tmetrics.confusion_matrix_analysis(_cm(2))
    assert per_t.keys() == per_j.keys() and overall_t.keys() == overall_j.keys()
    for c in per_j:
        for k in per_j[c]:
            np.testing.assert_allclose(per_t[c][k], per_j[c][k], rtol=1e-12,
                                       equal_nan=True, err_msg=f"{c}/{k}")
    for k in overall_j:
        np.testing.assert_allclose(overall_t[k], overall_j[k], rtol=1e-12, err_msg=k)


def test_iou_meter_matches_jax():
    """Numpy matrices and tensors accumulate alike; the ignore class is
    zeroed in the mIoU and the accuracy."""
    jm, tm = jmetrics.IoUMeter(K, K - 1), tmetrics.IoUMeter(K, K - 1)
    for seed in range(3):
        jm.add_cm(_cm(seed))
        tm.add_cm(torch.tensor(_cm(seed)) if seed % 2 else _cm(seed))
    np.testing.assert_array_equal(tm.cm, jm.cm)
    np.testing.assert_allclose(tm.get_miou_acc(), jm.get_miou_acc(), rtol=1e-12)
    tm.reset()
    assert tm.cm.sum() == 0 and tm.cm.dtype == np.int64


@pytest.fixture(scope="module")
def logits_target():
    rng = np.random.default_rng(0)
    logits = (2.0 * rng.standard_normal((2, 8, 8, K))).astype(np.float32)
    # blobs of classes (boundaries) and a background region
    target = np.repeat(np.repeat(rng.integers(0, K, (2, 4, 4)), 2, 1), 2, 2)
    target[0, :3, :3] = 0
    return logits, target.astype(np.int32)


WEIGHT = np.linspace(0.2, 1.5, K).astype(np.float32)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


@pytest.mark.parametrize("gamma", [0.0, 1.5, 2.0])
@pytest.mark.parametrize("ignore_index", [-100, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_focal_cross_entropy_matches_jax(logits_target, gamma, ignore_index, weighted):
    """Held against crop2seg_tpu.learning.losses.focal_cross_entropy."""
    logits, target = logits_target
    w = WEIGHT if weighted else None
    want = jlosses.focal_cross_entropy(jnp.asarray(logits), jnp.asarray(target),
                                       gamma=gamma, ignore_index=ignore_index,
                                       weight=None if w is None else jnp.asarray(w))
    got = tlosses.focal_cross_entropy(torch.tensor(logits), torch.tensor(target),
                                      gamma=gamma, ignore_index=ignore_index,
                                      weight=None if w is None else torch.tensor(w))
    _close(got, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_soft_cross_entropy_matches_jax(logits_target, weighted):
    logits, _ = logits_target
    q = np.random.default_rng(1).dirichlet(np.ones(K), logits.shape[:-1]).astype(np.float32)
    w = WEIGHT if weighted else None
    want = jlosses.soft_cross_entropy(jnp.asarray(logits), jnp.asarray(q),
                                      weight=None if w is None else jnp.asarray(w))
    got = tlosses.soft_cross_entropy(torch.tensor(logits), torch.tensor(q),
                                     weight=None if w is None else torch.tensor(w))
    _close(got, want)


@pytest.mark.parametrize("smoothing", [0.1, 0.3])
@pytest.mark.parametrize("background", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_smooth_cross_entropy_2d_matches_jax(logits_target, smoothing, background,
                                             weighted):
    logits, target = logits_target
    w = WEIGHT if weighted else None
    want = jlosses.smooth_cross_entropy_2d(
        jnp.asarray(logits), jnp.asarray(target), label_smoothing=smoothing,
        background_treatment=background, weight=None if w is None else jnp.asarray(w))
    got = tlosses.smooth_cross_entropy_2d(
        torch.tensor(logits), torch.tensor(target), label_smoothing=smoothing,
        background_treatment=background, weight=None if w is None else torch.tensor(w))
    _close(got, want)


@pytest.mark.parametrize("ignore_index", [-100, 2])
def test_recall_cross_entropy_matches_jax(logits_target, ignore_index):
    logits, target = logits_target
    want = jlosses.recall_cross_entropy(jnp.asarray(logits), jnp.asarray(target), K,
                                        ignore_index=ignore_index)
    got = tlosses.recall_cross_entropy(torch.tensor(logits), torch.tensor(target), K,
                                       ignore_index=ignore_index)
    _close(got, want)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_still_matches_jax(logits_target, smoothing):
    logits, target = logits_target
    want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(target),
                                 weight=jnp.asarray(WEIGHT), label_smoothing=smoothing)
    got = tlosses.cross_entropy(torch.tensor(logits), torch.tensor(target),
                                weight=torch.tensor(WEIGHT), label_smoothing=smoothing)
    _close(got, want)


@pytest.mark.parametrize("connectivity", [4, 8])
def test_boundary_classes_match_jax(connectivity):
    """Labels in [-1, K]: the ones outside [0, K) belong to no class."""
    rng = np.random.default_rng(connectivity)
    y = np.repeat(rng.integers(-1, K + 1, (3, 6, 5)), 2, 1)
    y = np.repeat(y, 2, 2).astype(np.int32)       # (3, 12, 10), blobs of 2x2
    want_d = jboundary.dilate_classes(jnp.asarray(y), K, connectivity)
    got_d = tboundary.dilate_classes(torch.tensor(y), K, connectivity)
    assert got_d.dtype == torch.int32 and got_d.shape == (3, 12, 10, K)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    want = jboundary.boundary_mask(jnp.asarray(y), K, connectivity)
    got = tboundary.boundary_mask(torch.tensor(y), K, connectivity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < got.numel()
