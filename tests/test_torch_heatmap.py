"""DETRHOIhm's verb heatmap targets and loss against the JAX package's, on
the CPU: the numpy primitives of `data/heatmap.py` (`gaussian_radius`,
`gaussian2d`, `draw_umich_gaussian` at the map's edges and inside it,
`make_verb_heatmap`) equal to the JAX ones, and
`SetCriterionHOI.loss_verb_hm` within 1e-5 relative of the JAX criterion's
on heatmaps with padding, GT maps of another size than the prediction's, and
an image whose resized GT holds no peak of 1 (the negatives-only branch).
`HICODataset(build_verb_hm=True)`'s targets are held against the JAX
dataset's in `tests/test_torch_hico_data.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlipv2_tpu.config import LossConfig as JaxLossConfig
from rlipv2_tpu.data import heatmap as jax_heatmap
from rlipv2_tpu.losses.criterion import SetCriterionHOI as JaxCriterion
from rlipv2_tpu_torch.config import LossConfig
from rlipv2_tpu_torch.data import heatmap
from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI

torch.set_num_threads(2)


@pytest.mark.parametrize("size", [(0, 0), (1, 3), (7, 4), (40, 25), (120.0, 3.5)])
def test_gaussian_radius_matches_jax(size):
    assert heatmap.gaussian_radius(size) == jax_heatmap.gaussian_radius(size)
    assert heatmap.gaussian_radius(size, 0.3) == jax_heatmap.gaussian_radius(size, 0.3)


@pytest.mark.parametrize("shape,sigma", [((1, 1), 1 / 6), ((5, 5), 5 / 6), ((13, 13), 13 / 6), ((3, 7), 1.0)])
def test_gaussian2d_matches_jax(shape, sigma):
    np.testing.assert_array_equal(heatmap.gaussian2d(shape, sigma), jax_heatmap.gaussian2d(shape, sigma))


@pytest.mark.parametrize("center,radius", [((0, 0), 3), ((19, 14), 4), ((7, 5), 0), ((10, 3), 6), ((2, 13), 2)])
def test_draw_umich_gaussian_matches_jax(center, radius):
    """On a map that already holds a peak, so the max-blend shows; centres
    at the corners crop the gaussian."""
    base = np.zeros((15, 20), np.float32)
    jax_heatmap.draw_umich_gaussian(base, (9, 6), 3, k=0.7)
    got, want = base.copy(), base.copy()
    heatmap.draw_umich_gaussian(got, center, radius)
    jax_heatmap.draw_umich_gaussian(want, center, radius)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 6])
def test_make_verb_heatmap_matches_jax(n):
    rng = np.random.RandomState(n)
    xy = rng.uniform(0, 90, (2, n, 2))
    wh = rng.uniform(2, 40, (2, n, 2))
    sub, obj = (np.concatenate([xy[i], xy[i] + wh[i]], -1).astype(np.float32) for i in range(2))
    got = heatmap.make_verb_heatmap(sub, obj, (100, 120))
    want = jax_heatmap.make_verb_heatmap(sub, obj, (100, 120))
    assert got.shape == (1, 100, 120) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got.max() == 1.0) == (n > 0)


def hm_case(seed=0):
    """Predictions (3, 1, 7, 9) with image 1 padded to 5 x 6 and image 2
    to 4 x 9, GT maps (3, 1, 20, 26) with gaussian peaks; image 2's GT is
    scaled below 1, so its resized map holds no positive."""
    rng = np.random.RandomState(seed)
    pred = rng.uniform(0.0, 1.0, (3, 1, 7, 9)).astype(np.float32)
    pad = np.zeros((3, 7, 9), bool)
    pad[1, 5:, :] = pad[1, :, 6:] = True
    pad[2, 4:, :] = True
    gt = np.zeros((3, 1, 20, 26), np.float32)
    for b, centres in enumerate([((3, 4), (20, 12)), ((10, 10),), ((6, 2),)]):
        for c in centres:
            heatmap.draw_umich_gaussian(gt[b, 0], c, 3)
    gt[2] *= 0.9
    return pred, pad, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_verb_hm_matches_jax(seed):
    pred, pad, gt = hm_case(seed)
    got = SetCriterionHOI(LossConfig()).loss_verb_hm({"verb_hm": (torch.from_numpy(pred), torch.from_numpy(pad))},
                                                     torch.from_numpy(gt))
    want = JaxCriterion(JaxLossConfig()).loss_verb_hm({"verb_hm": (jnp.asarray(pred), jnp.asarray(pad))},
                                                      jnp.asarray(gt))
    assert set(got) == set(want) == {"loss_verb_hm"}
    np.testing.assert_allclose(float(got["loss_verb_hm"]), float(want["loss_verb_hm"]), rtol=1e-5)
    # the negatives-only image alone, and the padded region out of the loss
    one = SetCriterionHOI(LossConfig()).loss_verb_hm(
        {"verb_hm": (torch.from_numpy(pred[2:]), torch.from_numpy(pad[2:]))}, torch.from_numpy(gt[2:]))
    moved = pred[2:].copy()
    moved[:, :, 4:] = 0.5
    same = SetCriterionHOI(LossConfig()).loss_verb_hm(
        {"verb_hm": (torch.from_numpy(moved), torch.from_numpy(pad[2:]))}, torch.from_numpy(gt[2:]))
    assert float(one["loss_verb_hm"]) > 0 and float(same["loss_verb_hm"]) == float(one["loss_verb_hm"])
