"""The port's R-Tagger training against the JAX package's, in float32 on the
CPU: `prepare_tagger_queries` without noise; the noise apart (bounds, the
flip rate, the same draws from the same generator state), since draws
cannot match across frameworks; `tagger_losses`, BCE and focal, on the same
arrays; and `VGRelTaggerDataset` items against the JAX dataset's on one
tree and seed. The tagger model's forward, loss and gradients are held to
JAX in `test_torch_parsed.py`, which compiles the JAX model once for the
forward and the tagger step."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlipv2_tpu.config import LossConfig as JaxLossConfig
from rlipv2_tpu.data import vg as jax_vg
from rlipv2_tpu.data.transforms import HOITransform as JaxHOITransform
from rlipv2_tpu.losses.criterion import SetCriterionHOI as JaxCriterion
from rlipv2_tpu.models.tagger import prepare_tagger_queries as jax_prepare_tagger_queries
from rlipv2_tpu_torch.config import LossConfig, TrainConfig
from rlipv2_tpu_torch.data import vg
from rlipv2_tpu_torch.data.transforms import HOITransform
from rlipv2_tpu_torch.engine.optim import build_optimizer
from rlipv2_tpu_torch.engine.train import make_train_step
from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
from rlipv2_tpu_torch.models.parsed import RLIPParSeD
from rlipv2_tpu_torch.models.tagger import noise_boxes, noise_labels, prepare_tagger_queries
from test_torch_hico_data import assert_pixels_close
from test_torch_parsed import jax_targets, parsed_config, torch_targets, write_tagger_tree

torch.set_num_threads(2)

TARGET_KEYS = ("orig_size", "obj_labels", "sub_labels", "verb_labels", "sub_boxes", "obj_boxes")


def random_targets(rng, B, M, T_obj, T_verb, n_valid):
    valid = np.zeros((B, M), bool)
    for b, n in enumerate(n_valid):
        valid[b, :n] = True
    c = rng.uniform(0.2, 0.8, (2, B, M, 2))
    wh = rng.uniform(0.05, 0.4, (2, B, M, 2))
    boxes = np.concatenate([c, wh], -1).astype(np.float32) * valid[None, ..., None]
    boxes[1, 0, 1] = 0.0  # a pair with no object box
    return {"obj_labels": rng.randint(0, T_obj - 1, (B, M)) * valid,
            "sub_labels": rng.randint(0, T_obj - 1, (B, M)) * valid,
            "verb_labels": ((rng.rand(B, M, T_verb) < 0.3) * valid[..., None]).astype(np.float32),
            "sub_boxes": boxes[0], "obj_boxes": boxes[1], "valid": valid}


def test_prepare_tagger_queries_without_noise_matches_jax():
    """Noise scales 0 (JAX training=False): anchors, label queries and slot mask as the JAX
    function gives them, an empty image's slot 0 kept attended."""
    rng = np.random.RandomState(0)
    t = random_targets(rng, 3, 6, 5, 4, n_valid=(4, 6, 0))
    emb = rng.randn(3, 5, 16).astype(np.float32)
    got = prepare_tagger_queries(torch.from_numpy(emb), torch_targets(t), None, 0.0, 0.0)
    want = jax.jit(functools.partial(jax_prepare_tagger_queries, training=False))(
        jnp.asarray(emb), jax_targets(t), jax.random.PRNGKey(0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7, rtol=0)
    assert got[4][2].tolist() == [True] + [False] * 5
    with pytest.raises(ValueError, match="explicit generator"):  # never the global generator
        prepare_tagger_queries(torch.from_numpy(emb), torch_targets(t), None, 0.6, 0.3)


def test_noise_bounds_rate_and_determinism():
    """Boxes stay in [0, 1] and within diff * scale of the input; a label
    flips to a uniform class with probability `scale` (a flip may land on
    the label itself); one generator state gives the same draws."""
    rng = np.random.RandomState(1)
    boxes = torch.from_numpy(np.concatenate([rng.uniform(0.1, 0.9, (4000, 2)), rng.uniform(0.05, 0.6, (4000, 2))],
                                            -1).astype(np.float32))
    gen = torch.Generator().manual_seed(7)
    noised = noise_boxes(boxes, gen, 0.6)
    diff = torch.cat([boxes[:, 2:] / 2, boxes[:, 2:]], -1)
    assert noised.min() >= 0 and noised.max() <= 1
    assert bool(((noised - boxes).abs() <= diff * 0.6 + 1e-6).all())
    assert float((noised - boxes).abs().max()) > 0.1
    labels = torch.zeros(20000, dtype=torch.long)
    flipped = noise_labels(labels, gen, 0.3, num_classes=10)
    rate = float((flipped != labels).float().mean())
    assert abs(rate - 0.3 * 9 / 10) < 0.015, rate
    assert int(flipped.max()) == 9
    state = gen.get_state()
    a = noise_boxes(boxes, gen, 0.6), noise_labels(labels, gen, 0.3, 10)
    gen.set_state(state)
    b = noise_boxes(boxes, gen, 0.6), noise_labels(labels, gen, 0.3, 10)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert noise_boxes(boxes, gen, 0.0) is boxes and noise_labels(labels, gen, 0.0, 10) is labels


@pytest.mark.parametrize("verb_loss_type", ["bce", "focal"])
def test_tagger_losses_match_jax(verb_loss_type):
    rng = np.random.RandomState(2)
    B, M, TO, TV = 2, 6, 5, 4
    t = random_targets(rng, B, M, TO, TV, n_valid=(4, 6))
    t["obj_labels"][0, 2] = TO - 1  # a no-object label: eos_coef
    out = {"pred_obj_logits": rng.randn(B, M, TO), "pred_sub_logits": rng.randn(B, M, TO),
           "pred_verb_logits": rng.randn(B, M, TV), "pred_sub_boxes": rng.uniform(0.2, 0.7, (B, M, 4)),
           "pred_obj_boxes": rng.uniform(0.2, 0.7, (B, M, 4))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    obj_valid = np.ones((B, TO), bool)
    obj_valid[1, 1] = False
    verb_valid = np.ones((B, TV), bool)
    verb_valid[0, 3] = False
    got = SetCriterionHOI(LossConfig(verb_loss_type=verb_loss_type), tagger=True).tagger_losses(
        {k: torch.from_numpy(v) for k, v in out.items()}, torch_targets(t), torch.from_numpy(obj_valid),
        torch.from_numpy(verb_valid))
    want = jax.jit(JaxCriterion(JaxLossConfig(verb_loss_type=verb_loss_type), subject_class=True).tagger_losses)(
        {k: jnp.asarray(v) for k, v in out.items()}, jax_targets(t), jnp.asarray(obj_valid), jnp.asarray(verb_valid))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


# --------------------------------------------------------------- the datasets


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tagger_tree(tmp_path_factory.mktemp("vgtag"))


@pytest.mark.parametrize("num_queries", [8, 40, 400])
def test_tagger_dataset_items_match_jax(tree, num_queries):
    """Items of one tree and seed, in the three regimes: more positives
    than slots (sampled), enough boxes to fill every slot (negatives
    sampled), too few pairs (every negative); `random.Random` draws the
    same in both packages."""
    folders = {"vg": tree["vg_folder"]}
    got = vg.VGRelTaggerDataset(tree["vg_anno"], folders, num_queries=num_queries, seed=3, device="cpu",
                                transforms=HOITransform(True, rng=random.Random(9)))
    want = jax_vg.VGRelTaggerDataset(tree["vg_anno"], folders, num_queries=num_queries, seed=3,
                                     transforms=JaxHOITransform(True, rng=random.Random(9), normalize=False))
    assert len(got) == len(want) > 0
    n_neg = 0
    for i in range(len(want)):
        (gi, gt), (wi, wt) = got[i], want[i]
        assert set(gt) == set(wt)
        for k in TARGET_KEYS:
            assert gt[k].dtype == wt[k].dtype, k
            np.testing.assert_allclose(gt[k], wt[k], atol=1e-5, rtol=0, err_msg=k)
        assert len(gt["obj_labels"]) <= num_queries // 2
        n_neg += int((gt["verb_labels"].sum(1) == 0).sum())
        assert_pixels_close(gi, np.asarray(wi))
    assert (n_neg > 0) == (num_queries > 8)  # 4 slots hold positives only
    assert got.pair_rng.getstate() == want._rng.getstate()


def test_tagger_step_needs_a_tagger_model():
    """The tagger step and `forward_tagger` refuse a model built without the
    tagger's parameters; the step needs its two noise scales."""
    model = RLIPParSeD(parsed_config())
    opt, sched = build_optimizer(model, TrainConfig())
    with pytest.raises(ValueError, match="tagger=True"):
        make_train_step(model, SetCriterionHOI(LossConfig(), tagger=True), opt, sched, TrainConfig(), tagger=True)
    with pytest.raises(ValueError, match="tagger=True"):
        model.forward_tagger(*(None,) * 8)
    tagger = RLIPParSeD(parsed_config(), tagger=True)
    opt, sched = build_optimizer(tagger, TrainConfig())
    with pytest.raises(ValueError, match="box_noise_scale"):
        make_train_step(tagger, SetCriterionHOI(LossConfig(), tagger=True), opt, sched, TrainConfig(), tagger=True)
