"""The port's matcher and SetCriterionHOI against the JAX package's, float32
on the CPU, on the same numpy inputs: padded target slots, an image with no
target, a no-object pair (all-zero object box), padded object and verb text
slots, and two aux layers; the RPL soft verb labels and the online and
offline pseudo-verb targets; RLIPv2's triplet filtering; every verb and
object loss type, the curing factor, the recon losses and the exponential
decay, with their gradients against `jax.value_and_grad`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlipv2_tpu.config import LossConfig as JaxLossConfig
from rlipv2_tpu.losses.criterion import SetCriterionHOI as JaxCriterion
from rlipv2_tpu.losses.matcher import hoi_matching_costs as jax_costs
from rlipv2_tpu.losses.matcher import hungarian_match as jax_match
from rlipv2_tpu.losses.pseudo_verb import pseudo_verb_similarity as jax_pseudo_verb
from rlipv2_tpu.structures import HOITargets as JaxTargets
from rlipv2_tpu_torch.config import LossConfig
from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI, paired_generalized_box_iou
from rlipv2_tpu_torch.losses.matcher import hoi_matching_costs, triplet_filter
from rlipv2_tpu_torch.losses.pseudo_verb import pseudo_verb_similarity
from rlipv2_tpu_torch.ops.boxes import generalized_box_iou
from rlipv2_tpu_torch.structures import HOITargets

ATOL = RTOL = 1e-5  # float32 sums over at most a few hundred terms
# XLA's cheapest CPU code generation: each programme runs once
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
B, Q, M, TO, TV, N_AUX = 3, 12, 5, 7, 6, 2


def make_case(seed):
    rng = np.random.RandomState(seed)

    def head():
        return {
            "pred_obj_logits": rng.randn(B, Q, TO).astype(np.float32),
            "pred_verb_logits": rng.randn(B, Q, TV).astype(np.float32),
            "pred_sub_boxes": rng.uniform(0.2, 0.6, (B, Q, 4)).astype(np.float32),
            "pred_obj_boxes": rng.uniform(0.2, 0.6, (B, Q, 4)).astype(np.float32),
        }

    outputs = head()
    outputs["aux_outputs"] = [head() for _ in range(N_AUX)]
    valid = np.zeros((B, M), bool)
    valid[0, :3] = True
    valid[1, :M] = True  # the third image has no target
    obj_boxes = rng.uniform(0.2, 0.6, (B, M, 4)).astype(np.float32)
    obj_boxes[1, 2] = 0.0  # a pair without an object box
    targets = {
        "obj_labels": rng.randint(0, TO - 1, (B, M)).astype(np.int64),
        "sub_labels": np.zeros((B, M), np.int64),
        "verb_labels": (rng.rand(B, M, TV) > 0.6).astype(np.float32),
        "sub_boxes": rng.uniform(0.2, 0.6, (B, M, 4)).astype(np.float32),
        "obj_boxes": obj_boxes,
        "valid": valid,
    }
    obj_valid = np.ones((B, TO), bool)
    obj_valid[:, 4] = False  # a padded object text slot
    verb_valid = np.ones((B, TV), bool)
    verb_valid[:, -1] = False
    return outputs, targets, obj_valid, verb_valid


def to_jax(outputs, targets):
    def j(d):
        return {k: jnp.asarray(v) for k, v in d.items() if k != "aux_outputs"}

    jo = {**j(outputs), "aux_outputs": [j(a) for a in outputs.get("aux_outputs", [])]}
    return jo, JaxTargets(**{k: jnp.asarray(v) for k, v in targets.items()})


def to_torch(outputs, targets):
    def t(d):
        return {k: torch.from_numpy(v) for k, v in d.items() if k != "aux_outputs"}

    to = {**t(outputs), "aux_outputs": [t(a) for a in outputs.get("aux_outputs", [])]}
    return to, HOITargets(**{k: torch.from_numpy(v) for k, v in targets.items()})


@pytest.mark.parametrize("seed", [0, 1])
def test_matching_costs_and_matches(seed):
    outputs, targets, _, verb_valid = make_case(seed)
    jo, jt = to_jax(outputs, targets)
    to, tt = to_torch(outputs, targets)
    want = jax_costs(jo, jt, jnp.asarray(verb_valid))
    got = hoi_matching_costs(to, tt, torch.from_numpy(verb_valid))
    for name in ("total", "giou", "bbox", "verb_class", "obj_class"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    layers = [outputs, *outputs["aux_outputs"]]
    match, _, valid = SetCriterionHOI(LossConfig()).match([to_torch(o, targets)[0] for o in layers], tt,
                                                          torch.from_numpy(verb_valid))
    assert valid is tt.valid
    match = match.numpy()
    for n, o in enumerate(layers):
        want_match = np.asarray(jax_match(jax_costs(to_jax(o, targets)[0], jt, jnp.asarray(verb_valid)).total))
        # padded slots have constant cost, so only valid slots must agree
        np.testing.assert_array_equal(match[n][targets["valid"]], want_match[targets["valid"]])


def test_hungarian_match_survives_non_finite_costs():
    """NaN predictions in every layer: the criterion's Hungarian matching
    still gives each layer a one-to-one matching of the targets that count
    (with the triplet filter: the kept ones), and the losses report the
    NaN."""
    outputs, targets, obj_valid, verb_valid = make_case(0)
    to, tt = to_torch(outputs, targets)
    for head in (to, *to["aux_outputs"]):
        head["pred_sub_boxes"][0] = float("nan")
    for triplet_filtering in (False, True):
        crit = SetCriterionHOI(dataclasses.replace(LossConfig(), triplet_filtering=triplet_filtering))
        match, _, valid = crit.match([to, *to["aux_outputs"]], tt, torch.from_numpy(verb_valid))
        assert bool(valid.any())
        for n in range(1 + N_AUX):
            for b in range(B):
                picked = match[n, b][valid[b]].tolist()
                assert len(set(picked)) == len(picked)
        losses = crit(to, tt, torch.from_numpy(obj_valid), torch.from_numpy(verb_valid))
        assert not np.isfinite(float(crit.weighted_total(losses)))


def test_paired_giou_is_the_diagonal_of_pairwise():
    rng = np.random.RandomState(3)
    # sorted rows are valid xyxy boxes: x0 <= y0 <= x1 <= y1
    a = torch.from_numpy(rng.uniform(0, 1, (2, 6, 4)).astype(np.float32)).sort(-1).values
    b = torch.from_numpy(rng.uniform(0, 1, (2, 6, 4)).astype(np.float32)).sort(-1).values
    np.testing.assert_allclose(paired_generalized_box_iou(a, b).numpy(),
                               torch.diagonal(generalized_box_iou(a, b), dim1=-2, dim2=-1).numpy(),
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_criterion_losses_match_jax(seed):
    outputs, targets, obj_valid, verb_valid = make_case(seed)
    jo, jt = to_jax(outputs, targets)
    to, tt = to_torch(outputs, targets)
    want = JaxCriterion(JaxLossConfig())(jo, jt, jnp.asarray(obj_valid), jnp.asarray(verb_valid))
    crit = SetCriterionHOI(LossConfig())
    got = crit(to, tt, torch.from_numpy(obj_valid), torch.from_numpy(verb_valid))
    assert set(got) == set(want)
    assert {f"loss_verb_ce_{i}" for i in range(N_AUX)} <= set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    total = JaxCriterion(JaxLossConfig()).weighted_total(want)
    np.testing.assert_allclose(float(crit.weighted_total(got)), float(total), atol=ATOL, rtol=RTOL)


def test_criterion_gradients_reach_every_head():
    outputs, targets, obj_valid, verb_valid = make_case(0)
    to, tt = to_torch(outputs, targets)
    leaves = [to[k].requires_grad_() for k in to if k != "aux_outputs"]
    leaves += [a[k].requires_grad_() for a in to["aux_outputs"] for k in a]
    crit = SetCriterionHOI(LossConfig())
    crit.weighted_total(crit(to, tt, torch.from_numpy(obj_valid), torch.from_numpy(verb_valid))).backward()
    for x in leaves:
        assert x.grad is not None and bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().sum()) > 0


@pytest.mark.parametrize("change,tagger,error,match", [
    (dict(naive_obj_smooth=0.1), False, NotImplementedError, "ROADMAP"),
    (dict(naive_verb_smooth=0.1), False, NotImplementedError, "ROADMAP"),
    # tagger_losses reads bce or else runs focal: the JAX one ignores the rest
    (dict(verb_loss_type="asymmetric_bce"), True, ValueError, "R-Tagger"),
    (dict(verb_loss_type="softmax"), False, ValueError, "known"),
])
def test_unported_loss_variants_raise(change, tagger, error, match):
    with pytest.raises(error, match=match):
        SetCriterionHOI(dataclasses.replace(LossConfig(), **change), tagger=tagger)


# the loss variants (LossConfig changes) and the outputs each case adds:
# the verb-curing score (`curing`), the masked-entity recon states
# (`recon`), the subject head (`subject`). The verb slots are make_case's,
# the last one padded, where the contrastive default positive of each
# unmatched query adds about 5e8 to loss_verb_matching (the criterion's
# docstring) and no gradient
VARIANTS = {
    "obj_focal-verb_focal-curing-exponential": (dict(obj_loss_type="focal", exponential_loss=True),
                                                dict(curing=True)),
    "verb_bce-curing-recon-subject": (dict(verb_loss_type="bce"), dict(curing=True, recon=True, subject=True)),
    "verb_weighted_bce-obj_focal_with_tem-curing": (dict(verb_loss_type="weighted_bce",
                                                         obj_loss_type="focal_with_tem"), dict(curing=True)),
    "verb_asymmetric_bce-obj_matching_one_way-subject-exponential": (
        dict(verb_loss_type="asymmetric_bce", obj_loss_type="cross_modal_matching", matching_symmetric=False,
             exponential_loss=True, exponential_hyper=0.5), dict(curing=True, subject=True)),
    "verb_cb_focal_bce-rpl-obj_ce_with_tem-curing-recon": (
        dict(verb_loss_type="CB_focal_bce", obj_loss_type="cross_entropy_with_tem", giou_verb_label=True),
        dict(curing=True, recon=True)),
    "verb_matching-obj_matching-recon-exponential": (
        dict(verb_loss_type="cross_modal_matching", obj_loss_type="cross_modal_matching", exponential_loss=True),
        dict(recon=True)),
}


def variant_case(seed, aux, curing=False, recon=False, subject=False):
    """make_case(seed) with `aux` aux layers (the JAX trace is most of a
    case's time: the cases with the exponential decay take one, the others
    none) and the heads a variant reads, every head its own array (the
    model shares its curing score between the layers)."""
    outputs, targets, obj_valid, verb_valid = make_case(seed)
    outputs["aux_outputs"] = outputs["aux_outputs"][:aux]
    rng = np.random.RandomState(100 + seed)
    for head in (outputs, *outputs["aux_outputs"]):
        if subject:
            head["pred_sub_logits"] = rng.randn(B, Q, TO).astype(np.float32)
        if curing:
            head["curing_score"] = rng.uniform(0.05, 0.95, (B, Q, 1)).astype(np.float32)
        if recon:
            head["recon_stat"] = {
                "pred_sub_logits": rng.randn(B, Q, TO).astype(np.float32),
                "pred_obj_logits": rng.randn(B, Q, TO).astype(np.float32),
                "pred_sub_boxes": rng.uniform(0.2, 0.6, (B, Q, 4)).astype(np.float32),
                "pred_obj_boxes": rng.uniform(0.2, 0.6, (B, Q, 4)).astype(np.float32),
            }
    if subject:
        targets["sub_labels"] = rng.randint(0, TO - 1, (B, M)).astype(np.int64)
    return outputs, targets, obj_valid, verb_valid


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in tree_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in tree_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("name", VARIANTS)
def test_loss_variants_and_gradients_match_jax(name, monkeypatch):
    """Every verb and object loss type, the curing factor, the recon losses
    and `weighted_total` with the exponential decay: each term and the
    weighted total within 1e-5 relative of the JAX criterion's, and the
    total's gradient with respect to every output within 1e-5 of the
    largest |grad| of that output, `jax.grad` the oracle. Both criteria take
    the port's matching (equal to the JAX matcher's at the valid slots:
    test_matching_costs_and_matches), so that the JAX side traces no
    assignment solver."""
    import rlipv2_tpu.losses.criterion as jax_criterion

    change, heads = VARIANTS[name]
    subject = heads.get("subject", False)
    outputs, targets, obj_valid, verb_valid = variant_case(0, int(change.get("exponential_loss", False)), **heads)
    to = tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(a.dtype == np.float32), outputs)
    tt = HOITargets(**{k: torch.from_numpy(v) for k, v in targets.items()})
    crit = SetCriterionHOI(dataclasses.replace(LossConfig(), **change), subject_class=subject)
    got = crit(to, tt, torch.from_numpy(obj_valid), torch.from_numpy(verb_valid))
    got_total = crit.weighted_total(got)
    got_total.backward()

    with torch.no_grad():
        matches = crit.match([to, *to["aux_outputs"]], tt, torch.from_numpy(verb_valid))[0].numpy()
    calls = iter(range(10 ** 6))
    monkeypatch.setattr(jax_criterion, "hungarian_match",
                        lambda cost: jnp.asarray(matches[next(calls) % len(matches)], jnp.int32))
    jax_crit = JaxCriterion(JaxLossConfig(**change), subject_class=subject)
    jt = JaxTargets(**{k: jnp.asarray(v) for k, v in targets.items()})

    def loss(jo):
        losses = jax_crit(jo, jt, jnp.asarray(obj_valid), jnp.asarray(verb_valid))
        return jax_crit.weighted_total(losses), losses

    jo = tree_map(jnp.asarray, outputs)
    run = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(jo).compile(compiler_options=FAST_COMPILE)
    (want_total, want), grads = run(jo)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(got_total.detach()), float(want_total), rtol=1e-5)
    grads = dict(tree_leaves(grads))  # by path: a JAX tree's dicts come back with sorted keys
    for path, x in tree_leaves(to):
        g = np.asarray(grads.pop(path))
        # a leaf no loss reads has no .grad, and a zero JAX gradient
        got_grad = x.grad.numpy() if x.grad is not None else np.zeros_like(g)
        np.testing.assert_allclose(got_grad, g, rtol=0, atol=1e-5 * float(np.abs(g).max()), err_msg=path)
    assert not grads
    keys = {k.rsplit("_", 1)[0] if k.rsplit("_", 1)[-1].isdigit() else k for k in got}
    if heads.get("recon"):
        assert {"loss_obj_ce_recon", "loss_sub_bbox_recon", "loss_obj_giou_recon"} <= keys
    if change.get("verb_loss_type") == "cross_modal_matching":
        assert "loss_verb_matching" in keys and "loss_verb_ce" not in keys
    if change.get("obj_loss_type") == "cross_modal_matching":
        assert ("loss_sub_matching" in keys) == subject and "loss_obj_ce" not in keys
    if heads.get("curing"):  # the score reaches every verb loss but BCE's
        assert (to["curing_score"].grad is not None) == (change.get("verb_loss_type") != "bce")


@pytest.mark.parametrize("seed,costs", [
    (0, {}), (1, {}), (2, dict(set_cost_bbox=5.0, set_cost_giou=2.0)),
])
def test_triplet_filter_matches_jax(seed, costs):
    """The GTs kept equal to the JAX `_triplet_filter`'s (which drops some
    and keeps some), and every loss term, RPL on, within 1e-5 of the JAX
    criterion's, also where the matcher's weights are not the filter's."""
    outputs, targets, obj_valid, verb_valid = make_case(seed)
    targets["valid"][2, :4] = True  # more GTs, so that the filter has a spread to cut
    jo, jt = to_jax(outputs, targets)
    to, tt = to_torch(outputs, targets)
    jax_crit = JaxCriterion(JaxLossConfig(triplet_filtering=True, giou_verb_label=True, **costs))
    want_keep = np.asarray(jax_crit._triplet_filter(jo, jt, jnp.asarray(obj_valid), jnp.asarray(verb_valid)).valid)
    crit = SetCriterionHOI(dataclasses.replace(LossConfig(triplet_filtering=True, giou_verb_label=True), **costs))
    before = dict(triplet_filter.counts)
    _, _, keep = crit.match([to, *to["aux_outputs"]], tt, torch.from_numpy(verb_valid))
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert 0 < want_keep.sum() < targets["valid"].sum()
    assert triplet_filter.counts["valid"] - before["valid"] == targets["valid"].sum()
    assert triplet_filter.counts["kept"] - before["kept"] == want_keep.sum()
    want = jax_crit(jo, jt, jnp.asarray(obj_valid), jnp.asarray(verb_valid))
    got = crit(to, tt, torch.from_numpy(obj_valid), torch.from_numpy(verb_valid))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    unfiltered = SetCriterionHOI(LossConfig(giou_verb_label=True))(to, tt, torch.from_numpy(obj_valid),
                                                                   torch.from_numpy(verb_valid))
    assert float(unfiltered["loss_sub_bbox"]) != float(got["loss_sub_bbox"])


def verb_features(seed, n=TV, d=16):
    """Verb text features with near and far pairs, so the 0.3 threshold
    keeps some similarities and drops others."""
    rng = np.random.RandomState(seed)
    base = rng.randn(3, d).astype(np.float32)
    return (base[rng.randint(0, 3, n)] + 0.5 * rng.randn(n, d)).astype(np.float32)


def pseudo_verb_float64(feats, labels, verb_valid, metric):
    """The pseudo-verb targets in float64 numpy, distances by differences."""
    f, valid = feats.astype(np.float64), verb_valid[0]
    pair = valid[None] & valid[:, None]
    if metric == "euclidean":
        dist = np.sqrt(((f[:, None] - f[None]) ** 2).sum(-1))
        sim = np.where(pair, dist, -np.inf).max(-1, keepdims=True) - dist
    else:
        fn = f / np.linalg.norm(f, axis=-1, keepdims=True)
        sim = fn @ fn.T
    tvs = np.einsum("bmv,vw->bmw", labels, np.where(pair, sim, 0.0))
    tvs = np.where(labels.sum(-1, keepdims=True) > 0, tvs / np.maximum(tvs.max(-1, keepdims=True), 1e-12), tvs)
    tvs = np.where(labels > 0, 0.0, tvs)
    return tvs * (tvs > 0.3)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_pseudo_verb_similarity_matches_jax(metric):
    """Within 1e-5 of a float64 evaluation, and within 1e-3 of the JAX
    function: its float32 distances by |a|^2 + |b|^2 - 2ab lose up to
    2.2e-4 here to cancellation (measured against the float64 values);
    the port's are within 2e-7 of them."""
    _, targets, _, verb_valid = make_case(0)
    feats = verb_features(1)
    want = np.asarray(jax_pseudo_verb(jnp.asarray(feats), jnp.asarray(targets["verb_labels"]),
                                      jnp.asarray(verb_valid), metric=metric))
    got = pseudo_verb_similarity(torch.from_numpy(feats), torch.from_numpy(targets["verb_labels"]),
                                 torch.from_numpy(verb_valid), metric=metric).numpy()
    exact = pseudo_verb_float64(feats, targets["verb_labels"], verb_valid, metric)
    assert 0 < np.count_nonzero(exact) < exact.size  # the threshold keeps some and drops some
    np.testing.assert_array_equal(got > 0, exact > 0)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("pseudo", [None, "euclidean", "cosine"])
def test_rpl_and_pseudo_verb_losses_match_jax(pseudo):
    """giou_verb_label (RPL) alone, and with the online (Euclidean) and
    offline (cosine) pseudo-verb targets, every term within rtol 1e-4."""
    outputs, targets, obj_valid, verb_valid = make_case(1)
    jo, jt = to_jax(outputs, targets)
    to, tt = to_torch(outputs, targets)
    sim = None
    if pseudo is not None:
        sim = np.array(jax_pseudo_verb(jnp.asarray(verb_features(2)), jnp.asarray(targets["verb_labels"]),
                                         jnp.asarray(verb_valid), metric=pseudo))
        assert np.any(sim > 0)
    kw = dict(giou_verb_label=True)
    want = JaxCriterion(JaxLossConfig(**kw), pseudo_verb=pseudo is not None)(
        jo, jt, jnp.asarray(obj_valid), jnp.asarray(verb_valid),
        target_verb_sim=None if sim is None else jnp.asarray(sim))
    crit = SetCriterionHOI(LossConfig(**kw), pseudo_verb=pseudo is not None)
    got = crit(to, tt, torch.from_numpy(obj_valid), torch.from_numpy(verb_valid),
               target_verb_sim=None if sim is None else torch.from_numpy(sim))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    plain = SetCriterionHOI(LossConfig())(to, tt, torch.from_numpy(obj_valid), torch.from_numpy(verb_valid))
    assert abs(float(got["loss_verb_ce"]) - float(plain["loss_verb_ce"])) > 1e-3  # RPL changes the verb loss
