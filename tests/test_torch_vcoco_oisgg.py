"""The port's V-COCO and Open Images v6 SGG paths against the JAX package's,
on the CPU, on trees that `tools/vcoco_oisgg_tree.py` writes over PNGs:

  * V-COCO and OI-SGG items: val boxes, labels and `hois` (with V-COCO's
    -1 objects) and train targets, item by item from one seeded rng each
    side; a subject-only V-COCO pair trains with the no-object label and
    an all-zero object box;
  * the built train batch puts that pair on the no-object slot
    (`max_obj_texts - 1`), where the JAX batch builder raises IndexError,
    and the port's matcher and criterion on that batch equal the JAX ones
    on the same arrays;
  * `VCOCOEvaluator`, `OISGGEvaluator` (NMS on and off, top-50 and
    top-100), `score_wtd`, `VCOCOOfficialEval` (scenarios 1 and 2, agent
    AP), `detections_from_results` and `build_vcocodb` against the JAX
    functions on seeded predictions, within 1e-9;
  * `postprocess_sgg` against the JAX function within 1e-6;
  * `evaluate_vcoco` and `evaluate_sgg` of the tiny model against the JAX
    loops and model: per-image results within 2e-3, and equal stats when
    both evaluators get the same results.
"""

import json
import random
import sys
import types
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rlipv2_tpu.config import LossConfig as JaxLossConfig
from rlipv2_tpu.data.oi_sgg import build_oi_sgg as jax_build_oi_sgg
from rlipv2_tpu.data.pipeline import build_train_batch as jax_build_train_batch
from rlipv2_tpu.data.transforms import HOITransform as JaxHOITransform
from rlipv2_tpu.data.vcoco import build_vcoco as jax_build_vcoco
from rlipv2_tpu.engine import loops as jax_loops
from rlipv2_tpu.eval import oi_sgg_eval as jax_oi_sgg_eval
from rlipv2_tpu.eval import vcoco_eval as jax_vcoco_eval
from rlipv2_tpu.eval import vsrl_eval as jax_vsrl_eval
from rlipv2_tpu.eval.postprocess import postprocess_sgg as jax_postprocess_sgg
from rlipv2_tpu.losses.criterion import SetCriterionHOI as JaxCriterion
from rlipv2_tpu.losses.matcher import hoi_matching_costs as jax_costs
from rlipv2_tpu.losses.matcher import hungarian_match as jax_match
from rlipv2_tpu.models.parseda import RLIPParSeDA as JaxRLIPParSeDA
from rlipv2_tpu_torch.config import LossConfig
from rlipv2_tpu_torch.data.oi_sgg import build_oi_sgg
from rlipv2_tpu_torch.data.pipeline import build_train_batch
from rlipv2_tpu_torch.data.synthetic import hash_tokenize
from rlipv2_tpu_torch.data.transforms import HOITransform
from rlipv2_tpu_torch.data.vcoco import build_vcoco
from rlipv2_tpu_torch.engine import loops
from rlipv2_tpu_torch.eval import vsrl_eval
from rlipv2_tpu_torch.eval.oi_sgg_eval import OISGGEvaluator, score_wtd
from rlipv2_tpu_torch.eval.postprocess import postprocess_sgg
from rlipv2_tpu_torch.eval.vcoco_eval import VCOCO_VERB_CLASSES, VCOCOEvaluator
from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
from rlipv2_tpu_torch.tools.vcoco_oisgg_tree import OI_OBJECTS, OI_RELATIONS, write_oisgg_tree, write_vcoco_tree
from test_torch_hico_data import SIZES, assert_pixels_close, smooth_image
from test_torch_losses import to_jax, to_torch
from test_torch_parseda import _tiny_pair

torch.set_num_threads(2)  # the test workers share the host's cores

EVAL_ATOL = 1e-9  # host evaluators in float64: the same operations in the same order
EVAL_BUCKET = (100, 100)  # the small val transform's images fit it


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A V-COCO and an OI-SGG tree over PNGs written by PIL."""
    root = tmp_path_factory.mktemp("vcoco_oisgg")
    src = []
    for i, (h, w) in enumerate(SIZES):
        path = root / f"src_{i}.png"
        Image.fromarray(smooth_image(20 + i, h, w)).save(path)
        src.append((path, h, w))
    write_vcoco_tree(root / "vcoco", src * 3, src * 2, seed=3)
    write_oisgg_tree(root / "oi", src * 3, src * 2, seed=4)
    return root


def builders(trees, name):
    if name == "vcoco":
        return (lambda split, **kw: build_vcoco(split, trees / "vcoco", device="cpu", **kw),
                lambda split, **kw: jax_build_vcoco(split, trees / "vcoco"))
    return (lambda split, **kw: build_oi_sgg(split, trees / "oi", device="cpu", **kw),
            lambda split, **kw: jax_build_oi_sgg(split, trees / "oi"))


@pytest.mark.parametrize("name", ["vcoco", "oi_sgg"])
def test_val_items_match_jax(trees, name):
    ours, theirs = builders(trees, name)
    got, want = ours("val"), theirs("val")
    assert len(got) == len(want) == 8
    assert (got.object_text, got.verb_text) == (want.object_text, want.verb_text)
    if name == "vcoco":
        np.testing.assert_array_equal(got.correct_mat, want.correct_mat)
        assert len(got.verb_text) == 29
    else:
        assert (len(got.object_text), len(got.verb_text)) == (OI_OBJECTS, OI_RELATIONS)
    subject_only = 0
    for i in range(len(want)):
        (gi, gt), (wi, wt) = got[i], want[i]
        assert set(gt) == set(wt)
        for k in ("orig_size", "boxes", "labels", "hois"):
            np.testing.assert_array_equal(gt[k], wt[k], err_msg=k)
        assert (gt["filename"], gt["id"]) == (wt["filename"], wt["id"])
        subject_only += int((gt["hois"][:, 1] == -1).sum())
        assert_pixels_close(gi, np.asarray(wi))
    assert (subject_only > 0) == (name == "vcoco")


@pytest.mark.parametrize("name", ["vcoco", "oi_sgg"])
def test_train_items_match_jax(trees, name):
    """Item by item with one seeded rng each side: equal targets; a
    subject-only V-COCO pair has the no-object label (80) and a zero box."""
    ours, theirs = builders(trees, name)
    got = ours("train", transforms=HOITransform(True, rng=random.Random(5)))
    want = theirs("train")
    want.transforms = JaxHOITransform(True, rng=random.Random(5), normalize=False)
    assert len(got) == len(want) == 12
    no_object = 0
    for i in range(len(want)):
        (gi, gt), (wi, wt) = got[i], want[i]
        for k in ("orig_size", "obj_labels", "sub_labels", "verb_labels", "sub_boxes", "obj_boxes"):
            assert gt[k].dtype == wt[k].dtype, k
            np.testing.assert_array_equal(gt[k], wt[k], err_msg=k)
        assert gt["verb_labels"].shape[1] == (29 if name == "vcoco" else OI_RELATIONS)
        empty = gt["obj_labels"] == got.no_object_class
        assert (gt["obj_boxes"][empty] == 0).all() and (gt["obj_boxes"][~empty] != 0).any(-1).all()
        no_object += int(empty.sum())
        assert_pixels_close(gi, np.asarray(wi))
    assert (no_object > 0) == (name == "vcoco")


def test_subject_only_pair_trains_against_the_no_object_slot(trees):
    """A V-COCO batch with subject-only pairs: their label is the last
    object slot and their object box zero; the JAX builder raises on the
    same samples; the port's matches and losses on the batch's arrays equal
    the JAX matcher's and criterion's (within 1e-5)."""
    ds = build_vcoco("train", trees / "vcoco", device="cpu", transforms=HOITransform(True, rng=random.Random(1)))
    samples = [ds[i] for i in range(len(ds))]
    pick = [s for s in samples if (s[1]["obj_labels"] == ds.no_object_class).any()][:1]
    pick += [s for s in samples if len(s[1]["obj_labels"]) and s is not pick[0]][:1]
    T_OBJ, T_VERB, M, Q = 84, 32, 4, 8
    with pytest.raises(IndexError):
        jax_build_train_batch(pick, T_OBJ, T_VERB, M)
    arrays, obj_slots, _ = build_train_batch(pick, T_OBJ, T_VERB, M, rng=random.Random(0))
    valid = arrays["triplet_valid"]
    empty = valid & (arrays["obj_labels"] == T_OBJ - 1)
    assert empty.any() and obj_slots[-1] == "no objects"
    assert (arrays["obj_boxes"][empty] == 0).all() and (arrays["obj_boxes"][valid & ~empty] != 0).any(-1).all()

    rng = np.random.RandomState(0)

    def head():
        return {"pred_obj_logits": rng.randn(2, Q, T_OBJ).astype(np.float32),
                "pred_verb_logits": rng.randn(2, Q, T_VERB).astype(np.float32),
                "pred_sub_boxes": rng.uniform(0.2, 0.6, (2, Q, 4)).astype(np.float32),
                "pred_obj_boxes": rng.uniform(0.2, 0.6, (2, Q, 4)).astype(np.float32)}

    outputs = {**head(), "aux_outputs": [head()]}
    targets = {"obj_labels": arrays["obj_labels"], "sub_labels": arrays["sub_labels"],
               "verb_labels": arrays["verb_labels"], "sub_boxes": arrays["sub_boxes"],
               "obj_boxes": arrays["obj_boxes"], "valid": valid}
    obj_valid, verb_valid = arrays["obj_text_valid"], arrays["verb_text_valid"]
    jo, jt = to_jax(outputs, targets)
    to, tt = to_torch(outputs, targets)
    crit = SetCriterionHOI(LossConfig())
    match, _, _ = crit.match([to, *to["aux_outputs"]], tt, torch.from_numpy(verb_valid))
    for n, o in enumerate([outputs, *outputs["aux_outputs"]]):
        want = np.asarray(jax_match(jax_costs(to_jax(o, targets)[0], jt, jnp.asarray(verb_valid)).total))
        np.testing.assert_array_equal(match[n].numpy()[valid], want[valid])
    want = JaxCriterion(JaxLossConfig())(jo, jt, jnp.asarray(obj_valid), jnp.asarray(verb_valid))
    got = crit(to, tt, torch.from_numpy(obj_valid), torch.from_numpy(verb_valid))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-5, rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------- evaluators


def prediction_case(seed, n_images=4, n_pairs=10, n_verbs=29, n_obj=6, subject_only=True):
    """Predictions near a few GT pairs (so some match and the NMS drops
    near-duplicates), labels of several classes, GT relations with -1
    objects when `subject_only`."""
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for _ in range(n_images):
        base = rng.uniform(0, 200, (3, 2, 2))
        base = np.concatenate([base, base + rng.uniform(40, 120, (3, 2, 2))], -1)
        pick = rng.randint(0, 3, n_pairs)
        pairs = base[pick] + rng.normal(0, 4, (n_pairs, 2, 4))
        gt_labels = rng.randint(0, n_obj, 6)
        labels = np.concatenate([gt_labels[:3][pick], np.where(rng.rand(n_pairs) < 0.8, gt_labels[3:][pick],
                                                                rng.randint(0, n_obj, n_pairs))])
        scores = rng.rand(n_pairs, n_verbs)
        scores[0, :3] = scores[1, :3]  # ties
        preds.append({"labels": labels.astype(np.int64), "boxes": np.concatenate([pairs[:, 0], pairs[:, 1]]),
                      "verb_scores": scores, "sub_ids": np.arange(n_pairs),
                      "obj_ids": np.arange(n_pairs, 2 * n_pairs)})
        hois = [[k, 3 + k, rng.randint(n_verbs)] for k in range(3)] + [[k, 3 + k, rng.randint(n_verbs)]
                                                                        for k in range(2)]
        if subject_only:
            hois.append([rng.randint(3), -1, rng.randint(n_verbs)])
        gts.append({"filename": "x.png", "boxes": np.concatenate([base[:, 0], base[:, 1]]), "labels": gt_labels,
                    "hois": np.asarray(hois, np.int64)})
    return preds, gts


@pytest.mark.parametrize("seed", [0, 1])
def test_vcoco_evaluator_matches_jax(seed):
    preds, gts = prediction_case(seed)
    correct = (np.random.RandomState(seed).rand(29, 6) < 0.8).astype(np.float64)
    got = VCOCOEvaluator(preds, gts, correct).evaluate()
    want = jax_vcoco_eval.VCOCOEvaluator(preds, gts, correct).evaluate()
    assert got.keys() == want.keys() and {"mAP_all", "mAP_thesis"} <= got.keys()
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], atol=EVAL_ATOL, rtol=0)
    assert got["mAP_all"] > 0


@pytest.mark.parametrize("seed,nms", [(0, False), (0, True), (1, True)])
def test_oi_sgg_evaluator_and_score_wtd_match_jax(seed, nms):
    """Top-50 and top-100 with and without the triplet and phrase NMS: the
    kept relations, the stats and score_wtd equal the JAX evaluator's."""
    preds, gts = prediction_case(seed, n_pairs=14, n_verbs=5, subject_only=False)
    gts = [{"filename": g["filename"], "boxes": g["boxes"], "labels": g["labels"], "rels": g["hois"]} for g in gts]
    results = []
    for topk in (50, 100):
        got = OISGGEvaluator(preds, gts, topk=topk, use_nms_filter=nms)
        want = jax_oi_sgg_eval.OISGGEvaluator(preds, gts, topk=topk, use_nms_filter=nms)
        for key in ("rel_predictions", "phrase_predictions"):
            assert [[(r["subject_id"], r["object_id"], r["category_id"]) if "subject_id" in r else r["category_id"]
                     for r in p[key]] for p in got.preds] == \
                   [[(r["subject_id"], r["object_id"], r["category_id"]) if "subject_id" in r else r["category_id"]
                     for r in p[key]] for p in want.preds], key
        if nms:
            assert sum(len(p["rel_predictions"]) for p in got.preds) < len(preds) * min(topk, 70)
        g, w = got.evaluate(), want.evaluate()
        assert g.keys() == w.keys()
        np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], atol=EVAL_ATOL, rtol=0)
        results.append((g, w))
    (g50, w50), (g100, w100) = results
    got, want = score_wtd(g50, g100), jax_oi_sgg_eval.score_wtd(w50, w100)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], atol=EVAL_ATOL, rtol=0)
    assert g100["mAP@100 (RelD)"] > 0


def official_layout():
    """The official V-COCO actions and roles, from the HOIA verb names."""
    roles: dict = {}
    for v in VCOCO_VERB_CLASSES:
        parts = v.rsplit("_", 1)
        if parts[-1] in ("obj", "instr"):
            roles.setdefault(parts[0], ["agent"]).append(parts[1])
        else:
            roles.setdefault(v, ["agent"])
    return list(roles), list(roles.values())


@pytest.mark.parametrize("seed", [0, 1])
def test_official_vcoco_eval_matches_jax(seed):
    """Scenario 1 and 2 role AP and agent AP of detections made by
    `detections_from_results` (a missing object class gives a NaN role
    box), with unannotated persons and persons without a role object."""
    actions, roles = official_layout()
    assert len(actions) == 26 and sum(len(r) - 1 for r in roles) == 25
    rng = np.random.RandomState(seed)
    preds, gts = prediction_case(seed, n_pairs=8)
    vcocodb, image_ids = [], []
    for i, (p, g) in enumerate(zip(preds, gts)):
        classes = np.array([1, 1, 1] + list(rng.randint(2, 9, 3)), np.int32)
        actions_of = rng.randint(0, 2, (6, len(actions))).astype(np.int32)
        actions_of[3:] = -1
        actions_of[2, :] = -1 if i % 2 else actions_of[2, :]
        role_id = -np.ones((6, len(actions), 2), np.int32)
        for a in range(len(actions)):
            for r in range(len(roles[a]) - 1):
                role_id[:3, a, r] = np.where(rng.rand(3) < 0.7, rng.randint(3, 6, 3), -1)
        vcocodb.append({"id": 100 + i, "boxes": g["boxes"].astype(np.float32), "gt_classes": classes,
                        "gt_actions": actions_of, "gt_role_id": role_id})
        p["labels"][p["obj_ids"][:2]] = 80  # the missing category: NaN role boxes
        image_ids.append(100 + i)
    correct = (rng.rand(29, 80) < 0.8).astype(np.float64)
    for cm in (None, correct):
        got_dets = vsrl_eval.detections_from_results(image_ids, preds, VCOCO_VERB_CLASSES, correct_mat=cm)
        want_dets = jax_vsrl_eval.detections_from_results(image_ids, preds, VCOCO_VERB_CLASSES, correct_mat=cm)
        assert len(got_dets) == len(want_dets) == sum(len(p["sub_ids"]) for p in preds)
        for a, b in zip(got_dets, want_dets):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k], np.float64), np.asarray(b[k], np.float64), err_msg=k)
        got = vsrl_eval.VCOCOOfficialEval(vcocodb, actions, roles).evaluate(got_dets)
        want = jax_vsrl_eval.VCOCOOfficialEval(vcocodb, actions, roles).evaluate(want_dets)
        assert got.keys() == want.keys() == {"agent_ap", "avg_agent_ap", "role_ap_scenario_1", "AP_scenario_1",
                                             "role_ap_scenario_2", "AP_scenario_2"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=EVAL_ATOL, rtol=0, equal_nan=True, err_msg=k)
        assert got["AP_scenario_1"] > 0 and got["AP_scenario_2"] >= got["AP_scenario_1"]
        s1 = vsrl_eval.VCOCOOfficialEval(vcocodb, actions, roles).role_eval(got_dets, scenario=1)
        np.testing.assert_allclose(s1["avg_role_ap_no_point"], jax_vsrl_eval.VCOCOOfficialEval(
            vcocodb, actions, roles).role_eval(want_dets, scenario=1)["avg_role_ap_no_point"], atol=EVAL_ATOL)


class _COCOIndex:
    """pycocotools' COCO lookups that the JAX `build_vcocodb` calls, over the
    instances file (pycocotools is not installed here)."""

    def __init__(self, path):
        with open(path) as f:
            self.dataset = json.load(f)
        self.imgs = {i["id"]: i for i in self.dataset["images"]}
        self.anns = {a["id"]: a for a in self.dataset["annotations"]}
        self.img_to_anns = defaultdict(list)
        for a in self.dataset["annotations"]:
            self.img_to_anns[a["image_id"]].append(a["id"])

    def getCatIds(self):
        return [c["id"] for c in self.dataset["categories"]]

    def loadImgs(self, ids):
        return [self.imgs[i] for i in ids]

    def getAnnIds(self, imgIds, iscrowd=None):
        return list(self.img_to_anns[imgIds])

    def loadAnns(self, ids):
        return [self.anns[i] for i in ids]


def test_build_vcocodb_matches_jax(tmp_path, monkeypatch):
    """The GT database from V-COCO, COCO and split files: the port reads the
    COCO file itself; the JAX function, through pycocotools' lookups."""
    rng = np.random.RandomState(0)
    images = [{"id": 10 + i, "width": 200, "height": 150} for i in range(3)]
    anns, next_id = [], 1
    for img in images:
        for k in range(5):
            x, y = rng.uniform(0, 150), rng.uniform(0, 100)
            anns.append({"id": next_id, "image_id": img["id"], "bbox": [x, y, rng.uniform(0, 80), rng.uniform(0, 60)],
                         "area": float(k != 4), "category_id": 1 if k < 2 else int(rng.choice([3, 18, 44])),
                         **({"ignore": 1} if k == 3 and img["id"] == 12 else {})})
            next_id += 1
    cats = [{"id": c} for c in (1, 3, 18, 44)]
    (tmp_path / "coco.json").write_text(json.dumps({"images": images, "annotations": anns[::-1],
                                                    "categories": cats}))
    persons = [a["id"] for a in anns if a["category_id"] == 1]
    vsrl = []
    for name, role in (("ride", ["agent", "instr"]), ("stand", ["agent"]), ("cut", ["agent", "instr", "obj"])):
        labels = rng.randint(0, 2, len(persons))
        objs = [[p] + [int(rng.choice([0, p + 2, p + 3])) for _ in role[1:]] for p in persons]
        vsrl.append({"action_name": name, "role_name": role, "ann_id": persons, "label": labels.tolist(),
                     "image_id": [0] * len(persons), "role_object_id": [o for col in zip(*objs) for o in col]})
    (tmp_path / "vsrl.json").write_text(json.dumps(vsrl))
    (tmp_path / "split.ids").write_text("12\n10\n")
    files = (tmp_path / "vsrl.json", tmp_path / "coco.json", tmp_path / "split.ids")
    fake = types.ModuleType("pycocotools")
    fake.coco = types.ModuleType("pycocotools.coco")
    fake.coco.COCO = _COCOIndex
    monkeypatch.setitem(sys.modules, "pycocotools", fake)
    monkeypatch.setitem(sys.modules, "pycocotools.coco", fake.coco)
    got_db, got_actions, got_roles = vsrl_eval.build_vcocodb(*files)
    want_db, want_actions, want_roles = jax_vsrl_eval.build_vcocodb(*files)
    assert (got_actions, got_roles) == (want_actions, want_roles) and len(got_db) == len(want_db) == 2
    for g, w in zip(got_db, want_db):
        assert g.keys() == w.keys() and g["id"] == w["id"]
        for k in ("boxes", "gt_classes", "gt_actions", "gt_role_id"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert any((g["gt_role_id"] >= 0).any() for g in got_db) and any((g["gt_actions"] == 1).any() for g in got_db)


def test_postprocess_sgg_matches_jax():
    rng = np.random.RandomState(2)
    B, Q, TO, TV = 2, 6, 7, 5
    out = {"pred_obj_logits": rng.randn(B, Q, TO), "pred_sub_logits": rng.randn(B, Q, TO),
           "pred_verb_logits": rng.randn(B, Q, TV), "pred_sub_boxes": rng.uniform(0.2, 0.6, (B, Q, 4)),
           "pred_obj_boxes": rng.uniform(0.2, 0.6, (B, Q, 4))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    sizes = np.array([[480, 640], [333, 500]], np.float32)
    got = postprocess_sgg({k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(sizes))
    want = jax_postprocess_sgg({k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(sizes))
    assert got.keys() == want.keys() and {"sub_scores", "sub_labels"} <= got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6 * (640 if "boxes" in k else 1),
                                   rtol=0, err_msg=k)
    plain = loops.postprocess_hoi({k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(sizes))
    assert "sub_scores" not in plain  # without subject_class the subject head is not read


# ---------------------------------------------------------------- the loops


@pytest.fixture(scope="module")
def tiny_pair():
    return _tiny_pair("resnet_test")


@pytest.mark.parametrize("name", ["vcoco", "oi_sgg"])
def test_evaluate_loop_matches_jax(trees, tiny_pair, monkeypatch, name):
    """The port's evaluate_vcoco / evaluate_sgg with the tiny model against
    the JAX loop with the JAX model on the same val items: per-image
    results within 2e-3 (the full-model bound), and the same stats when
    both evaluators take the JAX results."""
    cfg, jm, params, jax_apply, model = tiny_pair
    val_tf = HOITransform(False, val_size=64, max_size=100)
    ours = builders(trees, name)[0]
    dataset = ours("val", transforms=val_tf)
    jax_encode = jax.jit(lambda p, i, m: jm.apply(p, i, m, method=JaxRLIPParSeDA.encode_text))

    def tokens(texts):
        return hash_tokenize(texts, cfg.text_encoder.vocab_size, maxlen=8)

    def jax_text(texts):
        ids, mask = tokens(texts)
        return np.asarray(jax_encode(params, jnp.asarray(ids), jnp.asarray(mask)))

    def torch_text(texts):
        ids, mask = tokens(texts)
        with torch.no_grad():
            return model.encode_text(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()

    evaluator = "VCOCOEvaluator" if name == "vcoco" else "OISGGEvaluator"
    jax_module = jax_vcoco_eval if name == "vcoco" else jax_oi_sgg_eval
    captured = defaultdict(list)
    for key, mod in (("jax", jax_module), ("torch", loops)):
        cls = getattr(mod, evaluator)

        def capture(preds, gts, *a, _key=key, _cls=cls, **k):
            captured[_key].append((preds, gts))
            return _cls(preds, gts, *a, **k)

        monkeypatch.setattr(mod, evaluator, capture)
    if name == "vcoco":
        want = jax_loops.evaluate_vcoco(jax_apply, params, dataset, cfg, jax_loops.CachedTextEncoder(jax_text),
                                        batch_size=4, bucket=EVAL_BUCKET)
        got = loops.evaluate_vcoco(lambda m, *a: m(*a), model, dataset, cfg, loops.CachedTextEncoder(torch_text),
                                   batch_size=4, bucket=EVAL_BUCKET)
    else:
        want = jax_loops.evaluate_sgg(jax_apply, params, dataset, cfg, jax_loops.CachedTextEncoder(jax_text),
                                      batch_size=4, bucket=EVAL_BUCKET, use_nms_filter=True)
        got = loops.evaluate_sgg(lambda m, *a: m(*a), model, dataset, cfg, loops.CachedTextEncoder(torch_text),
                                 batch_size=4, bucket=EVAL_BUCKET, use_nms_filter=True)
    assert got.keys() == want.keys()
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in got.values())
    (g_preds, g_gts), (w_preds, w_gts) = captured["torch"][0], captured["jax"][0]
    assert len(g_preds) == len(w_preds) == len(dataset)
    for g, w in zip(g_preds, w_preds):
        np.testing.assert_array_equal(g["sub_ids"], w["sub_ids"])
        np.testing.assert_allclose(g["verb_scores"], np.asarray(w["verb_scores"]), atol=2e-3, rtol=0)
        np.testing.assert_allclose(g["boxes"], np.asarray(w["boxes"]), atol=2e-3 * 100, rtol=0)
    rel = "hois" if name == "vcoco" else "rels"
    for g, w in zip(g_gts, w_gts):
        for k in ("boxes", "labels", rel):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if name == "vcoco":
        cm = dataset.correct_mat
        same = VCOCOEvaluator(w_preds, w_gts, cm).evaluate(), jax_vcoco_eval.VCOCOEvaluator(w_preds, w_gts,
                                                                                           cm).evaluate()
    else:
        same = (OISGGEvaluator(w_preds, w_gts, topk=100, use_nms_filter=True).evaluate(),
                jax_oi_sgg_eval.OISGGEvaluator(w_preds, w_gts, topk=100, use_nms_filter=True).evaluate())
    assert same[0].keys() == same[1].keys()
    np.testing.assert_allclose([same[0][k] for k in same[1]], [same[1][k] for k in same[1]], atol=EVAL_ATOL, rtol=0)
