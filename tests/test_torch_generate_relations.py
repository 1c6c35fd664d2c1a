"""The port's tagger inference against the JAX package's, on the CPU:
`CocoRelDataset` items (targets, candidates, pixels within one level) over
a seeded COCO tree of PNGs; the threshold; `deduplicate_relationships` and
`merge_tagger_segments` equal to the JAX functions; and the output read
back by `build_coco_rlip`. `generate_pseudo_annotations` against the JAX
function on the same tiny RLIP-ParSeD tagger weights, text features and
pixels (`assert_generated_match`) runs in `test_torch_parsed.py`, whose
one jit of the JAX model computes the JAX function's tagger forwards."""

import copy
import dataclasses
import json
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from rlipv2_tpu.data.coco import CocoRelDataset as JaxCocoRelDataset
from rlipv2_tpu.data.transforms import HOITransform as JaxHOITransform
from rlipv2_tpu.tools import generate_relations as jax_gen
from rlipv2_tpu_torch.data.coco import CocoRelDataset, build_coco_rlip
from rlipv2_tpu_torch.data.transforms import HOITransform
from rlipv2_tpu_torch.engine.loops import CachedTextEncoder
from rlipv2_tpu_torch.tools import generate_relations as gen
from rlipv2_tpu_torch.tools.coco_tree import write_coco_tree
from test_torch_hico_data import assert_pixels_close, smooth_image
from rlipv2_tpu_torch.models.parsed import RLIPParSeD
from rlipv2_tpu_torch.tools.main_path import random_state_dict
from test_parseda_forward import tiny_config

torch.set_num_threads(2)

IMAGE = (40, 56)  # every image one size: one JAX compile
VAL_SIZE, MAX_SIZE = 48, 80
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def write_generate_tree(root):
    """A COCO tree of eight images over three PNGs of one size."""
    src = []
    for i in range(3):
        path = root / f"src_{i}.png"
        Image.fromarray(smooth_image(40 + i, *IMAGE)).save(path)
        src.append((path, *IMAGE))
    return write_coco_tree(root / "coco", src, n_images=8, n_predicates=12, seed=1)


def generate_config():
    """The tiny RLIP-ParSeD with room for COCO's 80 object names."""
    return dataclasses.replace(tiny_config(variant="rlip_parsed_v2", subject_class=True), max_obj_texts=81,
                               max_verb_texts=8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_generate_tree(tmp_path_factory.mktemp("coco"))


def datasets(tree):
    paths = (tree["img_folder"], tree["ann_file"], tree["rel_candidates"])
    got = CocoRelDataset(*paths, transforms=HOITransform(False, val_size=VAL_SIZE, max_size=MAX_SIZE), device="cpu")
    want = JaxCocoRelDataset(*paths, transforms=JaxHOITransform(False, val_size=VAL_SIZE, max_size=MAX_SIZE,
                                                                normalize=False))
    return got, want


def test_coco_rel_items_match_jax(tree):
    """Images without candidates dropped, crowd boxes skipped, labels in
    the contiguous 80-class space, boxes normalized cxcywh."""
    got, want = datasets(tree)
    assert got.ids == want.ids and 0 < len(got) < 8 and got.object_names == want.object_names
    for i in range(len(want)):
        (gi, gt), (wi, wt) = got[i], want[i]
        assert set(gt) == set(wt)
        assert gt["relation_candidates"] == wt["relation_candidates"] and gt["image_id"] == wt["image_id"]
        np.testing.assert_array_equal(gt["labels"], wt["labels"])
        np.testing.assert_array_equal(gt["orig_size"], wt["orig_size"])
        np.testing.assert_allclose(gt["boxes"], wt["boxes"], atol=1e-6, rtol=0)
        assert_pixels_close(gi, np.asarray(wi))


def fake_text_encoder(dim: int) -> CachedTextEncoder:
    """Features seeded from each text's bytes: the same on both sides."""
    def encode(texts):
        return np.stack([np.random.RandomState(zlib.crc32(t.encode())).randn(dim).astype(np.float32)
                         for t in texts])

    return CachedTextEncoder(encode)


class JaxView:
    """The port dataset's items with the image normalized as the JAX
    tagger takes it, so both packages see the same pixels."""

    def __init__(self, ds):
        self.ds, self.object_names = ds, ds.object_names

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        img, target = self.ds[i]
        return (img.astype(np.float32) / 255.0 - MEAN) / STD, copy.deepcopy(target)


@pytest.fixture(scope="module")
def generated(tree):
    """The port's generation at threshold 0 with seeded weights (the JAX
    comparison is in `test_torch_parsed.py`, which has the JAX model)."""
    cfg = generate_config()
    model = RLIPParSeD(cfg, tagger=True)
    model.load_state_dict(random_state_dict(model), strict=True)
    model.eval()
    ds, _ = datasets(tree)
    enc = fake_text_encoder(cfg.text_encoder.hidden_size)
    got = gen.generate_pseudo_annotations(gen.tagger_apply_fn(model, cfg), ds, enc, cfg, relation_threshold=0.0,
                                          dataset_name="coco2017", batch_size=3)
    return cfg, model, ds, enc, got


def assert_generated_match(ds, got, want):
    """The same relationships, confidences within 2e-3, and the same
    objects, the port's boxes in the original image's pixels where the JAX
    function writes the resized image's."""
    assert len(got) == len(want) == len(ds)
    n_rows = sum(1 for i in range(len(ds)) for p, r in ds[i][1]["relation_candidates"] if p and r)
    assert n_rows % 3 != 0  # the last batch is wrap-padded
    for g, w in zip(got, want):
        assert (g["image_id"], g["dataset"]) == (w["image_id"], w["dataset"])
        key = [(r["subject_id"], r["object_id"], r["predicate"]) for r in w["relationships"]]
        assert [(r["subject_id"], r["object_id"], r["predicate"]) for r in g["relationships"]] == key
        np.testing.assert_allclose([r["confidence"] for r in g["relationships"]],
                                   [r["confidence"] for r in w["relationships"]], atol=2e-3, rtol=0)
        # the port writes boxes in the original image's pixels, JAX in the resized image's
        h, w_ = IMAGE
        scale = {"x": w_, "w": w_, "y": h, "h": h}
        resized = ds[[a["image_id"] for a in got].index(g["image_id"])][0].shape[:2]
        rs = {"x": resized[1], "w": resized[1], "y": resized[0], "h": resized[0]}
        assert [o["names"] for o in g["objects"]] == [o["names"] for o in w["objects"]]
        for go, wo in zip(g["objects"], w["objects"]):
            for k in "xywh":
                np.testing.assert_allclose(go[k] / scale[k], wo[k] / rs[k], atol=1e-5, err_msg=k)
    assert sum(len(a["relationships"]) for a in got) > 10


def test_threshold_keeps_the_confident_relationships(generated):
    cfg, model, ds, enc, everything = generated
    confs = sorted(r["confidence"] for a in everything for r in a["relationships"])
    thr = confs[len(confs) // 2]
    kept = gen.generate_pseudo_annotations(gen.tagger_apply_fn(model, cfg), ds, enc, cfg, relation_threshold=thr,
                                           batch_size=3)
    for a, b in zip(kept, everything):
        assert a["relationships"] == [r for r in b["relationships"] if r["confidence"] >= thr]
        assert all(thr <= r["confidence"] <= 1.0 for r in a["relationships"])


def test_output_reads_back_for_pretraining(generated, tree, tmp_path):
    """The written JSON is a VG-format file that `build_coco_rlip` reads:
    its images under coco2017/train2017, its boxes in their pixels."""
    got = generated[4]
    path = tmp_path / "pseudo.json"
    path.write_text(json.dumps(got))
    ds = build_coco_rlip(path, {"coco2017": tree["coco2017_folder"]}, num_queries=16,
                         transforms=HOITransform(False, val_size=VAL_SIZE, max_size=MAX_SIZE), relation_threshold=0.0,
                         device="cpu")
    assert 0 < len(ds) <= len(got)
    img, target = ds[0]
    assert img.shape[2] == 3 and len(target["obj_labels"]) > 0
    assert (target["sub_boxes"] >= 0).all() and (target["sub_boxes"] <= max(img.shape[:2]) + 1e-3).all()


def test_tag_image_scores_each_group_alone(generated):
    """`tag_image` runs one row a forward (JAX `tag_image`): on an image of
    the tree's single size, the same relationships as the batched path
    gives it, confidences within 1e-5."""
    cfg, model, ds, enc, everything = generated
    img, target = ds[0]
    got = gen.tag_image(gen.tagger_apply_fn(model, cfg), img, np.ones(img.shape[:2], bool), target["boxes"],
                        target["labels"], target["relation_candidates"], ds.object_names, enc, cfg,
                        relation_threshold=0.0)
    want = everything[0]["relationships"]
    assert [(r["subject_id"], r["object_id"], r["predicate"]) for r in got] == [
        (r["subject_id"], r["object_id"], r["predicate"]) for r in want] and got
    np.testing.assert_allclose([r["confidence"] for r in got], [r["confidence"] for r in want], atol=1e-5)


def _annos(rng):
    return [{"image_id": i, "objects": [], "relationships": [
        {"subject_id": int(rng.randint(3)), "object_id": int(rng.randint(3)), "predicate": f"p{rng.randint(2)}",
         "confidence": float(rng.choice([0.3, 0.5, 0.5, 0.9]))} for _ in range(12)]} for i in range(3)]


def test_deduplicate_and_merge_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    annos = _annos(rng)
    assert gen.deduplicate_relationships(copy.deepcopy(annos)) == jax_gen.deduplicate_relationships(
        copy.deepcopy(annos))
    files = []
    for k in range(2):
        files.append(tmp_path / f"seg{k}.json")
        files[-1].write_text(json.dumps(_annos(rng)))
    got = gen.merge_tagger_segments(files, "o365", tmp_path / "merged.json")
    assert got == jax_gen.merge_tagger_segments(files, "o365") == json.loads((tmp_path / "merged.json").read_text())
    assert len(got) == 6 and {a["dataset"] for a in got} == {"o365"}
