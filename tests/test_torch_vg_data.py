"""The port's VG-format pre-training data against the JAX package's, on the
CPU: VGRelDataset items (labels, boxes, multi-hot predicates, label texts,
pixels within one level) over a seeded tree of VG, pseudo-labelled COCO
and O365 files with the relation threshold and the pair-overlap filter;
the filters, drops and frequency tables; image paths of all four sources;
ConcatRelDataset's index mapping; batch_iterative_indices; and batch
building at pre-training's 500 negative texts, where the JAX pipeline
overflows the preset's text slots and the port's sized slots hold them."""

import json
import random

import numpy as np
import pytest
import torch
from PIL import Image

from rlipv2_tpu.data.pipeline import build_train_batch as jax_build_train_batch
from rlipv2_tpu.data.transforms import HOITransform as JaxHOITransform
from rlipv2_tpu.data import vg as jax_vg
from rlipv2_tpu_torch.cli import text_slots
from rlipv2_tpu_torch.config import rlip_parseda_v2_r50
from rlipv2_tpu_torch.data import vg
from rlipv2_tpu_torch.data.pipeline import build_train_batch
from rlipv2_tpu_torch.data.transforms import HOITransform
from rlipv2_tpu_torch.tools.vg_tree import write_vg_tree
from test_torch_hico_data import assert_pixels_close, smooth_image

torch.set_num_threads(2)  # the test workers share the host's cores

SIZES = ((60, 80), (80, 60), (45, 70))  # (h, w)
TARGET_KEYS = ("orig_size", "obj_labels", "sub_labels", "verb_labels", "sub_boxes", "obj_boxes")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """VG, COCO and O365 files of 6, 6 and 4 images over PNGs written by
    PIL, 120 object names and 60 predicates."""
    root = tmp_path_factory.mktemp("vg")
    src = []
    for i, (h, w) in enumerate(SIZES):
        path = root / f"src_{i}.png"
        Image.fromarray(smooth_image(20 + i, h, w)).save(path)
        src.append((path, h, w))
    out = write_vg_tree(root / "tree", src, n_images=(6, 6, 4), n_object_names=120, n_predicates=60, seed=3)
    out["root"] = root
    return out


def folders(tree):
    return {k: tree[f"{k}_folder"] for k in ("vg", "coco2017", "o365")}


def both(anno, tree, seed=7, **kw):
    got = vg.VGRelDataset(anno, folders(tree), transforms=HOITransform(True, rng=random.Random(seed)),
                          device="cpu", **kw)
    want = jax_vg.VGRelDataset(anno, folders(tree),
                               transforms=JaxHOITransform(True, rng=random.Random(seed), normalize=False), **kw)
    return got, want


def assert_items_equal(got, want):
    (gi, gt), (wi, wt) = got, want
    assert set(gt) == set(wt)
    for k in TARGET_KEYS:
        assert gt[k].dtype == wt[k].dtype, k
        np.testing.assert_array_equal(gt[k], wt[k], err_msg=k)
    assert (gt["image_id"], gt["obj_classes"], gt["verb_classes"]) == (wt["image_id"], wt["obj_classes"],
                                                                        wt["verb_classes"])
    assert_pixels_close(gi, np.asarray(wi))


@pytest.mark.parametrize("source,filters", [
    ("vg", {}), ("vg", dict(relation_threshold=0.2, pair_overlap=True)),
    ("coco", dict(relation_threshold=0.2, pair_overlap=True)), ("o365", dict(relation_threshold=0.5)),
    ("coco", dict(relation_threshold=0.2, num_queries=20)),
])
def test_items_match_jax(tree, source, filters):
    """Item by item with one seeded transform each side; the threshold,
    the overlap filter (the stored `overlap` and the boxes'), the drops,
    the truncation (num_queries=20 keeps 10 pairs) and the frequency
    tables as the JAX dataset has them."""
    got, want = both(tree[f"{source}_anno"], tree, **filters)
    assert got.annotations == want.annotations and got.ids == want.ids and len(got) == len(want) > 0
    assert got.object_names == want.object_names and got.relationship_names == want.relationship_names
    assert got.object_freq == want.object_freq and got.relationship_freq == want.relationship_freq
    for i in range(len(want)):
        assert_items_equal(got[i], want[i])


def test_filters_and_truncation_are_live(tree):
    """The tree exercises what the filters and the truncation do: the
    threshold and the overlap filter drop relationships, some of them
    through a stored `overlap`, and an image keeps more relationships than
    a small num_queries allows."""
    raw = json.loads(tree["coco_anno"].read_text())
    n_raw = sum(len(a["relationships"]) for a in raw)
    thr, _ = both(tree["coco_anno"], tree, relation_threshold=0.2)
    both_f, _ = both(tree["coco_anno"], tree, relation_threshold=0.2, pair_overlap=True)
    n_thr = sum(len(a["relationships"]) for a in thr.annotations)
    n_both = sum(len(a["relationships"]) for a in both_f.annotations)
    assert n_raw > n_thr > n_both > 0
    assert any("overlap" in r for a in raw for r in a["relationships"])
    assert any(len(a["relationships"]) > 10 for a in both_f.annotations)
    # an image whose relationships all fall to the threshold is dropped
    gone, _ = both(tree["coco_anno"], tree, relation_threshold=1.01)
    assert len(gone) == 0 and len(gone.annotations) == len(raw)


def test_image_paths_of_every_source(tree, tmp_path):
    """vg/{id}.jpg, coco2017/<split>/{id:012}.jpg, the O365 file map read
    from the folder, and a HICO file name: the same file as the
    JAX dataset opens, by its pixels."""
    hico = tmp_path / "hico"
    hico.mkdir()
    raw = json.loads(tree["vg_anno"].read_text())[:1]
    Image.fromarray(smooth_image(5, 50, 70)).save(hico / "HICO_train2015_00000001.png")
    raw[0].update(dataset="hico", image_id="HICO_train2015_00000001.png")
    (tmp_path / "hico.json").write_text(json.dumps(raw))
    dirs = {**folders(tree), "hico": hico}
    for anno in (tree["vg_anno"], tree["coco_anno"], tree["o365_anno"], tmp_path / "hico.json"):
        tf = HOITransform(False, val_size=40, max_size=80)
        got = vg.VGRelDataset(anno, dirs, transforms=tf, device="cpu")
        want = jax_vg.VGRelDataset(anno, dirs, transforms=JaxHOITransform(False, val_size=40, max_size=80,
                                                                          normalize=False))
        assert got.image_path(got.annotations[0]).exists()
        for i in range(min(len(got), 2)):
            assert_items_equal(got[i], want[i])


def test_concat_dataset_matches_jax(tree):
    """Global index -> (dataset, item), and the fused frequency tables."""
    def tf(jax):
        return JaxHOITransform(False, val_size=32, max_size=64, normalize=False) if jax else \
            HOITransform(False, val_size=32, max_size=64)

    files = [tree["vg_anno"], tree["coco_anno"], tree["o365_anno"]]
    got = vg.ConcatRelDataset([vg.VGRelDataset(f, folders(tree), transforms=tf(False), pair_overlap=True,
                                               device="cpu") for f in files])
    want = jax_vg.ConcatRelDataset([jax_vg.VGRelDataset(f, folders(tree), transforms=tf(True), pair_overlap=True)
                                    for f in files])
    assert len(got) == len(want) == sum(len(d) for d in got.datasets)
    assert got.object_names == want.object_names and got.relationship_freq == want.relationship_freq
    assert list(got.object_freq.values()) == list(want.object_freq.values())
    for i in range(len(want)):
        (_, gt), (_, wt) = got[i], want[i]
        assert gt["image_id"] == wt["image_id"]
        np.testing.assert_array_equal(gt["verb_labels"], wt["verb_labels"])
    got.close()


@pytest.mark.parametrize("sizes,paradigm,replicas", [
    ((37,), [0], 1), ((37,), [0], 3), ((20, 50), [0, 1], 1), ((20, 9), [0, 1], 2),
    ((24, 30, 11), [0, 1, 2], 1), ((24, 30, 11), [0, 1, 2], 4), ((16, 40), [0, 0, 1], 1), ((17, 40), [0, 0, 1], 2),
])
def test_batch_iterative_indices_match_jax(sizes, paradigm, replicas):
    """Every rank's batches, shuffled and in order, at several epochs."""
    for epoch in (0, 3):
        for rank in range(replicas):
            for shuffle in (True, False):
                kw = dict(num_replicas=replicas, rank=rank, shuffle=shuffle, seed=5, epoch=epoch)
                got = vg.batch_iterative_indices(sizes, 4, paradigm, **kw)
                assert got == jax_vg.batch_iterative_indices(sizes, 4, paradigm, **kw)
    lists = vg.batch_iterative_indices(sizes, 4, paradigm, seed=5)
    starts = np.cumsum((0,) + sizes)
    for k, batch in enumerate(lists):  # each batch from the dataset its paradigm entry names
        d = paradigm[k % len(paradigm)]
        assert all(starts[d] <= i < starts[d + 1] for i in batch)


def test_keep_names_tables_match_jax(tree):
    annos = [json.loads(tree[f"{s}_anno"].read_text()) for s in ("vg", "coco", "o365")]
    tables = [vg.generate_keep_names_freq(a) for a in annos]
    assert tables == [jax_vg.generate_keep_names_freq(a) for a in annos]
    assert vg.fuse_keep_names_freq(tables) == jax_vg.fuse_keep_names_freq(tables)
    assert vg.unique_names_from_anno(annos[0][0]["objects"], annos[0][0]["relationships"]) == \
        jax_vg.unique_names_from_anno(annos[0][0]["objects"], annos[0][0]["relationships"])
    for a, b in (((0, 0, 2, 2), (1, 1, 2, 2)), ((0, 0, 1, 1), (1, 0, 1, 1)), ((0, 0, 1, 1), (2, 2, 1, 1))):
        assert vg.boxes_overlap(a, b) == jax_vg.boxes_overlap(a, b)


def test_negative_texts_at_pretraining_size():
    """500 negative texts over a VG-sized vocabulary (1200 object names,
    320 predicates, 'freq' sampling): int(2 * 500 / 3) = 333 object and 167
    verb texts. The JAX pipeline overflows the preset's 96 + 160 slots
    (ROADMAP queue 3), and so does the port's with the same slots; the
    port's pre-training slots, 334 + 167, hold them, with the JAX
    pipeline's texts and arrays at those slots."""
    rng = np.random.RandomState(0)
    objs = [f"object {i}" for i in range(1200)]
    preds = [f"predicate {i}" for i in range(320)]
    samples = []
    for k in range(8):
        o = list(rng.choice(objs, 30, replace=False))
        p = list(rng.choice(preds, 12, replace=False))
        n = 10
        samples.append((np.zeros((48, 64, 3), np.uint8), {
            "obj_classes": o, "verb_classes": p,
            "obj_labels": rng.randint(0, 30, n), "sub_labels": rng.randint(0, 30, n),
            "verb_labels": (rng.rand(n, 12) > 0.8).astype(np.float32),
            "sub_boxes": np.tile([[2.0, 3.0, 30.0, 40.0]], (n, 1)).astype(np.float32),
            "obj_boxes": np.tile([[5.0, 6.0, 50.0, 45.0]], (n, 1)).astype(np.float32)}))
    freqs = dict(obj_freqs=1.0 / np.arange(1, 1201), verb_freqs=1.0 / np.arange(1, 321) ** 1.3)
    kw = dict(max_triplets=16, negative_text_sampling=500, obj_vocab=objs, verb_vocab=preds,
              sampling_strategy="freq", **freqs)
    preset = rlip_parseda_v2_r50()
    with pytest.raises(ValueError, match="text slots overflow"):
        jax_build_train_batch(samples, preset.max_obj_texts, preset.max_verb_texts, rng=random.Random(1), **kw)
    with pytest.raises(ValueError, match="text slots overflow"):
        build_train_batch(samples, preset.max_obj_texts, preset.max_verb_texts, rng=random.Random(1), **kw)
    cfg = text_slots(preset, 500)
    assert (cfg.max_obj_texts, cfg.max_verb_texts) == (334, 167)
    got, g_obj, g_verb = build_train_batch(samples, cfg.max_obj_texts, cfg.max_verb_texts, rng=random.Random(1),
                                           **kw)
    want, w_obj, w_verb = jax_build_train_batch(samples, cfg.max_obj_texts, cfg.max_verb_texts,
                                                rng=random.Random(1), **kw)
    assert (g_obj, g_verb) == (w_obj, w_verb)
    assert got["obj_text_valid"][0].sum() == 334 and got["verb_text_valid"][0].sum() == 167  # every slot filled
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert text_slots(preset, 0) == preset  # no negatives: the preset's slots
