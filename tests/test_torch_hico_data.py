"""The port's HICO loader against the JAX package's, on the CPU: the PNG
reader against PIL's decode bit for bit, the JPEG fixture against its
seeded source, the uint8 augmentations against the PIL ones (the same
geometry from the same seeded draws, pixels within one level), HICODataset
items and build_hico's settings against the JAX dataset, and the pairwise
triplet NMS of the HICO evaluator against the JAX evaluator's."""

import io
import json
import random
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from rlipv2_tpu.data.hico import HICODataset as JaxHICODataset
from rlipv2_tpu.data.hico import build_hico as jax_build_hico
from rlipv2_tpu.data.transforms import HOITransform as JaxHOITransform
from rlipv2_tpu.eval.hico_eval import HICOEvaluator as JaxHICOEvaluator
from rlipv2_tpu_torch.data.hico import HICODataset, build_hico
from rlipv2_tpu_torch.data.image_io import PNG_MAGIC, ImageReader, NvJpegDecoder, decode_png
from rlipv2_tpu_torch.data.transforms import HOITransform
from rlipv2_tpu_torch.eval.hico_eval import HICOEvaluator
from rlipv2_tpu_torch.tools.hico_fixture import FIXTURE_DIR, FIXTURES, MIN_PSNR_DB, psnr_db, source_image
from rlipv2_tpu_torch.tools.hico_tree import write_hico_tree

torch.set_num_threads(2)  # the test workers share the host's cores

SIZES = ((60, 80), (80, 60), (45, 70), (70, 52))  # (h, w), landscape and portrait


def smooth_image(seed, h, w):
    """Low-frequency noise, upsampled: resampling differences stay small."""
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, (h // 6 + 2, w // 6 + 2, 3)).astype(np.uint8)
    return np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC))


def assert_pixels_close(got, want):
    """Within one level for at least 99.9 % of the values, and within two
    everywhere: bilinear resizing rounds once in PIL's fixed point and
    once in torch's."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 2 and (d <= 1).mean() >= 0.999, (d.max(), (d > 1).mean())


# ---------------------------------------------------------------- readers


def png_with_filters(img, kinds):
    """PNG bytes of an (h, w, ch) uint8 image with row y filtered by
    kinds[y % len(kinds)] (PNG specification, section 9)."""
    h, w, ch = img.shape
    raw = img.reshape(h, w * ch).astype(np.int32)
    out = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        line, up = raw[y], raw[y - 1] if y else np.zeros_like(raw[y])
        left = np.concatenate([np.zeros(ch, np.int32), line[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(bytes([kind]) + ((line - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    colour = {1: 0, 3: 2, 4: 6}[ch]
    return (PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_matches_pil(channels):
    """Every filter type, gray / RGB / RGBA, and PIL's own adaptive
    encoding, decoded to RGB equal to PIL's `convert("RGB")`."""
    rng = np.random.RandomState(channels)
    img = rng.randint(0, 256, (13, 11, channels)).astype(np.uint8)
    img[5:] = img[5:] // 7 * 7  # flat runs as well as noise
    smooth = smooth_image(channels, 40, 56)
    alpha = np.full((40, 56, 1), 200, np.uint8)
    pil = {1: smooth[..., 0], 3: smooth, 4: np.dstack([smooth, alpha])}[channels]
    buf = io.BytesIO()
    Image.fromarray(pil, {1: "L", 3: "RGB", 4: "RGBA"}[channels]).save(buf, "PNG")
    for data in (png_with_filters(img, [0, 1, 2, 3, 4]), png_with_filters(img, [4, 3, 2, 1, 0]), buf.getvalue()):
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_png(data), want)


def test_jpeg_fixture_matches_its_source():
    """The committed files decode (PIL here, nvJPEG on the card) to within
    MIN_PSNR_DB of the sources `tools/hico_fixture.py` regenerates, in the
    sampling each names, in at most 600 KB."""
    from PIL import JpegImagePlugin

    total = 0
    for spec in FIXTURES:
        path = FIXTURE_DIR / spec.name
        total += path.stat().st_size
        im = Image.open(path)
        assert im.size == (spec.width, spec.height)
        want = {"4:4:4": 0, "4:2:0": 2, "gray": -1}[spec.subsampling]
        assert JpegImagePlugin.get_sampling(im) == want, spec.name
        assert psnr_db(np.asarray(im.convert("RGB")), source_image(spec)) >= MIN_PSNR_DB, spec.name
    assert total <= 600_000


def test_jpeg_needs_the_card():
    """A JPEG read for the CPU raises: nothing decodes JPEG on the host."""
    with pytest.raises(RuntimeError, match="nvJPEG"):
        ImageReader("cpu").read(FIXTURE_DIR / FIXTURES[0].name)
    with pytest.raises(ValueError, match="CUDA"):
        NvJpegDecoder("cpu")


# ---------------------------------------------------------------- transforms


@pytest.mark.parametrize("seed", range(6))
def test_transforms_match_jax(seed):
    """The same seeded draws give the same flip, jitter factors, branch,
    scales and crop, so the boxes are equal; the colour jitter is PIL's
    bit for bit and the resizes within one level."""
    h, w = SIZES[seed % len(SIZES)]
    img = smooth_image(seed, h, w)
    boxes = np.array([[2, 3, 30, 40], [10, 5, w - 1, h - 2], [0, 0, 8, 9]], np.float32)
    target = {"boxes": boxes, "labels": np.array([3, 1, 2]), "box_indices": np.arange(3)}
    jax_t = JaxHOITransform(True, rng=random.Random(seed), normalize=False)
    port_t = HOITransform(True, rng=random.Random(seed))
    np.testing.assert_array_equal(port_t.color_jitter(torch.from_numpy(img.copy())).numpy(),
                                  np.asarray(jax_t.color_jitter(Image.fromarray(img))))
    jax_t = JaxHOITransform(True, rng=random.Random(seed), normalize=False)
    port_t = HOITransform(True, rng=random.Random(seed))
    want_img, want = jax_t(Image.fromarray(img), {k: v.copy() for k, v in target.items()})
    got_img, got = port_t(torch.from_numpy(img.copy()), {k: v.copy() for k, v in target.items()})
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert_pixels_close(got_img.numpy(), want_img)
    empty = {"boxes": boxes[:0], "labels": np.zeros(0)}
    val_img, _ = HOITransform(False)(torch.from_numpy(img.copy()), dict(empty))
    want_val, _ = JaxHOITransform(False, normalize=False)(Image.fromarray(img), dict(empty))
    assert_pixels_close(val_img.numpy(), want_val)


# ---------------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def hico_root(tmp_path_factory):
    """A HICO tree over PNGs written by PIL (adaptive filters), with the
    setting files cut to different lengths so that the file choice shows."""
    root = tmp_path_factory.mktemp("hico")
    src = []
    for i, (h, w) in enumerate(SIZES):
        path = root / f"src_{i}.png"
        Image.fromarray(smooth_image(10 + i, h, w)).save(path)
        src.append((path, h, w))
    write_hico_tree(root / "tree", src * 3, src * 2, seed=1)
    ann = root / "tree" / "annotations"
    train = json.loads((ann / "trainval_hico.json").read_text())
    for n, name in enumerate(("UC-RF", "UC-NF", "UO", "1percent", "10percent")):
        (ann / f"trainval_hico_{name}.json").write_text(json.dumps(train[: 2 + n]))
    return root / "tree"


def test_val_items_match_jax(hico_root):
    kw = dict(image_set="val", img_folder=hico_root / "images" / "test2015",
              anno_file=hico_root / "annotations" / "test_hico.json")
    got, want = HICODataset(device="cpu", **kw), JaxHICODataset(**kw)
    assert len(got) == len(want) == 8
    for i in range(len(want)):
        (gi, gt), (wi, wt) = got[i], want[i]
        assert set(gt) == set(wt)
        for k in ("orig_size", "boxes", "labels", "hois"):
            np.testing.assert_array_equal(gt[k], wt[k], err_msg=k)
        assert (gt["filename"], gt["id"]) == (wt["filename"], wt["id"])
        assert_pixels_close(gi, np.asarray(wi))


def test_train_items_match_jax(hico_root):
    """Item by item with one seeded rng each side: equal targets (pairs,
    multi-hot verbs, boxes after flips, resizes and crops) and pixels within
    one level."""
    kw = dict(image_set="train", img_folder=hico_root / "images" / "train2015",
              anno_file=hico_root / "annotations" / "trainval_hico.json")
    got = HICODataset(transforms=HOITransform(True, rng=random.Random(7)), device="cpu", **kw)
    want = JaxHICODataset(transforms=JaxHOITransform(True, rng=random.Random(7), normalize=False), **kw)
    assert len(got) == len(want) == 12
    for i in range(len(want)):
        (gi, gt), (wi, wt) = got[i], want[i]
        assert set(gt) == set(wt)
        for k in ("orig_size", "obj_labels", "sub_labels", "verb_labels", "sub_boxes", "obj_boxes"):
            assert gt[k].dtype == wt[k].dtype, k
            np.testing.assert_array_equal(gt[k], wt[k], err_msg=k)
        assert gt["obj_classes"] == wt["obj_classes"] and gt["verb_classes"] == wt["verb_classes"]
        assert_pixels_close(gi, np.asarray(wi))


@pytest.mark.parametrize("zero_shot,few_shot", [(None, 100), ("UC-RF", 100), ("UC-NF", 100), ("UO", 100),
                                                (None, 1), (None, 10)])
def test_build_hico_settings_match_jax(hico_root, zero_shot, few_shot):
    """The train file of each setting, and the val split's rare /
    non-rare (or unseen / seen) triplets and correct_mat."""
    kw = dict(zero_shot_setting=zero_shot, few_shot_transfer=few_shot)
    got, want = build_hico("train", hico_root, device="cpu", **kw), jax_build_hico("train", hico_root, **kw)
    assert got.annotations == want.annotations and got.ids == want.ids
    got, want = build_hico("val", hico_root, device="cpu", **kw), jax_build_hico("val", hico_root, **kw)
    assert got.rare_triplets == want.rare_triplets and got.non_rare_triplets == want.non_rare_triplets
    assert len(got.rare_triplets) + len(got.non_rare_triplets) > 0
    np.testing.assert_array_equal(got.correct_mat, want.correct_mat)


def test_verb_heatmaps_are_not_ported(hico_root):
    """Ported since: `build_verb_hm` (DETRHOIhm) gives each train target the
    JAX dataset's `verb_hm`, (1, H', W') on the augmented image, with one
    peak of 1 a pair; val targets carry none."""
    kw = dict(image_set="train", img_folder=hico_root / "images" / "train2015",
              anno_file=hico_root / "annotations" / "trainval_hico.json", build_verb_hm=True)
    got = HICODataset(transforms=HOITransform(True, rng=random.Random(5)), device="cpu", **kw)
    want = JaxHICODataset(transforms=JaxHOITransform(True, rng=random.Random(5), normalize=False), **kw)
    for i in range(len(want)):
        (gi, gt), (_, wt) = got[i], want[i]
        assert gt["verb_hm"].shape == (1, *gi.shape[:2]) and gt["verb_hm"].dtype == np.float32
        np.testing.assert_array_equal(gt["verb_hm"], wt["verb_hm"])
        assert (gt["verb_hm"] == 1.0).sum() == len(gt["sub_boxes"])
    val = HICODataset("val", hico_root / "images" / "test2015", hico_root / "annotations" / "test_hico.json",
                      build_verb_hm=True, device="cpu")
    assert "verb_hm" not in val[0][1]


# ---------------------------------------------------------------- triplet NMS


def nms_case(seed, n_images=4, n_pairs=12, n_verbs=5, n_obj=4):
    """Predictions with near-duplicate pairs, so the NMS drops some, and
    GT triplets they can hit."""
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for i in range(n_images):
        base = rng.uniform(0, 200, (3, 2, 2))
        base = np.concatenate([base, base + rng.uniform(40, 120, (3, 2, 2))], -1)  # (3 pairs, sub/obj, xyxy)
        pairs = base[rng.randint(0, 3, n_pairs)] + rng.normal(0, 4, (n_pairs, 2, 4))
        boxes = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.float32)
        labels = np.concatenate([np.zeros(n_pairs), rng.randint(1, n_obj, n_pairs)]).astype(np.int64)
        scores = rng.rand(n_pairs, n_verbs).astype(np.float32)
        scores[0, :2] = scores[1, :2]  # a tie
        preds.append({"labels": labels, "boxes": boxes, "verb_scores": scores,
                      "sub_ids": np.arange(n_pairs), "obj_ids": np.arange(n_pairs, 2 * n_pairs)})
        gts.append({"filename": f"{i}.jpg", "boxes": np.concatenate([base[:, 0], base[:, 1]]).astype(np.float32),
                    "labels": np.concatenate([np.zeros(3), labels[n_pairs : n_pairs + 3]]).astype(np.int64),
                    "hois": np.array([[k, 3 + k, rng.randint(n_verbs)] for k in range(3)], np.int64)})
    triplets = sorted({(0, int(g["labels"][h[1]]), int(h[2])) for g in gts for h in g["hois"]})
    correct = np.ones((n_verbs, n_obj), np.float64)
    return preds, gts, triplets[::2], triplets[1::2], correct


@pytest.mark.parametrize("seed", [0, 1])
def test_triplet_nms_matches_jax(seed):
    preds, gts, rare, non_rare, correct = nms_case(seed)
    got = HICOEvaluator(preds, gts, rare, non_rare, correct, use_nms_filter=True)
    want = JaxHICOEvaluator(preds, gts, rare, non_rare, correct, use_nms_filter=True)
    unfiltered = HICOEvaluator(preds, gts, rare, non_rare, correct)
    kept = [[(h["subject_id"], h["object_id"], h["category_id"]) for h in p["hoi_prediction"]] for p in got.preds]
    assert kept == [[(h["subject_id"], h["object_id"], h["category_id"]) for h in p["hoi_prediction"]]
                    for p in want.preds]
    assert sum(map(len, kept)) < sum(len(p["hoi_prediction"]) for p in unfiltered.preds)  # the NMS drops some
    assert got.evaluate() == want.evaluate()
