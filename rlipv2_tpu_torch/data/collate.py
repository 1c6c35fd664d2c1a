"""Static-shape batch assembly (counterpart of rlipv2_tpu/data/collate.py):
images pad to fixed resolution buckets with a pixel-validity mask, GT
triplets to `max_triplets` slots, and boxes become normalised cxcywh.
Fixed buckets keep the set of shapes the device sees small and closed."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from rlipv2_tpu_torch.data.transforms import normalize_boxes

# (H, W) buckets covering the reference's multi-scale range (480-800 short
# side, max 1333 long side), multiples of 64 for clean level pyramids
DEFAULT_BUCKETS = (
    (512, 512),
    (512, 768),
    (768, 512),
    (576, 1024),
    (1024, 576),
    (832, 832),
    (832, 1344),  # covers short 800 / long <= 1333
    (1344, 832),
    (1088, 1088),
    # batch envelope cover-all: hmax/wmax are taken ACROSS the batch, so a
    # tall portrait + a wide landscape can combine to up to (1344, 1344)
    # even though no single image exceeds (1344, 832)/(832, 1344)
    (1344, 1344),
)


def pick_bucket(h: int, w: int, buckets=DEFAULT_BUCKETS):
    """Smallest bucket that contains (h, w); falls back to the largest."""
    best = None
    for bh, bw in buckets:
        if bh >= h and bw >= w:
            area = bh * bw
            if best is None or area < best[0]:
                best = (area, (bh, bw))
    if best is None:
        return max(buckets, key=lambda b: b[0] * b[1])
    return best[1]


def make_hoi_batch(
    images: Sequence[np.ndarray],  # list of (h_i, w_i, 3) float32 normalized
    targets: Sequence[dict],  # per-image: obj/sub_labels, verb_labels (n, V)
    #           sub/obj boxes XYXY px in the image's current size
    max_triplets: int,
    n_verb_slots: int,
    bucket: Optional[tuple[int, int]] = None,
    buckets=DEFAULT_BUCKETS,
):
    """Returns numpy arrays of the train batch minus text:
    pixels (B, H, W, 3), pixel_valid (B, H, W), and HOITargets fields with
    boxes converted to normalized cxcywh (normalized by the REAL image
    extent, not the padded bucket — matching the reference, which
    normalizes before padding)."""
    B = len(images)
    hmax = max(im.shape[0] for im in images)
    wmax = max(im.shape[1] for im in images)
    H, W = bucket or pick_bucket(hmax, wmax, buckets)

    # follow the image dtype: uint8 images (HOITransform(normalize=False))
    # stay uint8 through collate + transfer and normalize on device
    pixels = np.zeros((B, H, W, 3), np.asarray(images[0]).dtype)
    valid = np.zeros((B, H, W), bool)
    obj_labels = np.zeros((B, max_triplets), np.int64)
    sub_labels = np.zeros((B, max_triplets), np.int64)
    verb_labels = np.zeros((B, max_triplets, n_verb_slots), np.float32)
    sub_boxes = np.zeros((B, max_triplets, 4), np.float32)
    obj_boxes = np.zeros((B, max_triplets, 4), np.float32)
    tvalid = np.zeros((B, max_triplets), bool)

    for b, (im, t) in enumerate(zip(images, targets)):
        h, w = im.shape[:2]
        if h > H or w > W:
            raise ValueError(f"image ({h},{w}) exceeds bucket ({H},{W})")
        pixels[b, :h, :w] = im
        valid[b, :h, :w] = True
        n = min(len(t["obj_labels"]), max_triplets)
        if n:
            obj_labels[b, :n] = np.asarray(t["obj_labels"])[:n]
            sub_labels[b, :n] = np.asarray(t["sub_labels"])[:n]
            vl = np.asarray(t["verb_labels"])[:n]
            verb_labels[b, :n, : vl.shape[1]] = vl
            # IMPORTANT: normalize by the un-padded size; padded region of
            # the bucket is masked via pixel_valid, and boxes are relative
            # to the real image extent like the reference
            sub_boxes[b, :n] = normalize_boxes(np.asarray(t["sub_boxes"])[:n], h, w)
            # all-zero obj boxes (no-object pairs) must STAY all-zero
            ob = np.asarray(t["obj_boxes"])[:n]
            nz = np.any(ob != 0, axis=1)
            ob_norm = normalize_boxes(ob, h, w)
            obj_boxes[b, :n] = np.where(nz[:, None], ob_norm, 0.0)
            tvalid[b, :n] = True

    return {
        "pixels": pixels,
        "pixel_valid": valid,
        "obj_labels": obj_labels,
        "sub_labels": sub_labels,
        "verb_labels": verb_labels,
        "sub_boxes": sub_boxes,
        "obj_boxes": obj_boxes,
        "triplet_valid": tvalid,
    }
