"""CenterNet-style GT verb heatmaps for DETRHOIhm (counterpart of
rlipv2_tpu/data/heatmap.py, a numpy copy; reference datasets/hico.py:376-407,
primitives util/image.py:101-148).

One umich gaussian per HOI pair at the midpoint of the subject and object
box centres, its radius from the |centre delta| by the CornerNet
min-overlap formula. `HICODataset(build_verb_hm=True)` puts the map in each
train target as `verb_hm`; `models/closed_vocab.py::DETRHOIhmModel`'s
`verb_hm` output is trained against it by
`losses/criterion.py::SetCriterionHOI.loss_verb_hm`.
"""

from __future__ import annotations

import math

import numpy as np


def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    """CornerNet radius: the largest r such that a corner displaced by r
    still yields IoU >= min_overlap (reference util/image.py:101-122 —
    three quadratic cases, min of the roots)."""
    height, width = det_size

    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = np.sqrt(b1 ** 2 - 4 * c1)
    r1 = (b1 + sq1) / 2

    # NOTE: the reference (like upstream CornerNet) divides every root by
    # plain 2, not 2a — a historical quirk; preserved bit-exactly since
    # the radii feed the training targets.
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = np.sqrt(b2 ** 2 - 4 * 4 * c2)
    r2 = (b2 + sq2) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = np.sqrt(b3 ** 2 - 4 * a3 * c3)
    r3 = (b3 + sq3) / 2
    return min(r1, r2, r3)


def gaussian2d(shape, sigma: float = 1.0) -> np.ndarray:
    """(reference util/image.py:124-130; values below eps*max zeroed)."""
    m, n = [(ss - 1.0) / 2.0 for ss in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_umich_gaussian(heatmap: np.ndarray, center, radius: int,
                        k: float = 1.0) -> np.ndarray:
    """In-place max-blend of a (2r+1)^2 gaussian (sigma = diameter/6) at
    integer `center`, cropped at the map edges (reference
    util/image.py:133-148)."""
    diameter = 2 * radius + 1
    gaussian = gaussian2d((diameter, diameter), sigma=diameter / 6)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[0:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    masked_heatmap = heatmap[y - top : y + bottom, x - left : x + right]
    masked_gaussian = gaussian[
        radius - top : radius + bottom, radius - left : radius + right
    ]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)
    return heatmap


def make_verb_heatmap(
    sub_boxes: np.ndarray,  # (n, 4) xyxy PIXEL coords on the (H, W) map
    obj_boxes: np.ndarray,  # (n, 4)
    hw: tuple,  # (H, W) of the transformed image
    n_channels: int = 1,
) -> np.ndarray:
    """(n_channels, H, W) GT map: one gaussian per pair at the midpoint of
    the two box centers; radius from the |center delta| (reference
    datasets/hico.py:398-407 — `hoi_cate` is hard-coded 0 there, i.e. one
    shared channel, preserved here via n_channels=1)."""
    H, W = int(hw[0]), int(hw[1])
    hm = np.zeros((n_channels, H, W), np.float32)
    for sb, ob in zip(
        np.asarray(sub_boxes, np.float32).reshape(-1, 4),
        np.asarray(obj_boxes, np.float32).reshape(-1, 4),
    ):
        sub_ct = ((sb[0] + sb[2]) / 2.0, (sb[1] + sb[3]) / 2.0)
        obj_ct = ((ob[0] + ob[2]) / 2.0, (ob[1] + ob[3]) / 2.0)
        rel_ct = np.array(
            [(sub_ct[0] + obj_ct[0]) / 2, (sub_ct[1] + obj_ct[1]) / 2],
            np.float32,
        )
        # reference passes (|dx|, |dy|) as (height, width); the formula is
        # symmetric in h/w (only h+w and h*w appear), so order is moot —
        # kept in the reference's order for bit-faithfulness
        radius = gaussian_radius(
            (
                math.ceil(abs(sub_ct[0] - obj_ct[0])),
                math.ceil(abs(sub_ct[1] - obj_ct[1])),
            )
        )
        radius = max(0, int(radius))
        draw_umich_gaussian(hm[0], rel_ct.astype(np.int32), radius)
    return hm
