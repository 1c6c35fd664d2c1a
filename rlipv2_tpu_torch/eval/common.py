"""Evaluator primitives: class-aware Pascal(+1) IoU and the pred -> gt
match-pair tables of the greedy TP/FP protocol (reference:
datasets/hico_eval.py:434-492). A copy of rlipv2_tpu/eval/common.py with
the vectorized numpy IoU matrix only; the JAX package's native C++ core
bit-matches it by that package's own docstring, so it is not carried over."""

from __future__ import annotations

import numpy as np


def pairwise_iou_cat(b1: np.ndarray, c1: np.ndarray, b2: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Category-gated Pascal(+1) IoU matrix (n1, n2) of xyxy float64 boxes:
    zero where the category ids differ or the boxes do not overlap."""
    a0, a1, a2, a3 = (b1[:, i][:, None] for i in range(4))
    d0, d1, d2, d3 = (b2[:, i][None, :] for i in range(4))
    s1 = (a2 - a0 + 1) * (a3 - a1 + 1)
    s2 = (d2 - d0 + 1) * (d3 - d1 + 1)
    left = np.maximum(a1, d1)
    right = np.minimum(a3, d3)
    top = np.maximum(a0, d0)
    bottom = np.minimum(a2, d2)
    inter = np.where(
        (left < right) & (top < bottom),
        (right - left + 1) * (bottom - top + 1),
        0.0,
    )
    iou = inter / (s1 + s2 - inter)
    return np.where(c1[:, None] == c2[None, :], iou, 0.0)


def compute_iou_mat(bbox_list1, bbox_list2, overlap_iou: float = 0.5):
    """-> ({pred_id: [gt_ids]}, {pred_id: [overlaps]}) at IoU >= threshold."""
    if len(bbox_list1) == 0 or len(bbox_list2) == 0:
        return {}, {}
    b1 = np.asarray([b["bbox"] for b in bbox_list1], np.float64)
    b2 = np.asarray([b["bbox"] for b in bbox_list2], np.float64)
    # category ids may be composite tuples: densify through one lookup so
    # equality is preserved
    lut: dict = {}
    c1 = np.asarray([lut.setdefault(b["category_id"], len(lut)) for b in bbox_list1], np.int32)
    c2 = np.asarray([lut.setdefault(b["category_id"], len(lut)) for b in bbox_list2], np.int32)
    iou_ov = pairwise_iou_cat(b1, c1, b2, c2)
    iou_mat = (iou_ov >= overlap_iou).astype(np.float64)

    match_pairs = np.nonzero(iou_mat)
    match_pairs_dict: dict = {}
    match_pair_overlaps: dict = {}
    if iou_mat.max() > 0:
        for i, pred_id in enumerate(match_pairs[1]):
            match_pairs_dict.setdefault(pred_id, []).append(match_pairs[0][i])
            match_pair_overlaps.setdefault(pred_id, []).append(iou_ov[match_pairs[0][i], pred_id])
    return match_pairs_dict, match_pair_overlaps
