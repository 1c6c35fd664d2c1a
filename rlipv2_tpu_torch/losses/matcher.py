"""Hungarian set matching for HOI triplets (counterpart of
rlipv2_tpu/losses/matcher.py; reference `HungarianMatcherHOI`,
models/matcher.py:95-270).

  * `hoi_matching_costs`: the batched (B, Q, M) cost on the device in
    float32, the JAX function's arithmetic: -softmax prob at the GT object
    label, the symmetric positive/negative verb cost over valid verb slots,
    max(L1_sub, L1_obj) and max(-GIoU_sub, -GIoU_obj) with the object terms
    masked where the GT object box is all-zero; padded target slots cost 0.
  * `to_host`, `finite_costs` and `assign`: the costs go to the host in one
    copy, and the assignment runs there with
    `scipy.optimize.linear_sum_assignment`, as the reference does
    (models/matcher.py:182-193); `SetCriterionHOI.match` composes them.
    Only valid target slots are assigned: a
    padded slot has constant cost and cannot change the optimum of the
    valid ones (rlipv2_tpu/losses/matcher.py:17-19), so its match is left at
    0 and every loss masks it out. The JAX `lsap_jax` is plain XLA, not a
    TPU kernel, so no device kernel stands in for it here.
  * `triplet_filter`: RLIPv2's filter of the GTs that the model matches
    worst, on the host copy of the costs (`to_host`, `assign`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from rlipv2_tpu_torch.ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou
from rlipv2_tpu_torch.structures import HOITargets

# stands in for a non-finite cost: scipy rejects NaN/inf, and a non-finite
# loss is the train step's to report, not the matcher's
_NONFINITE_COST = 1e9


class MatchCosts(NamedTuple):
    total: torch.Tensor  # (B, Q, M) combined weighted cost, 0 at padded slots
    giou: torch.Tensor  # (B, Q, M) max-combined giou cost
    bbox: torch.Tensor
    verb_class: torch.Tensor
    obj_class: torch.Tensor
    sub_class: torch.Tensor  # zeros without subject_class


def hoi_matching_costs(
    outputs: dict,
    targets: HOITargets,
    verb_valid: torch.Tensor,  # (B, T_verb) bool: real verb text slots
    cost_obj_class: float = 1.0,
    cost_verb_class: float = 1.0,
    cost_bbox: float = 2.5,
    cost_giou: float = 1.0,
    subject_class: bool = False,
) -> MatchCosts:
    """With `subject_class` the subject head's class cost (-softmax
    probability at the GT subject label) adds to the object class cost's
    weight."""
    obj_prob = torch.softmax(outputs["pred_obj_logits"].float(), dim=-1)  # (B, Q, To)
    verb_prob = torch.sigmoid(outputs["pred_verb_logits"].float())  # (B, Q, Tv)
    sub_bbox = outputs["pred_sub_boxes"].float()  # (B, Q, 4)
    obj_bbox = outputs["pred_obj_boxes"].float()
    Q = obj_prob.shape[1]

    labels = targets.obj_labels.long()[:, None, :].expand(-1, Q, -1)  # (B, Q, M)
    c_obj = -torch.gather(obj_prob, 2, labels)
    c_sub = torch.zeros_like(c_obj)
    if subject_class:
        sub_prob = torch.softmax(outputs["pred_sub_logits"].float(), dim=-1)
        c_sub = -torch.gather(sub_prob, 2, targets.sub_labels.long()[:, None, :].expand(-1, Q, -1))

    # padded verb TEXT slots are excluded from both terms
    T = targets.verb_labels.float()  # (B, M, Tv)
    vmask = verb_valid.float()[:, None, :]
    Tpos = T * vmask
    Tneg = (1.0 - T) * vmask
    pos = torch.einsum("bqv,bmv->bqm", verb_prob, Tpos) / (Tpos.sum(-1)[:, None, :] + 1e-4)
    neg = torch.einsum("bqv,bmv->bqm", 1.0 - verb_prob, Tneg) / (Tneg.sum(-1)[:, None, :] + 1e-4)
    c_verb = -(pos + neg) / 2.0

    l1_sub = (sub_bbox[:, :, None, :] - targets.sub_boxes[:, None]).abs().sum(-1)
    l1_obj = (obj_bbox[:, :, None, :] - targets.obj_boxes[:, None]).abs().sum(-1)
    exist_obj = (targets.obj_boxes != 0).any(-1)  # (B, M)
    l1_obj = l1_obj * exist_obj[:, None, :]
    c_bbox = torch.maximum(l1_sub, l1_obj)

    g_sub = -generalized_box_iou(box_cxcywh_to_xyxy(sub_bbox), box_cxcywh_to_xyxy(targets.sub_boxes))
    g_obj = -generalized_box_iou(box_cxcywh_to_xyxy(obj_bbox), box_cxcywh_to_xyxy(targets.obj_boxes))
    g_obj = g_obj + g_sub * (~exist_obj)[:, None, :]
    c_giou = torch.maximum(g_sub, g_obj)

    total = (
        cost_obj_class * c_obj
        + cost_obj_class * c_sub
        + cost_verb_class * c_verb
        + cost_bbox * c_bbox
        + cost_giou * c_giou
    )
    total = torch.where(targets.valid[:, None, :], total, torch.zeros_like(total))
    return MatchCosts(total, c_giou, c_bbox, c_verb, c_obj, c_sub)


def to_host(tensors: Sequence[torch.Tensor]) -> list:
    """Tensors on one device -> float32 numpy arrays of their shapes, in
    ONE copy (one wait for the device)."""
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors]).cpu().numpy()
    out, start = [], 0
    for t in tensors:
        out.append(flat[start : start + t.numel()].reshape(t.shape))
        start += t.numel()
    return out


def finite_costs(costs: np.ndarray) -> np.ndarray:
    return np.nan_to_num(costs, nan=_NONFINITE_COST, posinf=_NONFINITE_COST, neginf=-_NONFINITE_COST)


def assign(costs: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Host costs (N, B, Q, M), finite, and valid (B, M) bool -> (N, B, M)
    int64 query index per target slot (0 at the slots not assigned)."""
    N, B, Q, M = costs.shape
    if M > Q:
        raise ValueError(f"need M ({M}) <= Q ({Q}) target slots")
    match = np.zeros((N, B, M), np.int64)
    for n in range(N):
        for b in range(B):
            slots = np.flatnonzero(valid[b])
            if len(slots):
                rows, cols = linear_sum_assignment(costs[n, b][:, slots].T)  # rows = targets
                match[n, b, slots[rows]] = cols
    return match


def triplet_filter(costs: np.ndarray, match: np.ndarray, valid: np.ndarray, gather=None) -> np.ndarray:
    """RLIPv2's triplet filtering on the host (rlipv2_tpu/losses/criterion.py
    `_triplet_filter`, float32 as there): each valid GT's matched cost
    (costs (N, B, Q, M) at match (N, B, M)) summed over the N layers, and
    the GTs at or below mean + 0.5 std over the valid ones (unbiased
    variance) kept. Returns the kept (B, M) mask. `triplet_filter.counts`
    adds up the valid and the kept GTs and the calls.

    In a data-parallel step `gather(a) -> (world, *a.shape)` collects every
    rank's matched costs and valid masks: the statistics are the global
    batch's, as the JAX step computes them, over the same (B, M) array in
    the same order, so each rank keeps what one process would."""
    picked = np.take_along_axis(costs, match[:, :, None, :], axis=2)[:, :, 0, :]  # (N, B, M)
    total = picked[0]
    for p in picked[1:]:
        total = total + p
    every, every_valid = total, valid
    if gather is not None:
        every = gather(total).reshape(-1, total.shape[-1])
        every_valid = gather(valid).reshape(-1, valid.shape[-1])
    v = every_valid.astype(np.float32)
    n = np.float32(max(int(every_valid.sum()), 1))
    mean = (every * v).sum(dtype=np.float32) / n
    var = (((every - mean) * v) ** 2).sum(dtype=np.float32) / np.float32(max(n - 1, 1))
    keep = valid & (total <= mean + np.sqrt(var) * np.float32(0.5))
    counts = triplet_filter.counts
    counts["calls"] += 1
    counts["valid"] += int(valid.sum())
    counts["kept"] += int(keep.sum())
    return keep


triplet_filter.counts = {"calls": 0, "valid": 0, "kept": 0}
