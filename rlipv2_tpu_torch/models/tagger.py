"""R-Tagger queries: RLIP run as a relation tagger over ground-truth boxes
(counterpart of rlipv2_tpu/models/tagger.py; reference
models/verb_tagger_helper.py:10-140).

  * `noise_boxes` / `noise_labels`: DN-DETR-style noise, box centres and
    sizes jittered by up to `scale` x (w/2, h/2, w, h) and clamped to
    [0, 1], each label flipped with probability `scale` to a uniform class;
  * `prepare_tagger_queries`: the GT pairs of (B, M) slots as 4-d anchors
    and label-text queries, padded slots given the (0.5, 0.5, 0.5, 0.5)
    anchor and a zero label query, and the slot mask with the empty-image
    guard that keeps slot 0 attended;
  * `tagger_box_queries`: the box part of the query,
    `coord_proj(inverse_sigmoid(box))`.

The noise is drawn from the `torch.Generator` given (on the tensors'
device), never from the global one: the train step passes its own, which
a checkpoint saves; a scale of 0 draws nothing (the JAX `training=False`).
The draws cannot match the JAX package's keys; their distributions do. As
in the JAX `forward_tagger`, which passes no `n_valid_classes`, a flipped
label takes any of the `label_embeds` slots, the no-object and padded text
slots included (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Optional

import torch

from rlipv2_tpu_torch.ops.positional import inverse_sigmoid
from rlipv2_tpu_torch.structures import HOITargets


def noise_boxes(boxes: torch.Tensor, generator: Optional[torch.Generator], scale: float) -> torch.Tensor:
    """(..., 4) cxcywh in [0, 1]: centres moved by up to +-w/2*scale and
    +-h/2*scale, sizes by up to +-w*scale and +-h*scale, then clamped."""
    if scale <= 0:
        return boxes
    diff = torch.cat([boxes[..., 2:] / 2, boxes[..., 2:]], dim=-1)
    noise = torch.rand(boxes.shape, generator=generator, device=boxes.device) * 2.0 - 1.0
    return (boxes + noise * diff * scale).clamp(0.0, 1.0)


def noise_labels(labels: torch.Tensor, generator: Optional[torch.Generator], scale: float,
                 num_classes: int) -> torch.Tensor:
    """Each label flipped with probability `scale` to a class drawn
    uniformly from [0, num_classes)."""
    if scale <= 0:
        return labels
    flip = torch.rand(labels.shape, generator=generator, device=labels.device) < scale
    rand = torch.randint(0, num_classes, labels.shape, generator=generator, device=labels.device)
    return torch.where(flip, rand.to(labels.dtype), labels)


def prepare_tagger_queries(
    label_embeds: torch.Tensor,  # (B, T_obj, C) resized text features
    targets: HOITargets,  # boxes normalized cxcywh; M = num_queries // 2
    generator: Optional[torch.Generator],
    box_noise_scale: float,
    label_noise_scale: float,
):
    """Returns (sub_ref, obj_ref, sub_label_q, obj_label_q, slot_valid):
    refs (B, M, 4) noised anchors, label queries (B, M, C) the gathered text
    features, slot_valid (B, M) the pair slots attended. The boxes and
    labels are noised in the order subject boxes, object boxes, subject
    labels, object labels; `generator` may be None only at scales 0."""
    B, M = targets.valid.shape
    n_cls = label_embeds.shape[1]
    if generator is None and (box_noise_scale > 0 or label_noise_scale > 0):
        raise ValueError("the tagger's noise draws from an explicit generator")
    sub_boxes = noise_boxes(targets.sub_boxes, generator, box_noise_scale)
    obj_boxes = noise_boxes(targets.obj_boxes, generator, box_noise_scale)
    sub_labels = noise_labels(targets.sub_labels, generator, label_noise_scale, n_cls)
    obj_labels = noise_labels(targets.obj_labels, generator, label_noise_scale, n_cls)

    bidx = torch.arange(B, device=label_embeds.device)[:, None]
    valid = targets.valid
    v = valid[..., None]
    sub_label_q = torch.where(v, label_embeds[bidx, sub_labels], 0.0)
    obj_label_q = torch.where(v, label_embeds[bidx, obj_labels], 0.0)
    # empty-image guard (reference verb_tagger_helper.py:99-110): slot 0
    # stays attended, so the attention softmaxes stay finite
    first = torch.arange(M, device=valid.device) == 0
    slot_valid = valid | (~valid.any(dim=1, keepdim=True) & first)
    default_box = torch.full((4,), 0.5, dtype=sub_boxes.dtype, device=sub_boxes.device)
    sub_ref = torch.where(v, sub_boxes, default_box)
    obj_ref = torch.where(v, obj_boxes, default_box)
    return sub_ref, obj_ref, sub_label_q, obj_label_q, slot_valid


def tagger_box_queries(coord_proj, sub_ref: torch.Tensor, obj_ref: torch.Tensor):
    """The box part of the noised queries: coord_proj(inverse_sigmoid(box))
    (reference models/ParSetransformer.py:507-518)."""
    return coord_proj(inverse_sigmoid(sub_ref)), coord_proj(inverse_sigmoid(obj_ref))
