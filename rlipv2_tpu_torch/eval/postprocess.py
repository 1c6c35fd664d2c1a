"""Post-processing of model outputs into HOI and scene-graph results
(counterpart of rlipv2_tpu/eval/postprocess.py; reference `PostProcessHOI`,
models/hoi.py:4769-4873, and `PostProcessSGG`, :4876-4938).

  * object scores: softmax over text slots, the LAST slot (no-object)
    dropped, then max over the rest;
  * verb scores: sigmoid times the object score; for an output that has
    `curing_score` (RLIP-ParSeDA's verb-curing heads) also times that
    pair-quality score, as the JAX function's `verb_curing` does (JAX :58,
    :89-90, reference :4833-4836);
  * boxes: cxcywh -> xyxy scaled to the original image size;
  * pairs are (query i subject, query i object);
  * with `subject_class`, and an output that has `pred_sub_logits`, the
    subject's score and label as the object's; `postprocess_sgg` then
    multiplies the relation scores by the subject score too.

The JAX function's other options (slot masks, temperature, raw verb
logits, co-occurrence prior) are not ported: no caller sets them.
"""

from __future__ import annotations

import numpy as np
import torch

from rlipv2_tpu_torch.ops.boxes import box_cxcywh_to_xyxy


@torch.no_grad()
def postprocess_hoi(outputs: dict, orig_sizes: torch.Tensor, subject_class: bool = False) -> dict:
    """`orig_sizes` is (B, 2) as (h, w). Returns batched tensors:
    obj_scores/obj_labels (B, nq), verb_scores (B, nq, V), and
    sub_boxes/obj_boxes (B, nq, 4) xyxy in original pixels; with
    `subject_class` and `pred_sub_logits` also sub_scores/sub_labels; with
    `curing_score` (B, nq, 1) the verb scores cured."""
    obj_prob_fg = torch.softmax(outputs["pred_obj_logits"].float(), dim=-1)[..., :-1]
    obj_scores, obj_labels = obj_prob_fg.max(-1)
    verb_scores = torch.sigmoid(outputs["pred_verb_logits"].float())
    if "curing_score" in outputs:
        verb_scores = verb_scores * outputs["curing_score"].float()
    verb_scores = verb_scores * obj_scores[..., None]

    h, w = orig_sizes[:, 0].float(), orig_sizes[:, 1].float()
    scale = torch.stack([w, h, w, h], dim=1)[:, None, :]
    result = {
        "obj_scores": obj_scores,
        "obj_labels": obj_labels,
        "verb_scores": verb_scores,
        "sub_boxes": box_cxcywh_to_xyxy(outputs["pred_sub_boxes"].float()) * scale,
        "obj_boxes": box_cxcywh_to_xyxy(outputs["pred_obj_boxes"].float()) * scale,
    }
    if subject_class and "pred_sub_logits" in outputs:
        sub_prob_fg = torch.softmax(outputs["pred_sub_logits"].float(), dim=-1)[..., :-1]
        result["sub_scores"], result["sub_labels"] = sub_prob_fg.max(-1)
    return result


@torch.no_grad()
def postprocess_sgg(outputs: dict, orig_sizes: torch.Tensor) -> dict:
    """`postprocess_hoi` with the subject class, the relation scores also
    multiplied by the subject score, never cured (the JAX SGG
    post-processor takes no curing). `outputs` must have
    `pred_sub_logits`."""
    uncured = {k: v for k, v in outputs.items() if k != "curing_score"}
    base = postprocess_hoi(uncured, orig_sizes, subject_class=True)
    base["verb_scores"] = base["verb_scores"] * base["sub_scores"][..., None]
    return base


def to_image_results(batched: dict, subject_category_id: int):
    """Host-side per-image result dicts (labels/boxes as [sub || obj],
    verb_scores, sub/obj ids) for the evaluators (reference
    models/hoi.py:4849-4871)."""
    host = {k: v.detach().cpu().numpy() for k, v in batched.items()}
    B, nq = host["obj_scores"].shape
    ids = np.arange(2 * nq)
    return [
        {
            "labels": np.concatenate([np.full(nq, subject_category_id, dtype=np.int64), host["obj_labels"][b]]),
            "boxes": np.concatenate([host["sub_boxes"][b], host["obj_boxes"][b]], axis=0),
            "verb_scores": host["verb_scores"][b],
            "sub_ids": ids[:nq],
            "obj_ids": ids[nq:],
        }
        for b in range(B)
    ]
