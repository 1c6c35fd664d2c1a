"""SetCriterionHOI with the default loss types (counterpart of
rlipv2_tpu/losses/criterion.py; reference models/hoi.py:3627-4766).

  * loss_obj_ce: cross-entropy over the valid object text slots, the last
    slot being no-object and down-weighted by `eos_coef`; obj_class_error
    (top-1 error at the matched queries) for the final layer;
  * obj_cardinality_error (reference :3909-3923);
  * loss_verb_ce: the CornerNet focal `_neg_loss` on sigmoid verb scores
    (reference :4455-4479); with `giou_verb_label` (RPL) the matched verb
    labels, plus the pseudo-verb targets when given, are scaled by
    (GIoU + 1) / 2 of the match and scored by the QFL-style
    `_soft_neg_loss` (reference :3932-3977, :4481-4496);
  * loss_{sub,obj}_{bbox,giou}: L1 + GIoU at the matched queries, the object
    terms masked by `exist_obj = (obj_boxes != 0).any(-1)` and renormalised
    (reference :4162-4194);
  * the same losses for every aux decoder layer, suffixed `_{i}`, each with
    its own matching (reference :4747-4764), and `weighted_total`;
  * `triplet_filtering` (RLIPv2, rlipv2_tpu/losses/criterion.py:481-544):
    each valid GT's matched cost under the fixed weights 1/1/2.5/1
    (object class, verb class, L1, GIoU), summed over the final and aux
    layers without gradient; the GTs above mean + 0.5 std over the valid
    GTs drop out of every loss, and the layers are matched again on the
    kept GTs.

Targets are padded to a static M with `valid`; matched targets are (B, M)
gathers and scatters, and every padded slot is masked out. The matching of
all layers is computed first under no_grad and assigned on the host in one
copy (`losses/matcher.py`). The triplet filter needs no second copy: its
first matching (on every valid GT), the filter and the second matching (on
the kept GTs) all run on the host from that copy, so a step still waits
for the device once, when the costs are copied; the kept mask goes back to
the device as the targets' `valid`.

With `subject_class` the subject head's CE (the same weighted CE against
the GT subject labels) adds to `loss_obj_ce`, its top-1 error is logged as
`sub_class_error`, and its class cost joins the matching and the triplet
filter (JAX :407-422, :497-505).

`tagger_losses` (JAX :546-622, reference models/hoi.py:4036-4118) is the
R-Tagger's slot-aligned reconstruction with no matching: prediction slot m
against GT pair m, box L1 and GIoU (the object terms over `exist_obj`),
subject and object CE over the valid pair slots with `eos_coef` on the
last text slot, and the verb loss as `verb_loss_type` says, "bce" (mean
BCE over the valid (pair, verb text) cells) or the focal `_neg_loss` form.

The JAX criterion's other variants (focal or contrastive object loss, the
weighted / asymmetric / class-balanced BCE forms, label smoothing,
masked-entity recon, exponential aux decay and the verb-heatmap losses)
raise NotImplementedError: ROADMAP queue 1 item 14. `verb_loss_type
"bce"` is taken by `tagger_losses` only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rlipv2_tpu_torch.config import LossConfig
from rlipv2_tpu_torch.losses.matcher import assign, finite_costs, hoi_matching_costs, to_host, triplet_filter
from rlipv2_tpu_torch.ops.boxes import box_cxcywh_to_xyxy, box_iou
from rlipv2_tpu_torch.structures import HOITargets

NEG = -1e9
# the triplet filter's cost weights (object class, verb class, L1, GIoU),
# fixed whatever the matcher's are (reference models/hoi.py, JAX :514-522)
FILTER_WEIGHTS = dict(cost_obj_class=1.0, cost_verb_class=1.0, cost_bbox=2.5, cost_giou=1.0)
_TODO = "not ported yet (ROADMAP queue 1 item 14, loss variants)"


def check_supported(cfg: LossConfig, tagger: bool = False) -> None:
    """Raise on a loss variant the port does not implement yet; `tagger`
    (the R-Tagger's `tagger_losses`) takes verb_loss_type "bce" too."""
    d = LossConfig()
    verb_types = (d.verb_loss_type, "bce") if tagger else (d.verb_loss_type,)
    unsupported = {
        "obj_loss_type": cfg.obj_loss_type != d.obj_loss_type,
        "verb_loss_type": cfg.verb_loss_type not in verb_types,
        "naive_obj_smooth": cfg.naive_obj_smooth > 0,
        "naive_verb_smooth": cfg.naive_verb_smooth > 0,
        "exponential_loss": cfg.exponential_loss,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"{', '.join(bad)}: {_TODO}")


def paired_generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GIoU of xyxy boxes paired elementwise: (..., 4) x (..., 4) -> (...);
    the diagonal of `generalized_box_iou`, with its clamps."""
    iou, union = box_iou(a[..., None, :], b[..., None, :])
    iou, union = iou[..., 0, 0], union[..., 0, 0]
    wh = (torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2], b[..., :2])).clamp(min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull.clamp(min=1e-9)


def _gather_queries(x: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
    """x (B, Q, ...) at match (B, M) -> (B, M, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], match]


def _scatter_to_queries(fill: torch.Tensor, match, valid, values) -> torch.Tensor:
    """`fill` (B, Q, ...) with values (B, M, ...) written at the matched
    queries of the valid slots. Padded slots write to an extra query that is
    dropped, as the JAX scatter's mode="drop" does; a boolean index would
    make the host wait for the device."""
    B, Q = fill.shape[:2]
    out = torch.cat([fill, fill[:, :1]], dim=1)
    idx = torch.where(valid, match, torch.full_like(match, Q))
    out[torch.arange(B, device=fill.device)[:, None], idx] = values.to(out.dtype)
    return out[:, :Q]


@dataclasses.dataclass
class SetCriterionHOI:
    cfg: LossConfig
    subject_class: bool = False
    pseudo_verb: bool = False
    tagger: bool = False

    def __post_init__(self):
        check_supported(self.cfg, self.tagger)

    def _obj_ce(self, logits, match, labels, valid, slot_valid):
        """Weighted CE with no-object = last slot; returns (loss, err %)."""
        B, Q, T = logits.shape
        no_obj = T - 1
        target = _scatter_to_queries(
            torch.full((B, Q), no_obj, dtype=torch.long, device=logits.device), match, valid, labels
        )
        logits = logits.float()
        logp = torch.log_softmax(logits.masked_fill(~slot_valid[:, None, :], NEG), dim=-1)
        nll = -torch.gather(logp, 2, target[..., None])[..., 0]  # (B, Q)
        w = torch.where(target == no_obj, self.cfg.eos_coef, 1.0)
        loss = (nll * w).sum() / w.sum()
        with torch.no_grad():
            pred_at = _gather_queries(logits.argmax(-1), match)
            correct = ((pred_at == labels) & valid).sum()
            err = 100.0 * (1.0 - correct / valid.sum().clamp(min=1))
        return loss, err

    @staticmethod
    def _neg_loss(pred, gt, mask):
        """CornerNet focal (reference models/hoi.py:4455-4479) over the
        cells of `mask` (broadcast to pred's shape)."""
        eps = 1e-6
        pred = pred.clamp(eps, 1.0 - eps)
        mask = mask.to(pred.dtype)
        pos = (gt == 1).to(pred.dtype) * mask
        neg = (gt < 1).to(pred.dtype) * mask
        pos_loss = torch.log(pred) * (1 - pred) ** 2 * pos
        neg_loss = torch.log(1 - pred) * pred**2 * (1.0 - gt) ** 4 * neg
        num_pos = pos.sum()
        total = pos_loss.sum() + neg_loss.sum()
        return torch.where(num_pos > 0, -total / num_pos.clamp(min=1.0), -neg_loss.sum())

    @staticmethod
    def _soft_neg_loss(pred, gt, slot_valid, beta=2.0):
        """QFL-style soft focal (reference models/hoi.py:4481-4496)."""
        eps = 1e-6
        pred = pred.clamp(eps, 1.0 - eps)
        mask = slot_valid[:, None, :].to(pred.dtype)
        loss = (gt - pred).abs() ** beta * ((1 - gt) * torch.log(1 - pred) + gt * torch.log(pred)) * mask
        num_pos = ((gt > 0).to(pred.dtype) * mask).sum()
        return torch.where(num_pos > 0, -loss.sum() / num_pos.clamp(min=1.0), -loss.sum())

    def _verb_loss(self, verb_logits, match, targets: HOITargets, verb_valid, giou_cost, target_verb_sim):
        B, Q, V = verb_logits.shape
        labels = targets.verb_labels.float()
        if self.cfg.giou_verb_label:
            # RPL: the GIoU of each target with its matched query, as a
            # target (the matcher's costs carry no gradient)
            M = match.shape[1]
            giou = -giou_cost[torch.arange(B, device=match.device)[:, None], match,
                              torch.arange(M, device=match.device)[None, :]]
            soft = ((giou + 1.0) / 2.0).clamp(0.0, 1.0)
            if self.pseudo_verb and target_verb_sim is not None:
                labels = labels + target_verb_sim
            labels = labels * soft[..., None]
        target = _scatter_to_queries(
            torch.zeros((B, Q, V), dtype=torch.float32, device=verb_logits.device),
            match, targets.valid, labels,
        )
        pred = torch.sigmoid(verb_logits.float())
        if self.cfg.giou_verb_label:
            return self._soft_neg_loss(pred, target, verb_valid)
        return self._neg_loss(pred, target, verb_valid[:, None, :])

    @staticmethod
    def _box_losses(outputs, match, targets: HOITargets, num_interactions):
        src_sub = _gather_queries(outputs["pred_sub_boxes"].float(), match)
        src_obj = _gather_queries(outputs["pred_obj_boxes"].float(), match)
        tv = targets.valid.float()
        exist_obj = (targets.obj_boxes != 0).any(-1).float() * tv
        l1_sub = (src_sub - targets.sub_boxes).abs().sum(-1) * tv
        l1_obj = (src_obj - targets.obj_boxes).abs().sum(-1) * exist_obj
        g_sub = paired_generalized_box_iou(box_cxcywh_to_xyxy(src_sub), box_cxcywh_to_xyxy(targets.sub_boxes))
        g_obj = paired_generalized_box_iou(box_cxcywh_to_xyxy(src_obj), box_cxcywh_to_xyxy(targets.obj_boxes))
        n_obj = exist_obj.sum() + 1e-4
        return {
            "loss_sub_bbox": l1_sub.sum() / num_interactions,
            "loss_obj_bbox": l1_obj.sum() / n_obj,
            "loss_sub_giou": ((1.0 - g_sub) * tv).sum() / num_interactions,
            "loss_obj_giou": ((1.0 - g_obj) * exist_obj).sum() / n_obj,
        }

    def _single(self, outputs, match, giou_cost, targets, obj_valid, verb_valid, num_interactions,
                target_verb_sim, log):
        losses = {}
        loss, err = self._obj_ce(outputs["pred_obj_logits"], match, targets.obj_labels,
                                 targets.valid, obj_valid)
        if self.subject_class:
            sub_loss, sub_err = self._obj_ce(outputs["pred_sub_logits"], match, targets.sub_labels,
                                             targets.valid, obj_valid)
            loss = loss + sub_loss
            if log:
                losses["sub_class_error"] = sub_err
        losses["loss_obj_ce"] = loss
        if log:
            losses["obj_class_error"] = err
        with torch.no_grad():
            logits = outputs["pred_obj_logits"]
            card_pred = (logits.argmax(-1) != logits.shape[-1] - 1).sum(-1).float()
            tgt_len = targets.valid.sum(-1).float()
            losses["obj_cardinality_error"] = (card_pred - tgt_len).abs().mean()
        losses["loss_verb_ce"] = self._verb_loss(outputs["pred_verb_logits"], match, targets, verb_valid,
                                                 giou_cost, target_verb_sim)
        losses.update(self._box_losses(outputs, match, targets, num_interactions))
        return losses

    def match(self, layers: list, targets: HOITargets, verb_valid) -> tuple:
        """For each layer's outputs: (N, B, M) query index per target slot,
        the (N, B, Q, M) GIoU cost of the matching, and the (B, M) target
        slots that count (`targets.valid`, or the GTs the triplet filter
        keeps). One copy to the host for all of it."""
        c = self.cfg
        weights = dict(cost_obj_class=c.set_cost_obj_class, cost_verb_class=c.set_cost_verb_class,
                       cost_bbox=c.set_cost_bbox, cost_giou=c.set_cost_giou)
        sub = dict(subject_class=self.subject_class)
        with torch.no_grad():
            costs = [hoi_matching_costs(out, targets, verb_valid, **weights, **sub) for out in layers]
            total = torch.stack([k.total for k in costs])
            giou = torch.stack([k.giou for k in costs])
            host = [total, targets.valid]
            if c.triplet_filtering and weights != FILTER_WEIGHTS:
                host.append(torch.stack([hoi_matching_costs(out, targets, verb_valid, **FILTER_WEIGHTS, **sub).total
                                         for out in layers]))
            C, ok, *filt = to_host(host)
        C, valid = finite_costs(C), ok > 0.5
        if c.triplet_filtering:
            F = finite_costs(filt[0]) if filt else C
            valid = triplet_filter(F, assign(F, valid), valid)
        match = torch.from_numpy(assign(C, valid)).to(total.device)
        if c.triplet_filtering:
            return match, giou, torch.from_numpy(valid).to(total.device)
        return match, giou, targets.valid

    def __call__(
        self,
        outputs: dict,
        targets: HOITargets,
        obj_valid: torch.Tensor,  # (B, T_obj) valid object text slots
        verb_valid: torch.Tensor,  # (B, T_verb)
        target_verb_sim: Optional[torch.Tensor] = None,  # (B, M, T_verb) pseudo-verb targets
    ) -> dict:
        layers = [outputs, *outputs.get("aux_outputs", [])]
        matches, giou, valid = self.match(layers, targets, verb_valid)
        targets = targets._replace(valid=valid)
        num_interactions = targets.valid.sum().float().clamp(min=1.0)
        losses = self._single(outputs, matches[0], giou[0], targets, obj_valid, verb_valid,
                              num_interactions, target_verb_sim, log=True)
        for i, aux in enumerate(layers[1:]):
            aux_losses = self._single(aux, matches[i + 1], giou[i + 1], targets, obj_valid, verb_valid,
                                      num_interactions, target_verb_sim, log=False)
            losses.update({f"{k}_{i}": v for k, v in aux_losses.items()})
        return losses

    def tagger_losses(self, outputs: dict, targets: HOITargets, obj_valid: torch.Tensor,
                      verb_valid: torch.Tensor) -> dict:
        """The R-Tagger's losses: the predictions at pair slot m against GT
        pair m, no matching; the final layer only, as in the JAX package.
        Needs the subject head (`pred_sub_logits`)."""
        c = self.cfg
        v = targets.valid.float()  # (B, M)
        B, M = v.shape
        slots = torch.arange(M, device=v.device).expand(B, M)  # slot m is GT pair m's query
        losses = self._box_losses(outputs, slots, targets, v.sum().clamp(min=1.0))

        def slot_ce(logits, labels):
            T = logits.shape[-1]
            logp = torch.log_softmax(logits.float().masked_fill(~obj_valid[:, None, :], NEG), dim=-1)
            nll = -torch.gather(logp, 2, labels.long()[..., None])[..., 0]
            w = torch.where(labels == T - 1, c.eos_coef, 1.0) * v
            return (nll * w).sum() / w.sum().clamp(min=1e-4)

        losses["loss_obj_ce"] = (slot_ce(outputs["pred_obj_logits"], targets.obj_labels)
                                 + slot_ce(outputs["pred_sub_logits"], targets.sub_labels))
        logits = outputs["pred_verb_logits"].float()
        target = targets.verb_labels.float() * v[..., None]
        mask = (verb_valid[:, None, :] & targets.valid[..., None]).float()
        if c.verb_loss_type == "bce":
            bce = logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
            losses["loss_verb_ce"] = (bce * mask).sum() / mask.sum().clamp(min=1.0)
        else:
            losses["loss_verb_ce"] = self._neg_loss(torch.sigmoid(logits), target, mask)
        return losses

    def weighted_total(self, losses: dict) -> torch.Tensor:
        """Weighted sum over the loss terms, aux layers included, with the
        reference's weight_dict (models/detr.py:571-621 + engine.py:106-109);
        metrics (class and cardinality errors) carry no weight."""
        c = self.cfg
        w = {
            "loss_obj_ce": c.obj_loss_coef,
            "loss_verb_ce": c.verb_loss_coef,
            "loss_sub_bbox": c.bbox_loss_coef,
            "loss_obj_bbox": c.bbox_loss_coef,
            "loss_sub_giou": c.giou_loss_coef,
            "loss_obj_giou": c.giou_loss_coef,
        }
        total = 0.0
        for k, v in losses.items():
            tail = k.rsplit("_", 1)[-1]
            base = k.rsplit("_", 1)[0] if tail.isdigit() else k
            if base in w:
                total = total + w[base] * v
        return total
