"""SetCriterionHOI, the HOI/RLIP loss suite (counterpart of
rlipv2_tpu/losses/criterion.py; reference models/hoi.py:3627-4766).

  * loss_obj_ce (`obj_loss_type` cross_entropy, focal, and either with
    "_with_tem"): cross-entropy over the valid object text slots, the last
    slot being no-object and down-weighted by `eos_coef`; "focal" in the
    type scales each query's term by (1 - p)^2 and takes the mean over the
    queries, "with_tem" divides the logits by the temperature 0.07 first
    (JAX :122-152); obj_class_error (top-1 error at the matched queries)
    for the final layer;
  * obj_cardinality_error (reference :3909-3923);
  * loss_verb_ce, by `verb_loss_type`: "focal" the CornerNet focal
    `_neg_loss` on sigmoid verb scores (reference :4455-4479), with
    `giou_verb_label` (RPL) the matched verb labels, plus the pseudo-verb
    targets when given, scaled by (GIoU + 1) / 2 of the match and scored by
    the QFL-style `_soft_neg_loss` (reference :3932-3977, :4481-4496);
    "bce" the mean BCE on the logits over the valid verb slots of every
    query; "weighted_bce", "asymmetric_bce" and "CB_focal_bce" (JAX
    :283-350, reference :4353-4434). With the model's verb-curing heads
    (`curing_score` in the outputs, the final layer's, shared by the aux
    layers) every form but "bce" scores the sigmoid times the curing score
    (JAX :268-272);
  * `cross_modal_matching` as `obj_loss_type` (loss_obj_matching, and
    loss_sub_matching with the subject head) or `verb_loss_type`
    (loss_verb_matching): the contrastive alignment `_contrastive_align`
    (JAX :79-120, reference :4497-4619) in float32, logits over the
    temperature 0.07, padded slots at NEG; every query's positive is the
    LAST slot unless it is matched, when it is its target's one-hot object
    class or multi-hot verbs (the verbs' last column never); the sum over
    queries of the positives' mean negative logit plus the logsumexp, and
    with `matching_symmetric` the same over text slots, averaged;
  * loss_{sub,obj}_{bbox,giou}: L1 + GIoU at the matched queries, the object
    terms masked by `exist_obj = (obj_boxes != 0).any(-1)` and renormalised
    (reference :4162-4194);
  * masked-entity modeling (`recon_stat` in the outputs): the object CE (the
    subject's too with the subject head) and the box losses of the
    cross-reconstructed states at the layer's matching, suffixed `_recon`
    (JAX :456-479, reference :4119-4128);
  * the same losses for every aux decoder layer, suffixed `_{i}`, each with
    its own matching (reference :4747-4764), and `weighted_total`, with
    the exponential decay of the aux layers' six core terms
    (`exponential_loss`, JAX :624-670);
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
The JAX `tagger_losses` reads no other loss type and ignores every other
value, which the port refuses (ValueError).

Copied from the JAX package as they are (ROADMAP queue 3):
  * `weighted_bce` and `CB_focal_bce` weigh each verb by dataset
    statistics (reference hico_verb_samples.npz) that nothing loads: all
    ones, as the JAX criterion's defaults;
  * the contrastive default positive of an unmatched verb query is the last
    verb slot, which is padding whenever a batch's verb texts leave slots
    empty (HICO's 160 slots hold at most 117 verbs): its logit is NEG, so
    each such query adds about 5e8 to loss_verb_matching, a constant that
    takes no gradient.

`loss_verb_hm` (JAX :181-227) is DETRHOIhm's heatmap loss, outside
`__call__` and `weighted_total` as in the JAX criterion.

Label smoothing (`naive_obj_smooth`, `naive_verb_smooth`: config only, no
flag or script sets them) raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from rlipv2_tpu_torch.config import LossConfig
from rlipv2_tpu_torch.losses.matcher import assign, finite_costs, hoi_matching_costs, to_host, triplet_filter
from rlipv2_tpu_torch.ops.boxes import box_cxcywh_to_xyxy, box_iou
from rlipv2_tpu_torch.parallel.mesh import DataParallel
from rlipv2_tpu_torch.structures import HOITargets

NEG = -1e9
# the triplet filter's cost weights (object class, verb class, L1, GIoU),
# fixed whatever the matcher's are (reference models/hoi.py, JAX :514-522)
FILTER_WEIGHTS = dict(cost_obj_class=1.0, cost_verb_class=1.0, cost_bbox=2.5, cost_giou=1.0)
TEMPERATURE = 0.07  # the contrastive alignment's and "with_tem"'s (JAX :73)
OBJ_LOSS_TYPES = ("cross_entropy", "focal", "cross_entropy_with_tem", "focal_with_tem", "cross_modal_matching")
VERB_LOSS_TYPES = ("focal", "bce", "weighted_bce", "asymmetric_bce", "CB_focal_bce", "cross_modal_matching")
TAGGER_VERB_LOSS_TYPES = ("focal", "bce")
# the terms of every decoder layer that the exponential aux decay scales
EXPONENTIAL_KEYS = ("loss_sub_bbox", "loss_obj_bbox", "loss_sub_giou", "loss_obj_giou", "loss_obj_ce", "loss_verb_ce")


def check_supported(cfg: LossConfig, tagger: bool = False) -> None:
    """Raise ValueError on a loss type the JAX criterion does not know, or
    that the R-Tagger's `tagger_losses` (`tagger`) would ignore (it reads
    "bce" or else runs the focal form, and no object loss type);
    NotImplementedError on label smoothing, which no flag or script sets."""
    if cfg.obj_loss_type not in OBJ_LOSS_TYPES:
        raise ValueError(f"obj_loss_type {cfg.obj_loss_type!r}; known: {OBJ_LOSS_TYPES}")
    if cfg.verb_loss_type not in VERB_LOSS_TYPES:
        raise ValueError(f"verb_loss_type {cfg.verb_loss_type!r}; known: {VERB_LOSS_TYPES}")
    if tagger and (cfg.verb_loss_type not in TAGGER_VERB_LOSS_TYPES
                   or cfg.obj_loss_type != LossConfig().obj_loss_type):
        raise ValueError(f"the R-Tagger's losses take verb_loss_type {' or '.join(TAGGER_VERB_LOSS_TYPES)} and the "
                         f"default obj_loss_type (the JAX tagger_losses ignores any other), not "
                         f"{cfg.verb_loss_type!r} and {cfg.obj_loss_type!r}")
    smoothing = [k for k in ("naive_obj_smooth", "naive_verb_smooth") if getattr(cfg, k) > 0]
    if smoothing:
        raise NotImplementedError(f"{', '.join(smoothing)}: not ported, since no flag or script sets them "
                                  "(ROADMAP queue 1 item 14)")


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


def _pos_neg(gt: torch.Tensor, slot_valid: torch.Tensor) -> tuple:
    """The positive (gt == 1) and negative (gt < 1) cells of (B, Q, V)
    targets at the valid verb slots, as float masks."""
    mask = slot_valid[:, None, :].float()
    return (gt == 1).float() * mask, (gt < 1).float() * mask


def _per_positive(num_pos, pos_loss, neg_loss) -> torch.Tensor:
    """-(pos + neg) / num_pos, or -neg where no cell is positive: the
    normalisation of every focal and BCE form."""
    return torch.where(num_pos > 0, -(pos_loss + neg_loss) / num_pos.clamp(min=1.0), -neg_loss)


@dataclasses.dataclass
class SetCriterionHOI:
    cfg: LossConfig
    subject_class: bool = False
    pseudo_verb: bool = False
    tagger: bool = False
    # the data axis (`parallel/mesh.py`) of a data-parallel step, which sets
    # it: every normalizer is then the global batch's and every term this
    # rank's share of the global term (see `_total`)
    dp: Optional[DataParallel] = None

    def __post_init__(self):
        check_supported(self.cfg, self.tagger)

    def _total(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch's value of the per-rank count `x` (a
        normalizer, a metric's numerator): its sum over the data-parallel
        ranks, without gradient; `x` itself in one process. The JAX step
        computes each normalizer over the global batch, since it is one
        program; with the global normalizer every rank's term is its share
        of the global term, and the shares (and their gradients) sum to
        it."""
        return x if self.dp is None else self.dp.sum(x)

    def _share(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of a value it computes whole: a mean over its
        equal part of the batch, or a metric of global counts."""
        return x if self.dp is None else self.dp.share(x)

    def _obj_ce(self, logits, match, labels, valid, slot_valid):
        """Weighted CE with no-object = last slot, in the focal form when
        the loss type says "focal", the logits over the temperature when it
        says "with_tem"; returns (loss, err %)."""
        B, Q, T = logits.shape
        no_obj = T - 1
        target = _scatter_to_queries(
            torch.full((B, Q), no_obj, dtype=torch.long, device=logits.device), match, valid, labels
        )
        logits = logits.float()
        if "with_tem" in self.cfg.obj_loss_type:
            logits = logits / TEMPERATURE
        logp = torch.log_softmax(logits.masked_fill(~slot_valid[:, None, :], NEG), dim=-1)
        nll = -torch.gather(logp, 2, target[..., None])[..., 0]  # (B, Q)
        w = torch.where(target == no_obj, self.cfg.eos_coef, 1.0)
        if "focal" in self.cfg.obj_loss_type:
            loss = self._share(((1 - torch.exp(-nll)) ** 2 * nll * w).mean())
        else:
            loss = (nll * w).sum() / self._total(w.sum())
        with torch.no_grad():
            pred_at = _gather_queries(logits.argmax(-1), match)
            correct = self._total(((pred_at == labels) & valid).sum())
            err = self._share(100.0 * (1.0 - correct / self._total(valid.sum()).clamp(min=1)))
        return loss, err

    def _contrastive_align(self, logits, match, positive_rows, valid, slot_valid):
        """The contrastive alignment of queries and text slots (JAX :79-120).
        positive_rows (B, M, T) bool: each target's positive slots. Every
        query's positives default to the LAST slot; the matched queries'
        are their targets' rows. Float32 whatever the caller's autocast:
        1 / temperature amplifies bf16 error. Returns the sum-reduced loss."""
        B, Q, T = logits.shape
        logits = (logits.float() / TEMPERATURE).masked_fill(~slot_valid[:, None, :], NEG)
        last = torch.zeros((B, Q, T), dtype=torch.bool, device=logits.device)
        last[..., -1] = True
        pos = _scatter_to_queries(last, match, valid, positive_rows)
        posf = pos.float()

        def direction(dim):
            """The positives' mean negative logit plus the logsumexp, summed
            over the rows of `dim`'s complement that have a positive."""
            term = (-logits * posf).sum(dim) / (posf.sum(dim) + 1e-6) + torch.logsumexp(logits, dim)
            return torch.where(pos.any(dim), term, torch.zeros_like(term)).sum()

        v2t = direction(-1)  # each query over the text slots
        if not self.cfg.matching_symmetric:
            return v2t
        return (v2t + direction(1)) / 2.0  # and each text slot over the queries

    def _neg_loss(self, pred, gt, mask):
        """CornerNet focal (reference models/hoi.py:4455-4479) over the
        cells of `mask` (broadcast to pred's shape)."""
        eps = 1e-6
        pred = pred.clamp(eps, 1.0 - eps)
        mask = mask.to(pred.dtype)
        pos = (gt == 1).to(pred.dtype) * mask
        neg = (gt < 1).to(pred.dtype) * mask
        pos_loss = torch.log(pred) * (1 - pred) ** 2 * pos
        neg_loss = torch.log(1 - pred) * pred**2 * (1.0 - gt) ** 4 * neg
        return _per_positive(self._total(pos.sum()), pos_loss.sum(), neg_loss.sum())

    @staticmethod
    def loss_verb_hm(outputs: dict, gt_verb_hm: torch.Tensor) -> dict:
        """DETRHOIhm's heatmap loss (JAX :181-227, reference models/hoi.py:
        4244-4258): the CornerNet focal of `_neg_loss` between the predicted
        verb heatmap and each image's GT map nearest-resized onto the
        image's valid region (row i of h valid rows reads GT row
        i * Hg // h), per image, the padded region out; summed over images.
        outputs["verb_hm"] = (pred (B, C, h, w) sigmoid probabilities, pad
        (B, h, w) True = padding); gt_verb_hm (B, C, Hg, Wg). Float32. The
        JAX `weighted_total` gives it no weight: a caller adds it."""
        pred, pad = outputs["verb_hm"]
        pred, gt = pred.float(), gt_verb_hm.float()
        B, C, h, w = pred.shape
        Hg, Wg = gt.shape[2:]
        valid_1 = (~pad[:, :, 0]).sum(1)  # (B,) valid rows
        valid_2 = (~pad[:, 0, :]).sum(1)
        iy = torch.arange(h, device=pred.device)[None]
        ix = torch.arange(w, device=pred.device)[None]
        gy = (iy * Hg // valid_1[:, None].clamp(min=1)).clamp(0, Hg - 1)  # (B, h)
        gx = (ix * Wg // valid_2[:, None].clamp(min=1)).clamp(0, Wg - 1)  # (B, w)
        b = torch.arange(B, device=pred.device)[:, None, None, None]
        c = torch.arange(C, device=pred.device)[None, :, None, None]
        gt = gt[b, c, gy[:, None, :, None], gx[:, None, None, :]]  # (B, C, h, w)
        region = ((iy < valid_1[:, None])[:, None, :, None] & (ix < valid_2[:, None])[:, None, None, :]).float()
        p = pred.clamp(1e-6, 1.0 - 1e-6)
        pos = (gt == 1).float() * region
        neg = (gt < 1).float() * region
        pos_loss = (torch.log(p) * (1 - p) ** 2 * pos).sum(dim=(1, 2, 3))
        neg_loss = (torch.log(1 - p) * p**2 * (1 - gt) ** 4 * neg).sum(dim=(1, 2, 3))
        return {"loss_verb_hm": _per_positive(pos.sum(dim=(1, 2, 3)), pos_loss, neg_loss).sum()}

    def _soft_neg_loss(self, pred, gt, slot_valid, beta=2.0):
        """QFL-style soft focal (reference models/hoi.py:4481-4496)."""
        eps = 1e-6
        pred = pred.clamp(eps, 1.0 - eps)
        mask = slot_valid[:, None, :].to(pred.dtype)
        loss = (gt - pred).abs() ** beta * ((1 - gt) * torch.log(1 - pred) + gt * torch.log(pred)) * mask
        num_pos = self._total(((gt > 0).to(pred.dtype) * mask).sum())
        return torch.where(num_pos > 0, -loss.sum() / num_pos.clamp(min=1.0), -loss.sum())

    def _weighted_bce(self, pred, gt, slot_valid, eps=1e-6):
        """BCE with per-verb negative weights (reference models/hoi.py:
        4353-4375), which nothing loads: all one, as in the JAX criterion."""
        pred = pred.clamp(eps, 1.0 - eps)
        pos, neg = _pos_neg(gt, slot_valid)
        return _per_positive(self._total(pos.sum()), (torch.log(pred) * pos).sum(), (torch.log(1 - pred) * neg).sum())

    def _asymmetric_bce(self, pred, gt, slot_valid, eps=1e-6, gamma_pos=0.0, gamma_neg=3.0, m=0.01, vol=1.0):
        """Asymmetric focal BCE with a probability margin on the negatives
        (reference models/hoi.py:4405-4434)."""
        pos, neg = _pos_neg(gt, slot_valid)
        pred_p = pred.clamp(eps, 1.0)
        pos_loss = (torch.log(pred_p) * (1 - pred_p) ** gamma_pos * vol * pos).sum()
        pred_m = (pred - m).clamp(0.0, 1.0 - eps)
        neg_loss = (torch.log(1 - pred_m) * pred_m**gamma_neg * (1.0 - gt) ** 4 * vol * neg).sum()
        return _per_positive(self._total(pos.sum()), pos_loss, neg_loss)

    def _cb_focal_bce(self, pred, gt, slot_valid, eps=1e-6, gamma=2.0, alpha=0.5, vol=2.0, beta=0.9999):
        """Class-balanced focal BCE (reference models/hoi.py:4377-4403),
        each verb weighted by (1 - beta) / (1 - beta^n) of its sample count
        n; nothing loads the counts, so every n is one, as in the JAX
        criterion (in float32 the weight is not exactly 1)."""
        counts = torch.ones(pred.shape[-1], dtype=pred.dtype, device=pred.device)
        bw = (1 - beta) / (1 - torch.pow(torch.tensor(beta, dtype=pred.dtype, device=pred.device), counts))
        pred = pred.clamp(eps, 1.0 - eps)
        pos, neg = _pos_neg(gt, slot_valid)
        pos_loss = (torch.log(pred) * (1 - pred) ** gamma * alpha * vol * pos * bw).sum()
        neg_loss = (torch.log(1 - pred) * pred**gamma * (1.0 - gt) ** 4 * (1 - alpha) * vol * neg * bw).sum()
        return _per_positive(self._total(pos.sum()), pos_loss, neg_loss)

    def _verb_loss(self, verb_logits, match, targets: HOITargets, verb_valid, giou_cost, target_verb_sim,
                   curing_score):
        c = self.cfg
        B, Q, V = verb_logits.shape
        labels = targets.verb_labels.float()
        if c.giou_verb_label:
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
        logits = verb_logits.float()
        if c.verb_loss_type == "bce":  # over every query's valid verb slots; no curing (JAX :259-266)
            mask = verb_valid[:, None, :].float()
            bce = logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
            return (bce * mask).sum() / (self._total(mask.sum()) * Q).clamp(min=1.0)
        pred = torch.sigmoid(logits)
        if curing_score is not None:  # the pair-quality score (JAX :268-272)
            pred = pred * curing_score.float()
        if c.verb_loss_type == "weighted_bce":
            return self._weighted_bce(pred, target, verb_valid)
        if c.verb_loss_type == "asymmetric_bce":
            return self._asymmetric_bce(pred, target, verb_valid)
        if c.verb_loss_type == "CB_focal_bce":
            return self._cb_focal_bce(pred, target, verb_valid)
        if c.giou_verb_label:
            return self._soft_neg_loss(pred, target, verb_valid)
        return self._neg_loss(pred, target, verb_valid[:, None, :])

    def _box_losses(self, outputs, match, targets: HOITargets, num_interactions):
        src_sub = _gather_queries(outputs["pred_sub_boxes"].float(), match)
        src_obj = _gather_queries(outputs["pred_obj_boxes"].float(), match)
        tv = targets.valid.float()
        exist_obj = (targets.obj_boxes != 0).any(-1).float() * tv
        l1_sub = (src_sub - targets.sub_boxes).abs().sum(-1) * tv
        l1_obj = (src_obj - targets.obj_boxes).abs().sum(-1) * exist_obj
        g_sub = paired_generalized_box_iou(box_cxcywh_to_xyxy(src_sub), box_cxcywh_to_xyxy(targets.sub_boxes))
        g_obj = paired_generalized_box_iou(box_cxcywh_to_xyxy(src_obj), box_cxcywh_to_xyxy(targets.obj_boxes))
        n_obj = self._total(exist_obj.sum()) + 1e-4
        return {
            "loss_sub_bbox": l1_sub.sum() / num_interactions,
            "loss_obj_bbox": l1_obj.sum() / n_obj,
            "loss_sub_giou": ((1.0 - g_sub) * tv).sum() / num_interactions,
            "loss_obj_giou": ((1.0 - g_obj) * exist_obj).sum() / n_obj,
        }

    def _class_ce(self, outputs, match, targets: HOITargets, obj_valid):
        """The object CE plus, with the subject head, the subject's: (loss,
        object err %, subject err % or None)."""
        loss, err = self._obj_ce(outputs["pred_obj_logits"], match, targets.obj_labels, targets.valid, obj_valid)
        sub_err = None
        if self.subject_class:
            sub_loss, sub_err = self._obj_ce(outputs["pred_sub_logits"], match, targets.sub_labels,
                                             targets.valid, obj_valid)
            loss = loss + sub_loss
        return loss, err, sub_err

    def _single(self, outputs, match, giou_cost, targets, obj_valid, verb_valid, num_interactions,
                target_verb_sim, log):
        c = self.cfg
        losses = {}
        if c.obj_loss_type == "cross_modal_matching":
            T = outputs["pred_obj_logits"].shape[-1]
            for side in ("obj", "sub") if self.subject_class else ("obj",):
                labels = torch.where(targets.valid, getattr(targets, f"{side}_labels").long(), 0)
                rows = F.one_hot(labels, T).bool() & targets.valid[..., None]
                losses[f"loss_{side}_matching"] = self._contrastive_align(
                    outputs[f"pred_{side}_logits"], match, rows, targets.valid, obj_valid)
        else:
            loss, err, sub_err = self._class_ce(outputs, match, targets, obj_valid)
            if log and sub_err is not None:
                losses["sub_class_error"] = sub_err
            losses["loss_obj_ce"] = loss
            if log:
                losses["obj_class_error"] = err
        with torch.no_grad():
            logits = outputs["pred_obj_logits"]
            card_pred = (logits.argmax(-1) != logits.shape[-1] - 1).sum(-1).float()
            tgt_len = targets.valid.sum(-1).float()
            losses["obj_cardinality_error"] = self._share((card_pred - tgt_len).abs().mean())
        if c.verb_loss_type == "cross_modal_matching":
            rows = (targets.verb_labels > 0) & targets.valid[..., None]
            rows[..., -1] = False  # the last slot is never a target's positive (JAX :439-447)
            losses["loss_verb_matching"] = self._contrastive_align(
                outputs["pred_verb_logits"], match, rows, targets.valid, verb_valid)
        else:
            losses["loss_verb_ce"] = self._verb_loss(outputs["pred_verb_logits"], match, targets, verb_valid,
                                                     giou_cost, target_verb_sim, outputs.get("curing_score"))
        losses.update(self._box_losses(outputs, match, targets, num_interactions))
        if "recon_stat" in outputs:  # masked-entity modeling (JAX :456-479), whatever obj_loss_type is
            recon = outputs["recon_stat"]
            losses["loss_obj_ce_recon"] = self._class_ce(recon, match, targets, obj_valid)[0]
            losses.update({f"{k}_recon": v for k, v in self._box_losses(recon, match, targets,
                                                                         num_interactions).items()})
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
            gather = None if self.dp is None else self.dp.gather_numpy
            valid = triplet_filter(F, assign(F, valid), valid, gather=gather)
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
        num_interactions = self._total(targets.valid.sum().float()).clamp(min=1.0)
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
        losses = self._box_losses(outputs, slots, targets, self._total(v.sum()).clamp(min=1.0))

        def slot_ce(logits, labels):
            T = logits.shape[-1]
            logp = torch.log_softmax(logits.float().masked_fill(~obj_valid[:, None, :], NEG), dim=-1)
            nll = -torch.gather(logp, 2, labels.long()[..., None])[..., 0]
            w = torch.where(labels == T - 1, c.eos_coef, 1.0) * v
            return (nll * w).sum() / self._total(w.sum()).clamp(min=1e-4)

        losses["loss_obj_ce"] = (slot_ce(outputs["pred_obj_logits"], targets.obj_labels)
                                 + slot_ce(outputs["pred_sub_logits"], targets.sub_labels))
        logits = outputs["pred_verb_logits"].float()
        target = targets.verb_labels.float() * v[..., None]
        mask = (verb_valid[:, None, :] & targets.valid[..., None]).float()
        if c.verb_loss_type == "bce":
            bce = logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
            losses["loss_verb_ce"] = (bce * mask).sum() / self._total(mask.sum()).clamp(min=1.0)
        else:
            losses["loss_verb_ce"] = self._neg_loss(torch.sigmoid(logits), target, mask)
        return losses

    def weighted_total(self, losses: dict) -> torch.Tensor:
        """Weighted sum over the loss terms, aux layers included, with the
        reference's weight_dict (models/detr.py:571-621 + engine.py:106-109):
        the contrastive terms take the class coefficients, the `_recon`
        terms theirs times `masked_loss_coef`; with `exponential_loss` the
        aux layer i's six core terms (EXPONENTIAL_KEYS) take
        exponential_hyper^(dec_layers - 1 - i) more, dec_layers derived from
        the largest aux index as in JAX (:624-670). Metrics (class and
        cardinality errors) carry no weight."""
        c = self.cfg
        w = {
            "loss_obj_ce": c.obj_loss_coef,
            "loss_verb_ce": c.verb_loss_coef,
            "loss_sub_bbox": c.bbox_loss_coef,
            "loss_obj_bbox": c.bbox_loss_coef,
            "loss_sub_giou": c.giou_loss_coef,
            "loss_obj_giou": c.giou_loss_coef,
            "loss_sub_matching": c.obj_loss_coef,
            "loss_obj_matching": c.obj_loss_coef,
            "loss_verb_matching": c.verb_loss_coef,
        }
        w.update({f"{k}_recon": w[k] * c.masked_loss_coef for k in
                  ("loss_obj_ce", "loss_sub_bbox", "loss_obj_bbox", "loss_sub_giou", "loss_obj_giou")})
        aux = [int(k.rsplit("_", 1)[1]) for k in losses if k.rsplit("_", 1)[-1].isdigit()]
        dec_layers = max(aux) + 2 if aux else 1
        total = 0.0
        for k, v in losses.items():
            base, tail = k.rsplit("_", 1) if k.rsplit("_", 1)[-1].isdigit() else (k, None)
            if base not in w:
                continue
            coef = w[base]
            if tail is not None and c.exponential_loss and base in EXPONENTIAL_KEYS:
                coef = coef * c.exponential_hyper ** (dec_layers - 1 - int(tail))
            total = total + coef * v
        return total
