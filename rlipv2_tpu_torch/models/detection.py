"""The plain object-detection path (counterpart of
rlipv2_tpu/models/detection.py; reference models/detr.py:99-302, 510-519,
engine.py:204-289): a COCO DETR detector whose checkpoints the converters
of `engine/convert.py` map into the HOI models' key space.

  * DETRDetector — one stride-32 ResNet level, DETR sine positions,
    `input_proj`, `models/parse.py`'s dense encoder and decoder from zero
    targets at the learned query positions, a `num_classes + 1`-way class
    head and a 3-layer box MLP on every decoder layer's states. As the JAX
    class, no final decoder LayerNorm is applied, where reference DETR
    applies `transformer.decoder.norm` to every layer's output (ROADMAP
    queue 3), and the padding mask is `downsample_mask`'s.
  * detection_matching_costs / detection_losses — DETR's matcher costs
    (class -prob, L1 and -GIoU) and SetCriterion: CE with the no-object
    class weighted `eos_coef`, L1 and GIoU over the matched pairs divided by
    the count of valid targets, `cardinality_error`, and the aux layers'
    terms with the suffix `_{i}`. The assignment runs on the host
    (`losses/matcher.py::assign`, scipy) over the valid target slots, for
    every layer after one copy of the costs.
  * postprocess_detection — softmax without the no-object column, each
    query's best class, xyxy boxes in the original pixels, the top k by
    score with ties in query order (a stable sort, as the JAX argsort).
  * coco_evaluate — pycocotools' COCOeval where it imports, else the numpy
    evaluator of `eval/coco_eval.py`.

Parameter names are reference DETR's:
  backbone.0.body.*                     <- ResNet_0
  input_proj (1x1 Conv2d)               <- input_proj (Dense)
  transformer.encoder.layers.{i}        <- enc_{i}
  transformer.decoder.layers.{i}.{self_attn, multihead_attn, norm1-3, linear1, linear2}
                                        <- dec_{i}.{self_attn, cross_attn, ...}
  query_embed, class_embed, bbox_embed.layers.{0,1,2}
                                        <- the same names
`engine/convert.py::detector_state_dict_from_jax` maps the flax tree.
`cfg.dtype == "bfloat16"` runs the forward under bf16 autocast.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from rlipv2_tpu_torch.config import ModelConfig
from rlipv2_tpu_torch.losses.matcher import assign, finite_costs, to_host
from rlipv2_tpu_torch.models.closed_vocab import top_k_lower_index_first
from rlipv2_tpu_torch.models.layers import MLP, normalize_pixels
from rlipv2_tpu_torch.models.parse import DecoderLayer, DenseDecoder, DenseEncoder, dense_tokens
from rlipv2_tpu_torch.models.parseda import _Backbone
from rlipv2_tpu_torch.ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou


class DETRDecoderLayer(DecoderLayer):
    """DecoderLayer under reference DETR's name of the cross-attention."""

    CROSS = "multihead_attn"


class _DETRTransformer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        t = cfg.transformer
        self.encoder = DenseEncoder(t, t.enc_layers)
        self.decoder = DenseDecoder(t, t.dec_layers, DETRDecoderLayer)


class DETRDetector(nn.Module):
    def __init__(self, cfg: ModelConfig, num_classes: int = 91):
        super().__init__()
        if not cfg.backbone.name.startswith("resnet"):
            raise NotImplementedError(f"DETRDetector takes a ResNet backbone (as its JAX class), "
                                      f"not {cfg.backbone.name}")
        self.cfg, self.num_classes = cfg, num_classes
        d = cfg.transformer.hidden_dim
        backbone = _Backbone(cfg, num_outputs=1)
        self.backbone = nn.ModuleList([backbone])
        self.input_proj = nn.Conv2d(backbone.body.out_channels[-1], d, 1)
        self.transformer = _DETRTransformer(cfg)
        self.query_embed = nn.Embedding(cfg.num_queries, d)
        self.class_embed = nn.Linear(d, num_classes + 1)
        self.bbox_embed = MLP(d, d, 4, 3)

    def forward(self, pixels: torch.Tensor, pixel_valid: torch.Tensor) -> dict:
        """pixels (B, H, W, 3) uint8 or normalized float32; pixel_valid
        (B, H, W) bool, True = real pixel -> `pred_logits` (B, nq,
        num_classes + 1) and `pred_boxes` (B, nq, 4) cxcywh in (0, 1), with
        `cfg.aux_loss` the other layers' as `aux_outputs`."""
        with torch.autocast(device_type=pixels.device.type, dtype=torch.bfloat16,
                            enabled=self.cfg.dtype == "bfloat16"):
            feat = self.backbone[0].body(normalize_pixels(pixels))[-1]
            src, pos, valid = dense_tokens(feat, self.input_proj, pixel_valid)
            tr = self.transformer
            memory = tr.encoder(src, pos, valid)
            qpos = self.query_embed.weight[None].expand(src.shape[0], *self.query_embed.weight.shape)
            hs = tr.decoder(torch.zeros_like(qpos), qpos, memory, pos, valid)
            logits = self.class_embed(hs).float()
            boxes = torch.sigmoid(self.bbox_embed(hs)).float()
        out = {"pred_logits": logits[-1], "pred_boxes": boxes[-1]}
        if self.cfg.aux_loss:
            out["aux_outputs"] = [{"pred_logits": logits[i], "pred_boxes": boxes[i]} for i in range(len(hs) - 1)]
        return out


def detection_matching_costs(outputs: dict, labels: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                             cost_class: float = 1.0, cost_bbox: float = 5.0, cost_giou: float = 2.0) -> torch.Tensor:
    """DETR's matcher costs (reference models/matcher.py:22-92): outputs of
    one layer, labels (B, M) int, boxes (B, M, 4) cxcywh, valid (B, M) bool
    -> (B, Q, M) float32, 0 at the padded target slots."""
    prob = torch.softmax(outputs["pred_logits"].float(), -1)
    Q = prob.shape[1]
    c_cls = -torch.gather(prob, 2, labels.long()[:, None, :].expand(-1, Q, -1))
    pb = outputs["pred_boxes"].float()
    c_bbox = (pb[:, :, None] - boxes[:, None]).abs().sum(-1)
    c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pb), box_cxcywh_to_xyxy(boxes))
    total = cost_class * c_cls + cost_bbox * c_bbox + cost_giou * c_giou
    return torch.where(valid[:, None, :], total, torch.zeros_like(total))


def _layer_losses(out: dict, labels, boxes, valid, match, num_classes: int, eos_coef: float) -> dict:
    logits = out["pred_logits"].float()
    B, Q, _ = logits.shape
    # the class target of every query: the matched GT label, else no-object;
    # padded slots scatter into a dropped column Q
    target = torch.full((B, Q + 1), num_classes, dtype=torch.long, device=logits.device)
    target.scatter_(1, torch.where(valid, match, torch.full_like(match, Q)), labels.long())
    target = target[:, :Q]
    nll = -torch.gather(F.log_softmax(logits, -1), 2, target[..., None])[..., 0]
    wgt = torch.where(target == num_classes, eos_coef, 1.0)
    loss_ce = (nll * wgt).sum() / wgt.sum()

    num = valid.sum().float().clamp(min=1.0)
    v = valid.float()
    src_b = torch.gather(out["pred_boxes"].float(), 1, match[..., None].expand(-1, -1, 4))
    l1 = ((src_b - boxes).abs().sum(-1) * v).sum() / num
    g = torch.diagonal(generalized_box_iou(box_cxcywh_to_xyxy(src_b), box_cxcywh_to_xyxy(boxes)), dim1=-2, dim2=-1)
    giou = ((1.0 - g) * v).sum() / num
    card = ((logits.argmax(-1) != num_classes).sum(-1) - valid.sum(-1)).abs().float().mean()
    return {"loss_ce": loss_ce, "loss_bbox": l1, "loss_giou": giou, "cardinality_error": card}


def detection_losses(outputs: dict, labels: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                     num_classes: int, eos_coef: float = 0.1) -> dict:
    """SetCriterion's detection losses (reference models/detr.py:99-246) of
    the last layer and, with the suffix `_{i}`, of each aux layer; every
    layer matched on its own costs."""
    layers = [{k: v for k, v in outputs.items() if k != "aux_outputs"}, *outputs.get("aux_outputs", [])]
    costs = torch.stack([detection_matching_costs(o, labels, boxes, valid) for o in layers])
    host_costs, host_valid = to_host([costs, valid])
    match = torch.from_numpy(assign(finite_costs(host_costs), host_valid.astype(bool))).to(labels.device)
    losses = _layer_losses(layers[0], labels, boxes, valid, match[0], num_classes, eos_coef)
    for i, aux in enumerate(layers[1:]):
        for k, v in _layer_losses(aux, labels, boxes, valid, match[i + 1], num_classes, eos_coef).items():
            losses[f"{k}_{i}"] = v
    return losses


def postprocess_detection(outputs: dict, orig_sizes: torch.Tensor, top_k: int = 100) -> dict:
    """DETR's PostProcess (reference models/detr.py:258-302): orig_sizes
    (B, 2) as (h, w) -> `scores`, `labels` (B, k) and `boxes` (B, k, 4) xyxy
    in pixels of the k = min(top_k, queries) best queries, ties in query
    order."""
    prob = torch.softmax(outputs["pred_logits"].float(), -1)[..., :-1]
    scores, labels = prob.max(-1).values, prob.argmax(-1)
    h, w = orig_sizes[:, 0], orig_sizes[:, 1]
    scale = torch.stack([w, h, w, h], 1).float()[:, None]
    boxes = box_cxcywh_to_xyxy(outputs["pred_boxes"].float()) * scale
    idx = top_k_lower_index_first(scores, min(top_k, scores.shape[1]))
    return {"scores": torch.gather(scores, 1, idx), "labels": torch.gather(labels, 1, idx),
            "boxes": torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))}


def coco_evaluate(predictions: list, coco_gt_path) -> Optional[dict]:
    """COCO bbox mAP (reference datasets/coco_eval.py) of predictions
    [{image_id, category_id, bbox xywh, score}] against the COCO json at
    `coco_gt_path`: pycocotools' COCOeval when it imports (mAP and mAP50),
    else `eval/coco_eval.py::coco_evaluate_bbox` (the full summary)."""
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        import json

        from rlipv2_tpu_torch.eval.coco_eval import coco_evaluate_bbox

        with open(coco_gt_path) as f:
            gt_json = json.load(f)
        return coco_evaluate_bbox(predictions, gt_json)
    coco = COCO(str(coco_gt_path))
    ev = COCOeval(coco, coco.loadRes(predictions), "bbox")
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return {"mAP": float(ev.stats[0]), "mAP50": float(ev.stats[1])}

