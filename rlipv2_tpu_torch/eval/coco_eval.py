"""COCO bbox mAP evaluator (a copy of rlipv2_tpu/eval/coco_eval.py): the
COCOeval protocol in plain numpy, no pycocotools dependency, for the
detector path (`models/detection.py::coco_evaluate`). Its bbox branch, as
the reference's CocoEvaluator wraps pycocotools' (reference
datasets/coco_eval.py):
  * 10 IoU thresholds 0.50:0.05:0.95, 101 recall points 0:0.01:1;
  * greedy per-image matching in descending score order, each detection
    taking the best still-free GT with IoU >= t; already-matched GTs may
    be re-taken only by crowd logic (crowd GTs use the detection-area
    denominator and can match many detections);
  * GTs outside the area range are "ignore": they can absorb detections
    (neither TP nor FP) but never count toward recall;
  * detections beyond maxDets dropped after score sorting;
  * precision envelope (monotone non-increasing from the right) sampled
    at the recall thresholds; AP = mean over IoU x recall x category.

Standard summary: AP, AP50, AP75, APsmall/medium/large, AR@100.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray):
    """COCO IoU: crowd GTs use intersection / det-area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx0, dy0 = dets[:, 0], dets[:, 1]
    dx1, dy1 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx0, gy0 = gts[:, 0], gts[:, 1]
    gx1, gy1 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(
        np.minimum(dx1[:, None], gx1[None]) - np.maximum(dx0[:, None], gx0[None]),
        0, None,
    )
    ih = np.clip(
        np.minimum(dy1[:, None], gy1[None]) - np.maximum(dy0[:, None], gy0[None]),
        0, None,
    )
    inter = iw * ih
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-12)


class CocoBboxEvaluator:
    """gt: COCO-format dict (images/annotations/categories) or a
    pre-grouped {(img_id, cat_id): [ann, ...]}; predictions: list of
    {image_id, category_id, bbox xywh, score}."""

    def __init__(self, gt_json: dict, max_dets: int = 100):
        self.max_dets = max_dets
        self.img_ids = [im["id"] for im in gt_json["images"]]
        self.cat_ids = sorted(
            {c["id"] for c in gt_json.get("categories", [])}
            or {a["category_id"] for a in gt_json["annotations"]}
        )
        self.gts = defaultdict(list)
        for a in gt_json["annotations"]:
            self.gts[(a["image_id"], a["category_id"])].append(a)

    def evaluate(self, predictions: Sequence[dict]) -> dict:
        dts = defaultdict(list)
        for p in predictions:
            dts[(p["image_id"], p["category_id"])].append(p)

        T, R = len(IOU_THRS), len(REC_THRS)
        K, A = len(self.cat_ids), len(AREA_RANGES)
        # pycocotools-shaped accumulators (T, R, K, A, M) with M=1 maxDets
        # setting and -1 fill for absent categories — the layout
        # plot_precision_recall / reference util/plot_utils.py:90-99 read
        # from the torch.save'd coco_eval.eval (reference main.py:709,802)
        P_full = -np.ones((T, R, K, A, 1))
        S_full = -np.ones((T, R, K, A, 1))
        R_full = -np.ones((T, K, A, 1))
        results = {}
        ap_all = {}
        for ai, (area_name, rng) in enumerate(AREA_RANGES.items()):
            precisions = []  # per category: (T, R)
            recalls = []
            for ki, cat in enumerate(self.cat_ids):
                tps, fps, scores = [], [], []
                n_pos = 0
                for img in self.img_ids:
                    gt = self.gts.get((img, cat), [])
                    dt = sorted(
                        dts.get((img, cat), []),
                        key=lambda d: -d["score"],
                    )[: self.max_dets]
                    g_boxes = np.asarray(
                        [g["bbox"] for g in gt], np.float64
                    ).reshape(-1, 4)
                    g_crowd = np.asarray(
                        [g.get("iscrowd", 0) for g in gt], np.int64
                    )
                    g_area = np.asarray(
                        [g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gt],
                        np.float64,
                    ).reshape(-1)
                    g_ignore = (
                        (g_area < rng[0]) | (g_area > rng[1]) | (g_crowd == 1)
                    )
                    n_pos += int((~g_ignore).sum())
                    d_boxes = np.asarray(
                        [d["bbox"] for d in dt], np.float64
                    ).reshape(-1, 4)
                    d_scores = np.asarray([d["score"] for d in dt])
                    d_area = d_boxes[:, 2] * d_boxes[:, 3] if len(dt) else np.zeros(0)
                    d_out_of_range = (d_area < rng[0]) | (d_area > rng[1])
                    ious = _iou_xywh(d_boxes, g_boxes, g_crowd)

                    # sort GTs: real first, ignores last (COCOeval gtind)
                    order = np.argsort(g_ignore, kind="stable")
                    ious = ious[:, order] if len(gt) else ious
                    g_ignore_s = g_ignore[order] if len(gt) else g_ignore
                    g_crowd_s = g_crowd[order] if len(gt) else g_crowd

                    tp = np.zeros((T, len(dt)), bool)
                    ig = np.zeros((T, len(dt)), bool)
                    for ti, thr in enumerate(IOU_THRS):
                        taken = np.zeros(len(gt), bool)
                        for di in range(len(dt)):
                            best, best_iou = -1, min(thr, 1 - 1e-10)
                            for gi in range(len(gt)):
                                if taken[gi] and not g_crowd_s[gi]:
                                    continue
                                # once matched to a real GT, don't switch
                                # to an ignore (COCOeval break rule)
                                if (
                                    best > -1
                                    and not g_ignore_s[best]
                                    and g_ignore_s[gi]
                                ):
                                    break
                                if ious[di, gi] < best_iou:
                                    continue
                                best_iou = ious[di, gi]
                                best = gi
                            if best == -1:
                                # unmatched det outside the area range is
                                # ignored rather than FP
                                ig[ti, di] = d_out_of_range[di]
                                continue
                            if g_ignore_s[best]:
                                ig[ti, di] = True
                            else:
                                tp[ti, di] = True
                                taken[best] = True
                    tps.append(tp)
                    fps.append(~tp & ~ig)
                    scores.append(d_scores)

                if n_pos == 0:
                    continue
                scores = np.concatenate(scores) if scores else np.zeros(0)
                order = np.argsort(-scores, kind="mergesort")
                scores_sorted = scores[order]
                tp = np.concatenate(tps, axis=1)[:, order]
                fp = np.concatenate(fps, axis=1)[:, order]
                tp_c = np.cumsum(tp, axis=1).astype(np.float64)
                fp_c = np.cumsum(fp, axis=1).astype(np.float64)
                rc = tp_c / n_pos
                pr = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)

                prec_at = np.zeros((T, R))
                score_at = np.zeros((T, R))
                rec_at = np.zeros((T,))
                for ti in range(T):
                    p = pr[ti].tolist()
                    # precision envelope
                    for i in range(len(p) - 1, 0, -1):
                        p[i - 1] = max(p[i - 1], p[i])
                    inds = np.searchsorted(rc[ti], REC_THRS, side="left")
                    for ri, pi in enumerate(inds):
                        if pi < len(p):
                            prec_at[ti, ri] = p[pi]
                            score_at[ti, ri] = scores_sorted[pi]
                    rec_at[ti] = rc[ti][-1] if len(rc[ti]) else 0.0
                precisions.append(prec_at)
                recalls.append(rec_at)
                P_full[:, :, ki, ai, 0] = prec_at
                S_full[:, :, ki, ai, 0] = score_at
                R_full[:, ki, ai, 0] = rec_at

            if precisions:
                P = np.stack(precisions)  # (C, T, R)
                Rr = np.stack(recalls)
                ap_all[area_name] = P
                results[f"AP_{area_name}"] = float(P.mean())
                results[f"AR_{area_name}"] = float(Rr.mean())
            else:
                results[f"AP_{area_name}"] = float("nan")
                results[f"AR_{area_name}"] = float("nan")

        out = {
            "mAP": results["AP_all"],
            "mAP50": (
                float(ap_all["all"][:, 0].mean()) if "all" in ap_all else float("nan")
            ),
            "mAP75": (
                float(ap_all["all"][:, 5].mean()) if "all" in ap_all else float("nan")
            ),
            "mAP_small": results["AP_small"],
            "mAP_medium": results["AP_medium"],
            "mAP_large": results["AP_large"],
            "AR@100": results["AR_all"],
        }
        self.eval = {
            "precision": P_full,
            "scores": S_full,
            "recall": R_full,
            "recThrs": REC_THRS,
            "iouThrs": IOU_THRS,
        }
        return out

    def save_eval(self, path) -> None:
        """Persist the accumulated curves as an .npz in the layout that the
        JAX package's tools/plot_logs.plot_precision_recall reads — the
        counterpart of the reference's torch.save(coco_eval.eval,
        'eval/latest.pth') (reference main.py:797-803)."""
        if not hasattr(self, "eval"):
            raise RuntimeError("call evaluate() before save_eval()")
        np.savez(path, **self.eval)


def coco_evaluate_bbox(predictions: Sequence[dict], gt_json: dict,
                       max_dets: int = 100) -> dict:
    """The evaluator's summary of `predictions` against `gt_json`, with no
    dependency (`models/detection.py::coco_evaluate` calls it when
    pycocotools does not import)."""
    return CocoBboxEvaluator(gt_json, max_dets).evaluate(predictions)
