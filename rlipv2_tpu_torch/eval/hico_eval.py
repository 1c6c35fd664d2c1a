"""HICO-DET evaluator (a copy of rlipv2_tpu/eval/hico_eval.py, whose
protocol follows the reference datasets/hico_eval.py): triplet expansion
with correct_mat masking and top-100 per image, greedy score-ordered TP/FP
matching at IoU >= 0.5 on BOTH boxes with per-GT vis_tag, 11-point VOC AP,
Full / Rare / Non-Rare means, and the optional pairwise triplet NMS
(`use_nms_filter`, rlipv2_tpu/eval/hico_eval.py:261-330: per image and
triplet class, greedy by score, dropping a prediction whose
IoU_sub^alpha * IoU_obj^beta with a kept one exceeds 0.7). Host-side
numpy: the greedy orders are part of the protocol.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from rlipv2_tpu_torch.eval.common import compute_iou_mat

# the triplet NMS: a prediction is dropped when IoU_sub ** NMS_ALPHA *
# IoU_obj ** NMS_BETA with a kept one of its triplet exceeds NMS_THRESHOLD
# (the JAX evaluator's defaults, which no caller changes)
NMS_THRESHOLD, NMS_ALPHA, NMS_BETA = 0.7, 1.0, 0.5


class HICOEvaluator:
    def __init__(
        self,
        preds,
        gts,
        rare_triplets,
        non_rare_triplets,
        correct_mat,
        max_hois: int = 100,
        overlap_iou: float = 0.5,
        use_nms_filter: bool = False,
    ):
        """preds: list of per-image dicts with numpy arrays
        {labels (2n,), boxes (2n,4) xyxy, verb_scores (n,V), sub_ids, obj_ids}
        gts: list of per-image dicts
        {filename, boxes (m,4) xyxy, labels (m,), hois (k,3) [sub, obj, verb]}
        correct_mat: (V, n_obj_classes) 0/1 valid verb-object pairs."""
        self.overlap_iou = overlap_iou
        self.max_hois = max_hois
        self.rare_triplets = set(map(tuple, rare_triplets))
        self.non_rare_triplets = set(map(tuple, non_rare_triplets))

        self.fp = defaultdict(list)
        self.tp = defaultdict(list)
        self.score = defaultdict(list)
        self.sum_gts = defaultdict(int)
        self.gt_triplets = []

        self.preds = []
        for img_preds in preds:
            bboxes = [
                {"bbox": np.asarray(bbox), "category_id": int(label)}
                for bbox, label in zip(img_preds["boxes"], img_preds["labels"])
            ]
            hoi_scores = np.asarray(img_preds["verb_scores"])  # (n, V)
            n, V = hoi_scores.shape
            verb_labels = np.tile(np.arange(V), (n, 1)).ravel()
            subject_ids = np.tile(np.asarray(img_preds["sub_ids"]), (V, 1)).T.ravel()
            object_ids = np.tile(np.asarray(img_preds["obj_ids"]), (V, 1)).T.ravel()
            hoi_scores = hoi_scores.ravel()

            if len(subject_ids) > 0:
                object_labels = np.array(
                    [bboxes[oid]["category_id"] for oid in object_ids]
                )
                masks = correct_mat[verb_labels, object_labels]
                hoi_scores = hoi_scores * masks
                hois = [
                    {
                        "subject_id": int(s),
                        "object_id": int(o),
                        "category_id": int(c),
                        "score": float(sc),
                    }
                    for s, o, c, sc in zip(
                        subject_ids, object_ids, verb_labels, hoi_scores
                    )
                ]
                hois.sort(key=lambda k: k.get("score", 0), reverse=True)
                hois = hois[: self.max_hois]
            else:
                hois = []
            self.preds.append({"predictions": bboxes, "hoi_prediction": hois})

        if use_nms_filter:
            self.preds = self.triplet_nms_filter(self.preds)

        self.gts = []
        for img_gts in gts:
            anns = [
                {"bbox": np.asarray(bbox), "category_id": int(label)}
                for bbox, label in zip(img_gts["boxes"], img_gts["labels"])
            ]
            hoi_anns = [
                {
                    "subject_id": int(h[0]),
                    "object_id": int(h[1]),
                    "category_id": int(h[2]),
                }
                for h in img_gts["hois"]
            ]
            self.gts.append({"annotations": anns, "hoi_annotation": hoi_anns})
            for hoi in hoi_anns:
                triplet = (
                    anns[hoi["subject_id"]]["category_id"],
                    anns[hoi["object_id"]]["category_id"],
                    hoi["category_id"],
                )
                if triplet not in self.gt_triplets:
                    self.gt_triplets.append(triplet)
                self.sum_gts[triplet] += 1

    # ------------------------------------------------------------------ #

    def evaluate(self):
        for img_preds, img_gts in zip(self.preds, self.gts):
            pred_bboxes = img_preds["predictions"]
            gt_bboxes = img_gts["annotations"]
            pred_hois = img_preds["hoi_prediction"]
            gt_hois = img_gts["hoi_annotation"]
            if len(gt_bboxes) != 0 and len(pred_hois) != 0:
                bbox_pairs, bbox_overlaps = self.compute_iou_mat(
                    gt_bboxes, pred_bboxes
                )
                self.compute_fptp(
                    pred_hois, gt_hois, bbox_pairs, pred_bboxes, bbox_overlaps
                )
            else:
                for pred_hoi in pred_hois:
                    triplet = (
                        pred_bboxes[pred_hoi["subject_id"]]["category_id"],
                        pred_bboxes[pred_hoi["object_id"]]["category_id"],
                        pred_hoi["category_id"],
                    )
                    if triplet not in self.gt_triplets:
                        continue
                    self.tp[triplet].append(0)
                    self.fp[triplet].append(1)
                    self.score[triplet].append(pred_hoi["score"])
        return self.compute_map()

    def compute_map(self):
        ap = {}
        rare_ap = {}
        non_rare_ap = {}
        max_recall = {}
        for triplet in self.gt_triplets:
            sum_gts = self.sum_gts[triplet]
            if sum_gts == 0:
                continue
            tp = np.array(self.tp[triplet])
            fp = np.array(self.fp[triplet])
            if len(tp) == 0:
                ap[triplet] = 0.0
                max_recall[triplet] = 0.0
                if triplet in self.rare_triplets:
                    rare_ap[triplet] = 0.0
                elif triplet in self.non_rare_triplets:
                    non_rare_ap[triplet] = 0.0
                continue
            score = np.array(self.score[triplet])
            sort_inds = np.argsort(-score)
            fp = np.cumsum(fp[sort_inds])
            tp = np.cumsum(tp[sort_inds])
            rec = tp / sum_gts
            prec = tp / (fp + tp)
            ap[triplet] = self.voc_ap(rec, prec)
            max_recall[triplet] = float(np.amax(rec))
            if triplet in self.rare_triplets:
                rare_ap[triplet] = ap[triplet]
            elif triplet in self.non_rare_triplets:
                non_rare_ap[triplet] = ap[triplet]
        m_ap = float(np.mean(list(ap.values()))) if ap else 0.0
        m_rare = float(np.mean(list(rare_ap.values()))) if rare_ap else 0.0
        m_non_rare = float(np.mean(list(non_rare_ap.values()))) if non_rare_ap else 0.0
        m_recall = float(np.mean(list(max_recall.values()))) if max_recall else 0.0
        return {
            "mAP": m_ap,
            "mAP rare": m_rare,
            "mAP non-rare": m_non_rare,
            "mean max recall": m_recall,
        }

    @staticmethod
    def voc_ap(rec, prec):
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            if np.sum(rec >= t) == 0:
                p = 0
            else:
                p = np.max(prec[rec >= t])
            ap += p / 11.0
        return ap

    def compute_fptp(self, pred_hois, gt_hois, match_pairs, pred_bboxes, bbox_overlaps):
        pos_pred_ids = match_pairs.keys()
        vis_tag = np.zeros(len(gt_hois))
        pred_hois.sort(key=lambda k: k.get("score", 0), reverse=True)
        for pred_hoi in pred_hois:
            is_match = 0
            max_gt_hoi = 0
            if (
                len(match_pairs) != 0
                and pred_hoi["subject_id"] in pos_pred_ids
                and pred_hoi["object_id"] in pos_pred_ids
            ):
                pred_sub_ids = match_pairs[pred_hoi["subject_id"]]
                pred_obj_ids = match_pairs[pred_hoi["object_id"]]
                pred_sub_overlaps = bbox_overlaps[pred_hoi["subject_id"]]
                pred_obj_overlaps = bbox_overlaps[pred_hoi["object_id"]]
                pred_category_id = pred_hoi["category_id"]
                max_overlap = 0
                for gt_hoi in gt_hois:
                    if (
                        gt_hoi["subject_id"] in pred_sub_ids
                        and gt_hoi["object_id"] in pred_obj_ids
                        and pred_category_id == gt_hoi["category_id"]
                    ):
                        is_match = 1
                        min_overlap_gt = min(
                            pred_sub_overlaps[
                                pred_sub_ids.index(gt_hoi["subject_id"])
                            ],
                            pred_obj_overlaps[
                                pred_obj_ids.index(gt_hoi["object_id"])
                            ],
                        )
                        if min_overlap_gt > max_overlap:
                            max_overlap = min_overlap_gt
                            max_gt_hoi = gt_hoi
            triplet = (
                pred_bboxes[pred_hoi["subject_id"]]["category_id"],
                pred_bboxes[pred_hoi["object_id"]]["category_id"],
                pred_hoi["category_id"],
            )
            if triplet not in self.gt_triplets:
                continue
            if is_match == 1 and vis_tag[gt_hois.index(max_gt_hoi)] == 0:
                self.fp[triplet].append(0)
                self.tp[triplet].append(1)
                vis_tag[gt_hois.index(max_gt_hoi)] = 1
            else:
                self.fp[triplet].append(1)
                self.tp[triplet].append(0)
            self.score[triplet].append(pred_hoi["score"])

    def compute_iou_mat(self, bbox_list1, bbox_list2):
        return compute_iou_mat(bbox_list1, bbox_list2, self.overlap_iou)

    def triplet_nms_filter(self, preds):
        """Per image, the predictions of each (subject class, object class,
        verb) triplet through `pairwise_nms`, in first-seen triplet order."""
        preds_filtered = []
        for img_preds in preds:
            pred_bboxes = img_preds["predictions"]
            pred_hois = img_preds["hoi_prediction"]
            all_triplets: dict = {}
            for index, pred_hoi in enumerate(pred_hois):
                sub, obj = pred_bboxes[pred_hoi["subject_id"]], pred_bboxes[pred_hoi["object_id"]]
                triplet = f"{sub['category_id']}_{obj['category_id']}_{pred_hoi['category_id']}"
                entry = all_triplets.setdefault(triplet, {"subs": [], "objs": [], "scores": [], "indexes": []})
                entry["subs"].append(sub["bbox"])
                entry["objs"].append(obj["bbox"])
                entry["scores"].append(pred_hoi["score"])
                entry["indexes"].append(index)
            keep_inds = []
            for values in all_triplets.values():
                keep = self.pairwise_nms(
                    np.array(values["subs"]), np.array(values["objs"]), np.array(values["scores"])
                )
                keep_inds.extend(list(np.array(values["indexes"])[keep]))
            preds_filtered.append(
                {"predictions": pred_bboxes, "hoi_prediction": [pred_hois[i] for i in keep_inds]}
            )
        return preds_filtered

    def pairwise_nms(self, subs, objs, scores):
        """Greedy NMS on (subject, object) box pairs, +1 pixel box areas as
        in the reference, in float64; returns the kept indices in score
        order, ties in descending index order (a stable ascending sort,
        reversed), as the JAX package's native path orders them."""
        subs, objs = np.asarray(subs, np.float64), np.asarray(objs, np.float64)
        sx1, sy1, sx2, sy2 = subs[:, 0], subs[:, 1], subs[:, 2], subs[:, 3]
        ox1, oy1, ox2, oy2 = objs[:, 0], objs[:, 1], objs[:, 2], objs[:, 3]
        sub_areas = (sx2 - sx1 + 1) * (sy2 - sy1 + 1)
        obj_areas = (ox2 - ox1 + 1) * (oy2 - oy1 + 1)
        order = np.argsort(np.asarray(scores, np.float64), kind="stable")[::-1]
        keep_inds = []
        while order.size > 0:
            i, rest = order[0], order[1:]
            keep_inds.append(i)
            sw = np.maximum(0.0, np.minimum(sx2[i], sx2[rest]) - np.maximum(sx1[i], sx1[rest]) + 1)
            sh = np.maximum(0.0, np.minimum(sy2[i], sy2[rest]) - np.maximum(sy1[i], sy1[rest]) + 1)
            sub_inter = sw * sh
            sub_union = sub_areas[i] + sub_areas[rest] - sub_inter
            ow = np.maximum(0.0, np.minimum(ox2[i], ox2[rest]) - np.maximum(ox1[i], ox1[rest]) + 1)
            oh = np.maximum(0.0, np.minimum(oy2[i], oy2[rest]) - np.maximum(oy1[i], oy1[rest]) + 1)
            obj_inter = ow * oh
            obj_union = obj_areas[i] + obj_areas[rest] - obj_inter
            ovr = np.power(sub_inter / sub_union, NMS_ALPHA) * np.power(obj_inter / obj_union, NMS_BETA)
            order = rest[np.where(ovr <= NMS_THRESHOLD)[0]]
        return keep_inds
