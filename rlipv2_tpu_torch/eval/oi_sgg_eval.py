"""Open Images v6 SGG evaluator, a numpy copy of
rlipv2_tpu/eval/oi_sgg_eval.py, whose protocol follows the reference
datasets/oi_sgg_eval.py:17-620: Relationship Detection and Phrase
Detection at top-K (run twice, 50 and 100), per-triplet 11-point AP,
weighted mAP (GT-count weighted), mean/max recall, pairwise triplet NMS +
phrase NMS, and the published composite score
score_wtd = 0.2*R@50 + 0.4*wmAP_rel + 0.4*wmAP_phr (reference :221-222).

Phrases are the minimum bounding rectangles of (sub, obj) with the full
triplet as their category id (tuple equality drives phrase IoU matching).
The triplet NMS is the HICO evaluator's `triplet_nms_filter` (its
thresholds, and the JAX native core's order of tied scores); the phrase NMS
drops a phrase whose +1-pixel IoU with a kept one of its triplet exceeds
PHRASE_NMS_THRESHOLD. The JAX evaluator's options that no caller sets (a
(sub, rel, obj) correct_mat and other NMS thresholds) are not carried over.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from rlipv2_tpu_torch.eval.common import compute_iou_mat
from rlipv2_tpu_torch.eval.hico_eval import HICOEvaluator

PHRASE_NMS_THRESHOLD = 0.7


class OISGGEvaluator:
    def __init__(
        self,
        preds,
        gts,
        topk: int = 50,
        use_nms_filter: bool = False,
        overlap_iou: float = 0.5,
    ):
        """preds: per-image dicts as the HICO evaluator takes them; gts:
        per-image {boxes (m, 4) xyxy, labels (m,), rels (k, 3) [sub, obj,
        rel]}."""
        self.overlap_iou = overlap_iou
        self.max_rels = topk

        self.fp = defaultdict(list)
        self.tp = defaultdict(list)
        self.score = defaultdict(list)
        self.sum_gts = defaultdict(int)
        self.gt_triplets = []
        self.fp_phr = defaultdict(list)
        self.tp_phr = defaultdict(list)
        self.score_phr = defaultdict(list)

        self.preds = []
        for img_preds in preds:
            bboxes = [
                {"bbox": np.asarray(b), "category_id": int(l)}
                for b, l in zip(img_preds["boxes"], img_preds["labels"])
            ]
            rel_scores = np.asarray(img_preds["verb_scores"])
            n, V = rel_scores.shape
            verb_labels = np.tile(np.arange(V), (n, 1)).ravel()
            subject_ids = np.tile(np.asarray(img_preds["sub_ids"]), (V, 1)).T.ravel()
            object_ids = np.tile(np.asarray(img_preds["obj_ids"]), (V, 1)).T.ravel()
            rel_scores = rel_scores.ravel()
            if len(subject_ids) > 0:
                rels = [
                    {
                        "subject_id": int(s),
                        "object_id": int(o),
                        "category_id": int(c),
                        "score": float(sc),
                    }
                    for s, o, c, sc in zip(
                        subject_ids, object_ids, verb_labels, rel_scores
                    )
                ]
                rels.sort(key=lambda k: k.get("score", 0), reverse=True)
                rels = rels[: self.max_rels]
            else:
                rels = []
            self.preds.append({"predictions": bboxes, "rel_predictions": rels})

        if use_nms_filter:
            self.preds = self._triplet_nms_filter(self.preds)
        self._generate_phrases(self.preds, "predictions", "rel_predictions",
                               "phrase_predictions", scored=True)
        if use_nms_filter:
            self.preds = self._phrase_nms_filter(self.preds)

        self.gts = []
        for img_gts in gts:
            anns = [
                {"bbox": np.asarray(b), "category_id": int(l)}
                for b, l in zip(img_gts["boxes"], img_gts["labels"])
            ]
            rel_anns = [
                {
                    "subject_id": int(r[0]),
                    "object_id": int(r[1]),
                    "category_id": int(r[2]),
                }
                for r in img_gts["rels"]
            ]
            self.gts.append({"annotations": anns, "rel_annotations": rel_anns})
            for rel in rel_anns:
                triplet = (
                    anns[rel["subject_id"]]["category_id"],
                    anns[rel["object_id"]]["category_id"],
                    rel["category_id"],
                )
                if triplet not in self.gt_triplets:
                    self.gt_triplets.append(triplet)
                self.sum_gts[triplet] += 1
        self._generate_phrases(self.gts, "annotations", "rel_annotations",
                               "phrase_annotations", scored=False)

    # ------------------------------------------------------------------ #

    @staticmethod
    def _generate_phrases(annos, bbox_key, rel_key, phrase_key, scored):
        for anno in annos:
            bboxs = anno[bbox_key]
            phrase_list = []
            for rel in anno[rel_key]:
                sb = bboxs[rel["subject_id"]]["bbox"]
                ob = bboxs[rel["object_id"]]["bbox"]
                rect = np.array(
                    (min(sb[0], ob[0]), min(sb[1], ob[1]),
                     max(sb[2], ob[2]), max(sb[3], ob[3]))
                )
                cat = (
                    bboxs[rel["subject_id"]]["category_id"],
                    bboxs[rel["object_id"]]["category_id"],
                    rel["category_id"],
                )
                entry = {"bbox": rect, "category_id": cat}
                if scored:
                    entry["phrase_score"] = rel["score"]
                phrase_list.append(entry)
            anno[phrase_key] = phrase_list

    def evaluate(self):
        for img_preds, img_gts in zip(self.preds, self.gts):
            pred_bboxes = img_preds["predictions"]
            gt_bboxes = img_gts["annotations"]
            pred_rels = img_preds["rel_predictions"]
            gt_rels = img_gts["rel_annotations"]
            pred_phrases = img_preds["phrase_predictions"]
            gt_phrases = img_gts["phrase_annotations"]
            if len(gt_bboxes) != 0 and len(pred_rels) != 0:
                pairs, overlaps = compute_iou_mat(
                    gt_bboxes, pred_bboxes, self.overlap_iou
                )
                self._compute_fptp(pred_rels, gt_rels, pairs, pred_bboxes, overlaps)
                ph_pairs, ph_overlaps = compute_iou_mat(
                    gt_phrases, pred_phrases, self.overlap_iou
                )
                self._compute_fptp_phrase(gt_phrases, pred_phrases, ph_pairs, ph_overlaps)
            else:
                for pred_rel in pred_rels:
                    triplet = (
                        pred_bboxes[pred_rel["subject_id"]]["category_id"],
                        pred_bboxes[pred_rel["object_id"]]["category_id"],
                        pred_rel["category_id"],
                    )
                    if triplet not in self.gt_triplets:
                        continue
                    self.tp[triplet].append(0)
                    self.fp[triplet].append(1)
                    self.score[triplet].append(pred_rel["score"])
                for pred_phrase in pred_phrases:
                    triplet = pred_phrase["category_id"]
                    if triplet not in self.gt_triplets:
                        continue
                    self.tp_phr[triplet].append(0)
                    self.fp_phr[triplet].append(1)
                    self.score_phr[triplet].append(pred_phrase["phrase_score"])

        result = self._compute_map(self.tp, self.fp, self.score, "RelD")
        result.update(
            self._compute_map(self.tp_phr, self.fp_phr, self.score_phr, "PhrD")
        )
        return result

    def _compute_map(self, tp_d, fp_d, score_d, tag):
        ap = {}
        max_recall = {}
        tp_sum = 0.0
        gts_sum = 0.0
        for triplet in self.gt_triplets:
            sum_gts = self.sum_gts[triplet]
            if sum_gts == 0:
                continue
            tp = np.array(tp_d[triplet])
            fp = np.array(fp_d[triplet])
            if len(tp) == 0:
                ap[triplet] = 0.0
                max_recall[triplet] = 0.0
                if tag == "RelD":
                    gts_sum += sum_gts
                continue
            score = np.array(score_d[triplet])
            sort_inds = np.argsort(-score)
            fp = np.cumsum(fp[sort_inds])
            tp = np.cumsum(tp[sort_inds])
            rec = tp / sum_gts
            prec = tp / (fp + tp)
            ap[triplet] = HICOEvaluator.voc_ap(rec, prec)
            max_recall[triplet] = float(np.amax(rec))
            tp_sum += tp[-1]
            gts_sum += sum_gts
        m_ap = float(np.mean(list(ap.values()))) if ap else 0.0
        total = sum(self.sum_gts.values())
        w_ap = float(sum(a * self.sum_gts[t] / total for t, a in ap.items()))
        mmr = float(np.mean(list(max_recall.values()))) if max_recall else 0.0
        mr = float(tp_sum / gts_sum) if gts_sum else 0.0
        k = self.max_rels
        return {
            f"mAP@{k} ({tag})": m_ap,
            f"wmAP@{k} ({tag})": w_ap,
            f"mean max recall@{k} ({tag})": mmr,
            f"max recall@{k} ({tag})": mr,
        }

    def _compute_fptp(self, pred_rels, gt_rels, match_pairs, pred_bboxes, bbox_overlaps):
        pos_pred_ids = match_pairs.keys()
        vis_tag = np.zeros(len(gt_rels))
        pred_rels.sort(key=lambda k: k.get("score", 0), reverse=True)
        for pred_rel in pred_rels:
            is_match = 0
            max_gt_rel = 0
            if (
                len(match_pairs) != 0
                and pred_rel["subject_id"] in pos_pred_ids
                and pred_rel["object_id"] in pos_pred_ids
            ):
                pred_sub_ids = match_pairs[pred_rel["subject_id"]]
                pred_obj_ids = match_pairs[pred_rel["object_id"]]
                pred_sub_overlaps = bbox_overlaps[pred_rel["subject_id"]]
                pred_obj_overlaps = bbox_overlaps[pred_rel["object_id"]]
                max_overlap = 0
                for gt_rel in gt_rels:
                    if (
                        gt_rel["subject_id"] in pred_sub_ids
                        and gt_rel["object_id"] in pred_obj_ids
                        and pred_rel["category_id"] == gt_rel["category_id"]
                    ):
                        is_match = 1
                        ov = min(
                            pred_sub_overlaps[pred_sub_ids.index(gt_rel["subject_id"])],
                            pred_obj_overlaps[pred_obj_ids.index(gt_rel["object_id"])],
                        )
                        if ov > max_overlap:
                            max_overlap = ov
                            max_gt_rel = gt_rel
            triplet = (
                pred_bboxes[pred_rel["subject_id"]]["category_id"],
                pred_bboxes[pred_rel["object_id"]]["category_id"],
                pred_rel["category_id"],
            )
            if triplet not in self.gt_triplets:
                continue
            if is_match == 1 and vis_tag[gt_rels.index(max_gt_rel)] == 0:
                self.fp[triplet].append(0)
                self.tp[triplet].append(1)
                vis_tag[gt_rels.index(max_gt_rel)] = 1
            else:
                self.fp[triplet].append(1)
                self.tp[triplet].append(0)
            self.score[triplet].append(pred_rel["score"])

    def _compute_fptp_phrase(self, gt_phrases, pred_phrases, phrase_pairs, phrase_overlaps):
        pos_pred_ids = phrase_pairs.keys()
        vis_tag = np.zeros(len(gt_phrases))
        pred_phrases.sort(key=lambda k: k.get("phrase_score", 0), reverse=True)
        for idx_pred, pred_phrase in enumerate(pred_phrases):
            is_match = 0
            max_gt_phr = 0
            if len(phrase_pairs) != 0 and idx_pred in pos_pred_ids:
                pred_ids = phrase_pairs[idx_pred]
                pred_overlaps = phrase_overlaps[idx_pred]
                max_overlap = 0
                for gt_idx in range(len(gt_phrases)):
                    if gt_idx in pred_ids:
                        is_match = 1
                        ov = pred_overlaps[pred_ids.index(gt_idx)]
                        if ov > max_overlap:
                            max_overlap = ov
                            max_gt_phr = gt_idx
            triplet = pred_phrase["category_id"]
            if triplet not in self.gt_triplets:
                continue
            if is_match == 1 and vis_tag[max_gt_phr] == 0:
                self.fp_phr[triplet].append(0)
                self.tp_phr[triplet].append(1)
                vis_tag[max_gt_phr] = 1
            else:
                self.fp_phr[triplet].append(1)
                self.tp_phr[triplet].append(0)
            self.score_phr[triplet].append(pred_phrase["phrase_score"])

    # --------------------------- NMS filters --------------------------- #

    @staticmethod
    def _triplet_nms_filter(preds):
        helper = HICOEvaluator.__new__(HICOEvaluator)
        out = []
        for img_preds in preds:
            wrapped = {
                "predictions": img_preds["predictions"],
                "hoi_prediction": img_preds["rel_predictions"],
            }
            filtered = helper.triplet_nms_filter([wrapped])[0]
            out.append(
                {
                    "predictions": filtered["predictions"],
                    "rel_predictions": filtered["hoi_prediction"],
                }
            )
        return out

    def _phrase_nms_filter(self, preds):
        for img_preds in preds:
            pred_phrases = img_preds["phrase_predictions"]
            all_triplets = {}
            for index, p in enumerate(pred_phrases):
                entry = all_triplets.setdefault(
                    p["category_id"], {"phrs": [], "scores": [], "indexes": []}
                )
                entry["phrs"].append(p["bbox"])
                entry["scores"].append(p["phrase_score"])
                entry["indexes"].append(index)
            keep_all = []
            for values in all_triplets.values():
                keep = self._nms(
                    np.array(values["phrs"]), np.array(values["scores"]), PHRASE_NMS_THRESHOLD
                )
                keep_all.extend(list(np.array(values["indexes"])[keep]))
            img_preds["phrase_predictions"] = [pred_phrases[i] for i in keep_all]
        return preds

    @staticmethod
    def _nms(dets, scores, thresh):
        x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
        areas = (x2 - x1 + 1) * (y2 - y1 + 1)
        order = scores.argsort()[::-1]
        keep = []
        while order.size > 0:
            i = int(order[0])
            keep.append(i)
            w = np.maximum(0.0, np.minimum(x2[i], x2[order[1:]]) - np.maximum(x1[i], x1[order[1:]]) + 1)
            h = np.maximum(0.0, np.minimum(y2[i], y2[order[1:]]) - np.maximum(y1[i], y1[order[1:]]) + 1)
            inter = w * h
            ovr = inter / (areas[i] + areas[order[1:]] - inter)
            order = order[np.where(ovr <= thresh)[0] + 1]
        return keep


def score_wtd(results_at_50: dict, results_at_100: dict) -> dict:
    """Composite score (reference: datasets/oi_sgg_eval.py:221-222)."""
    return {
        "score_wtd (mAP)": 0.2 * results_at_50["max recall@50 (RelD)"]
        + 0.4 * results_at_100["mAP@100 (RelD)"]
        + 0.4 * results_at_100["mAP@100 (PhrD)"],
        "score_wtd (wmAP)": 0.2 * results_at_50["max recall@50 (RelD)"]
        + 0.4 * results_at_100["wmAP@100 (RelD)"]
        + 0.4 * results_at_100["wmAP@100 (PhrD)"],
    }
