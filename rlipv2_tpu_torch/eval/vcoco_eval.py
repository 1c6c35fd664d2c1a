"""V-COCO evaluator ("mAP all" / "mAP thesis"), a numpy copy of
rlipv2_tpu/eval/vcoco_eval.py, whose protocol follows the reference
datasets/vcoco_eval.py:12-312: per-verb AP over 29 action classes,
correct_mat extended with an extra always-valid column for no-object
interactions, greedy score-ordered matching with vis_tag where a GT
object_id of -1 means "subject-only" matching, 11-point VOC AP, and the
thesis subset mean over 24 role classes.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from rlipv2_tpu_torch.eval.common import compute_iou_mat

VCOCO_VERB_CLASSES = [
    "hold_obj", "stand", "sit_instr", "ride_instr", "walk", "look_obj",
    "hit_instr", "hit_obj", "eat_obj", "eat_instr", "jump_instr",
    "lay_instr", "talk_on_phone_instr", "carry_obj", "throw_obj",
    "catch_obj", "cut_instr", "cut_obj", "run", "work_on_computer_instr",
    "ski_instr", "surf_instr", "skateboard_instr", "smile", "drink_instr",
    "kick_obj", "point_instr", "read_obj", "snowboard_instr",
]
THESIS_MAP_INDICES = [
    0, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 19, 20, 21, 22,
    24, 25, 27, 28,
]


class VCOCOEvaluator:
    def __init__(self, preds, gts, correct_mat, max_hois: int = 100,
                 overlap_iou: float = 0.5):
        """preds/gts: per-image numpy dicts as in HICOEvaluator; GT hois may
        use object_id == -1 for subject-only interactions."""
        self.overlap_iou = overlap_iou
        self.max_hois = max_hois
        self.fp = defaultdict(list)
        self.tp = defaultdict(list)
        self.score = defaultdict(list)
        self.sum_gts = defaultdict(int)

        # extra final column: verbs valid with "no object" (reference :47)
        correct_mat = np.concatenate(
            [correct_mat, np.ones((correct_mat.shape[0], 1))], axis=1
        )

        self.preds = []
        for img_preds in preds:
            bboxes = [
                {"bbox": np.asarray(b), "category_id": int(l)}
                for b, l in zip(img_preds["boxes"], img_preds["labels"])
            ]
            hoi_scores = np.asarray(img_preds["verb_scores"])
            n, V = hoi_scores.shape
            verb_labels = np.tile(np.arange(V), (n, 1)).ravel()
            subject_ids = np.tile(np.asarray(img_preds["sub_ids"]), (V, 1)).T.ravel()
            object_ids = np.tile(np.asarray(img_preds["obj_ids"]), (V, 1)).T.ravel()
            hoi_scores = hoi_scores.ravel()
            if len(subject_ids) > 0:
                object_labels = np.array(
                    [bboxes[o]["category_id"] for o in object_ids]
                )
                hoi_scores = hoi_scores * correct_mat[verb_labels, object_labels]
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

        self.gts = []
        for img_gts in gts:
            anns = [
                {"bbox": np.asarray(b), "category_id": int(l)}
                for b, l in zip(img_gts["boxes"], img_gts["labels"])
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
                self.sum_gts[hoi["category_id"]] += 1

    def evaluate(self):
        for img_preds, img_gts in zip(self.preds, self.gts):
            pred_bboxes = img_preds["predictions"]
            gt_bboxes = img_gts["annotations"]
            pred_hois = img_preds["hoi_prediction"]
            gt_hois = img_gts["hoi_annotation"]
            if len(gt_bboxes) != 0:
                pairs, overlaps = self.compute_iou_mat(gt_bboxes, pred_bboxes)
                self.compute_fptp(pred_hois, gt_hois, pairs, pred_bboxes, overlaps)
            else:
                for pred_hoi in pred_hois:
                    self.tp[pred_hoi["category_id"]].append(0)
                    self.fp[pred_hoi["category_id"]].append(1)
                    self.score[pred_hoi["category_id"]].append(pred_hoi["score"])
        return self.compute_map()

    def compute_map(self):
        ap = defaultdict(float)
        aps = {}
        for category_id in sorted(self.sum_gts.keys()):
            sum_gts = self.sum_gts[category_id]
            if sum_gts == 0:
                continue
            tp = np.array(self.tp[category_id])
            fp = np.array(self.fp[category_id])
            if len(tp):
                score = np.array(self.score[category_id])
                sort_inds = np.argsort(-score)
                fp = np.cumsum(fp[sort_inds])
                tp = np.cumsum(tp[sort_inds])
                rec = tp / sum_gts
                prec = tp / (fp + tp)
                ap[category_id] = self.voc_ap(rec, prec)
            aps[f"AP_{VCOCO_VERB_CLASSES[category_id]}"] = ap[category_id]
        m_all = float(np.mean(list(ap.values()))) if ap else 0.0
        m_thesis = float(np.mean([ap[c] for c in THESIS_MAP_INDICES]))
        aps.update({"mAP_all": m_all, "mAP_thesis": m_thesis})
        return aps

    @staticmethod
    def voc_ap(rec, prec):
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) else 0
            ap += p / 11.0
        return ap

    def compute_fptp(self, pred_hois, gt_hois, match_pairs, pred_bboxes, bbox_overlaps):
        pos_pred_ids = match_pairs.keys()
        vis_tag = np.zeros(len(gt_hois))
        pred_hois.sort(key=lambda k: k.get("score", 0), reverse=True)
        for pred_hoi in pred_hois:
            is_match = 0
            max_overlap = 0
            max_gt_hoi = 0
            for gt_hoi in gt_hois:
                if (
                    len(match_pairs) != 0
                    and pred_hoi["subject_id"] in pos_pred_ids
                    and gt_hoi["object_id"] == -1
                ):
                    pred_sub_ids = match_pairs[pred_hoi["subject_id"]]
                    pred_sub_overlaps = bbox_overlaps[pred_hoi["subject_id"]]
                    if (
                        gt_hoi["subject_id"] in pred_sub_ids
                        and pred_hoi["category_id"] == gt_hoi["category_id"]
                    ):
                        is_match = 1
                        ov = pred_sub_overlaps[pred_sub_ids.index(gt_hoi["subject_id"])]
                        if ov > max_overlap:
                            max_overlap = ov
                            max_gt_hoi = gt_hoi
                elif (
                    len(match_pairs) != 0
                    and pred_hoi["subject_id"] in pos_pred_ids
                    and pred_hoi["object_id"] in pos_pred_ids
                ):
                    pred_sub_ids = match_pairs[pred_hoi["subject_id"]]
                    pred_obj_ids = match_pairs[pred_hoi["object_id"]]
                    pred_sub_overlaps = bbox_overlaps[pred_hoi["subject_id"]]
                    pred_obj_overlaps = bbox_overlaps[pred_hoi["object_id"]]
                    if (
                        gt_hoi["subject_id"] in pred_sub_ids
                        and gt_hoi["object_id"] in pred_obj_ids
                        and pred_hoi["category_id"] == gt_hoi["category_id"]
                    ):
                        is_match = 1
                        ov = min(
                            pred_sub_overlaps[pred_sub_ids.index(gt_hoi["subject_id"])],
                            pred_obj_overlaps[pred_obj_ids.index(gt_hoi["object_id"])],
                        )
                        if ov > max_overlap:
                            max_overlap = ov
                            max_gt_hoi = gt_hoi
            if is_match == 1 and vis_tag[gt_hois.index(max_gt_hoi)] == 0:
                self.fp[pred_hoi["category_id"]].append(0)
                self.tp[pred_hoi["category_id"]].append(1)
                vis_tag[gt_hois.index(max_gt_hoi)] = 1
            else:
                self.fp[pred_hoi["category_id"]].append(1)
                self.tp[pred_hoi["category_id"]].append(0)
            self.score[pred_hoi["category_id"]].append(pred_hoi["score"])

    def compute_iou_mat(self, bbox_list1, bbox_list2):
        return compute_iou_mat(bbox_list1, bbox_list2, self.overlap_iou)
