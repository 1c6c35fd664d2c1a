"""Metric-level fidelity protocol for the quantized inference paths (int8
MSDA, int8 dense): a numpy copy of rlipv2_tpu/eval/int8_gate.py on the
port's own HICO evaluator.

The fixture is made FROM the exact path's own detections, so the mAP sits
mid-range and a score or box perturbation moves it: the top-K pairs per
image become ground truth (verb = argmax), the GT boxes are jittered (IoU
matching stays above 0.5 but is not trivially 1.0), and one unmatchable GT
interaction per image keeps recall below 1.

With random weights the verb scores sit in a near-tie band around the
prior bias, so the canned-GT mAP reshuffles under small score changes: a
delta read from it is compared with the 1 % score-jitter control, and it
cannot gate the path.
"""

from __future__ import annotations

import numpy as np

from rlipv2_tpu_torch.eval.hico_eval import HICOEvaluator


def canned_gt_from_results(results, top_k: int = 4, seed: int = 7):
    """The de-saturated GT fixture from per-image result dicts
    (labels/boxes/verb_scores/sub_ids/obj_ids)."""
    jrng = np.random.RandomState(seed)
    gts = []
    for r in results:
        vs = np.asarray(r["verb_scores"])  # (nq, V)
        boxes = np.asarray(r["boxes"])  # (2nq, 4)
        labels = np.asarray(r["labels"])  # (2nq,)
        top = np.argsort(-vs.max(axis=1))[:top_k]
        g_boxes, g_labels, g_hois = [], [], []
        for q in top:
            sub_id, obj_id = int(r["sub_ids"][q]), int(r["obj_ids"][q])
            for b in (boxes[sub_id], boxes[obj_id]):
                wh2 = np.maximum(b[2:] - b[:2], 1.0)
                jit = jrng.uniform(-0.08, 0.08, 4) * np.concatenate([wh2, wh2])
                g_boxes.append(b + jit.astype(np.float32))
            g_labels.extend([int(labels[sub_id]), int(labels[obj_id])])
            k = len(g_boxes)
            g_hois.append([k - 2, k - 1, int(vs[q].argmax())])
        # unmatchable GT: far-away tiny boxes -> recall < 1
        g_boxes.extend([
            np.asarray([900.0, 900.0, 910.0, 910.0], np.float32),
            np.asarray([920.0, 920.0, 930.0, 930.0], np.float32),
        ])
        g_labels.extend([int(labels[0]), int(labels[1])])
        k = len(g_boxes)
        g_hois.append([k - 2, k - 1, int(g_hois[0][2])])
        gts.append({
            "filename": "synthetic",
            "boxes": np.asarray(g_boxes, np.float32),
            "labels": np.asarray(g_labels, np.int64),
            "hois": np.asarray(g_hois, np.int64),
        })
    return gts


def map_from(results, gts, n_verb: int, n_obj: int) -> float:
    """HICO-protocol mAP of `results` against the canned GT."""
    triplets = {
        (int(g["labels"][h[0]]), int(g["labels"][h[1]]), int(h[2]))
        for g in gts
        for h in g["hois"]
    }
    ev = HICOEvaluator(
        results, gts, rare_triplets=[], non_rare_triplets=list(triplets),
        correct_mat=np.ones((n_verb, n_obj), np.float32),
    )
    ev.evaluate()
    return float(ev.compute_map()["mAP"])


def map_delta_points(res_exact, res_quant, n_verb: int, n_obj: int):
    """(delta on the reference 0-100 mAP scale, exact mAP, quant mAP).

    Raises if the fixture is degenerate (exact mAP pinned at 0 or 1) or if
    the quantized path gave bit-identical outputs (a vacuous bound)."""
    d = max(
        float(np.abs(np.asarray(a["verb_scores"]) - np.asarray(b["verb_scores"])).max())
        for a, b in zip(res_exact, res_quant)
    )
    if d == 0.0:
        raise AssertionError("quantized path produced bit-identical outputs")
    gts = canned_gt_from_results(res_exact)
    m_e = map_from(res_exact, gts, n_verb, n_obj)
    m_q = map_from(res_quant, gts, n_verb, n_obj)
    if not (0.05 < m_e < 0.999):
        raise AssertionError(f"degenerate fixture: exact mAP {m_e}")
    return abs(m_e - m_q) * 100.0, m_e, m_q
