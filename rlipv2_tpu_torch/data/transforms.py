"""Box normalisation of the train targets (counterpart of
rlipv2_tpu/data/transforms.py::normalize_boxes). The image augmentations
of that module (flip, colour jitter, multi-scale resize and crop; PIL) are
not ported yet: ROADMAP queue 1 item 15."""

from __future__ import annotations

import numpy as np


def normalize_boxes(boxes_xyxy: np.ndarray, h: int, w: int) -> np.ndarray:
    """xyxy px -> normalized cxcywh (reference: datasets/transforms.py
    Normalize)."""
    if len(boxes_xyxy) == 0:
        return boxes_xyxy.reshape(0, 4)
    b = boxes_xyxy.astype(np.float32)
    cx = (b[:, 0] + b[:, 2]) / 2 / w
    cy = (b[:, 1] + b[:, 3]) / 2 / h
    bw = (b[:, 2] - b[:, 0]) / w
    bh = (b[:, 3] - b[:, 1]) / h
    return np.stack([cx, cy, bw, bh], axis=1)
