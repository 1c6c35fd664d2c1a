"""Embedding uniformity and alignment (Wang & Isola 2020), the analysis of
RLIPv2's paper over the verb features that
`engine/loops.py::evaluate_hoi_matching_uniformity` collects (numpy copy of
rlipv2_tpu/tools/uniformity.py; reference analysis/uniformity.py and
engine.py:573-697).

The JAX functions build every n x n distance matrix at once in float64:
HICO-DET's test set matches tens of thousands of verbs, so that is several
GB on the host. These compute the same means over blocks of rows, at most
`block_elements` distances at a time.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

BLOCK_ELEMENTS = 1 << 22  # float64 distances held at once: 32 MB


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _row_blocks(n: int, block_elements: int):
    """(start, stop) row ranges of at most `block_elements` / n rows."""
    rows = max(1, block_elements // max(n, 1))
    return ((a, min(a + rows, n)) for a in range(0, n, rows))


def _squared_distances(x: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """|x_i - x_j|^2 of the rows `rows` of x against every row, by the JAX
    function's formula |a|^2 + |b|^2 - 2ab."""
    sq = np.sum(x**2, -1)
    return sq[rows, None] + sq[None, :] - 2.0 * x[rows] @ x.T


def uniformity(features: np.ndarray, t: float = 2.0, block_elements: int = BLOCK_ELEMENTS) -> float:
    """log E[exp(-t |x - y|^2)] over all ordered pairs of distinct
    L2-normalized features; more negative = more uniform on the sphere."""
    x = _normalize(np.asarray(features, np.float64))
    n = len(x)
    total = 0.0
    for a, b in _row_blocks(n, block_elements):
        rows = np.arange(a, b)
        e = np.exp(-t * _squared_distances(x, rows))
        e[rows - a, rows] = 0.0  # a feature and itself make no pair
        total += e.sum()
    return float(np.log(total / (n * (n - 1))))


def alignment(class_features: Mapping, alpha: float = 2.0, block_elements: int = BLOCK_ELEMENTS) -> float:
    """E[|x - y|^alpha] over the positive (same-class) pairs, each pair once."""
    total, count = 0.0, 0
    for feats in class_features.values():
        x = _normalize(np.asarray(feats, np.float64))
        n = len(x)
        for a, b in _row_blocks(n, block_elements):
            rows = np.arange(a, b)
            upper = np.arange(n)[None, :] > rows[:, None]
            d = np.maximum(_squared_distances(x, rows)[upper], 0.0) ** (alpha / 2.0)
            total += d.sum()
            count += d.size
    return float(total / count) if count else 0.0


def analyze(class_features: Mapping) -> dict:
    """-> {"uniformity", "alignment", "n_classes", "n_features"}."""
    all_feats = np.concatenate([np.asarray(v) for v in class_features.values() if len(v)])
    return {
        "uniformity": uniformity(all_feats),
        "alignment": alignment(class_features),
        "n_classes": len(class_features),
        "n_features": len(all_feats),
    }
