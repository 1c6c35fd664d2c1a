"""Pseudo-verb soft labels, the RPL companion (counterpart of
rlipv2_tpu/losses/pseudo_verb.py:19-59; reference models/hoi.py:2197-2239).

The inter-verb similarity of the verb text features, aggregated over each
GT pair's positive verbs, max-normalised, GT verbs zeroed and thresholded
at 0.3. The result is `SetCriterionHOI`'s `target_verb_sim`, added to the
verb labels before the GIoU scaling of RPL.
"""

from __future__ import annotations

import torch

SIM_THRESHOLD = 0.3


def pseudo_verb_similarity(
    verb_text_features: torch.Tensor,  # (Tv, D)
    verb_labels: torch.Tensor,  # (B, M, Tv) multi-hot GT
    verb_valid: torch.Tensor,  # (Tv,) or (B, Tv) valid verb slots
    threshold: float = SIM_THRESHOLD,
    metric: str = "euclidean",
) -> torch.Tensor:
    """-> (B, M, Tv) soft pseudo labels in [0, 1], float32.

    metric="euclidean" is the online mode (the current forward's post-ALIF
    language states; sim = rowmax(dist) - dist over valid slots);
    metric="cosine" the offline mode (precomputed pooled text features)."""
    if verb_valid.ndim == 2:
        verb_valid = verb_valid[0]
    f = verb_text_features.float()
    pair_valid = verb_valid[None, :] & verb_valid[:, None]
    if metric == "euclidean":
        sq = (f**2).sum(-1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * f @ f.T
        dist = d2.clamp(min=0.0).sqrt()
        big = torch.where(pair_valid, dist, torch.full_like(dist, -torch.inf))
        sim = big.amax(-1, keepdim=True) - dist
    elif metric == "cosine":
        fn = f / f.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        sim = fn @ fn.T
    else:
        raise ValueError(f"metric is 'euclidean' or 'cosine', not {metric!r}")
    sim = torch.where(pair_valid, sim, torch.zeros_like(sim))

    labels = verb_labels.float()
    tvs = torch.einsum("bmv,vw->bmw", labels, sim)
    denom = tvs.amax(-1, keepdim=True).clamp(min=1e-12)
    tvs = torch.where(labels.sum(-1, keepdim=True) > 0, tvs / denom, tvs)
    tvs = torch.where(labels > 0, torch.zeros_like(tvs), tvs)  # GT verbs stay hard
    return tvs * (tvs > threshold)
