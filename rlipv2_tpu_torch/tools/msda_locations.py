"""MSDA sampling locations at the spreads that the kernels are timed and tested at.

The time of the MSDA backward's scatter and of the gathers depends on how
far apart a query's sampling points lie, so the kernels are held and timed
at three encoder spreads (`encoder_locations`) and at the decoder's
(`decoder_locations`). Each function draws from the torch generator it is
given, on that generator's device, and returns float32 locations
(B, Q, H, L, P, 2) in [0, 1] level coordinates, as the layers pass them.
"""

from __future__ import annotations

from typing import Sequence

import torch

SPREADS = ("uniform", "init_grid", "tight")
INIT_GRID_NOISE_PX = 0.25
TIGHT_SIGMA_PX = 0.4


def encoder_locations(spread: str, shapes: Sequence[tuple[int, int]], B: int, H: int, P: int,
                      gen: torch.Generator, Q: int | None = None) -> torch.Tensor:
    """Locations of the first Q (default: all) tokens of an encoder over
    the levels `shapes` ((h, w) each), for one of SPREADS:
      * uniform: every location uniform in [0, 1]^2;
      * init_grid: each token's reference point (its pixel centre on its
        level, the valid ratios all 1) plus `sampling_offset_bias_init`
        (1-P level pixels along each head's direction) plus
        N(0, INIT_GRID_NOISE_PX^2) pixel noise: the spread of a trained model;
      * tight: the reference point plus N(0, TIGHT_SIGMA_PX^2) pixel noise:
        the spread of seeded random weights of std 0.02 (the main paths'
        first encoder layer samples at a p50 |offset| of 0.47 level pixels,
        the p50 of a 2-d normal of sigma 0.4).
    Pixel offsets are divided by each level's (w, h), as the layer does."""
    from rlipv2_tpu_torch.models.deformable import encoder_reference_points
    from rlipv2_tpu_torch.models.layers import sampling_offset_bias_init

    dev = gen.device
    L = len(shapes)
    Q = sum(h * w for h, w in shapes) if Q is None else Q
    if spread == "uniform":
        return torch.rand(B, Q, H, L, P, 2, generator=gen, device=dev)
    noise = torch.randn(B, Q, H, L, P, 2, generator=gen, device=dev)
    if spread == "init_grid":
        px = sampling_offset_bias_init(H, L, P).to(dev).view(H, L, P, 2) + INIT_GRID_NOISE_PX * noise
    elif spread == "tight":
        px = TIGHT_SIGMA_PX * noise
    else:
        raise ValueError(f"unknown spread {spread!r}; known: {SPREADS}")
    ref = encoder_reference_points(shapes, torch.ones(B, L, 2, device=dev))[:, :Q]  # (B, Q, L, 2)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev).view(L, 1, 2)
    return ref[:, :, None, :, None, :] + px / wh


def decoder_locations(B: int, Q: int, H: int, L: int, P: int, gen: torch.Generator) -> torch.Tensor:
    """Decoder locations around Q random 4-d anchors (cx, cy, w, h):
    centre + offset / P * wh * 0.5 with N(0, 1) offsets, as the decoder
    forms them."""
    dev = gen.device
    anchors = torch.rand(B, Q, 1, 1, 1, 4, generator=gen, device=dev)
    offsets = torch.randn(B, Q, H, L, P, 2, generator=gen, device=dev)
    return anchors[..., :2] + offsets / P * anchors[..., 2:] * 0.5
