"""Shared building-block layers (counterpart of rlipv2_tpu/models/layers.py).

Parameter names follow the reference torch modules:
  * MLP — `layers.{i}` Linear stack (reference
    models/dab_deformable/deformable_transformer.py:1759-1775);
  * FeatureResizer — `fc` + `layer_norm` (eps 1e-12) + dropout
    (reference models/fuse_helper.py:54-73);
  * MultiBranchFusion — `fc_1/fc_2/fc_3.{k}` Linear lists (reference
    models/fuse_helper.py:755-798), applied as three batched einsums over
    the stacked branch weights;
  * MSDeformAttention — `sampling_offsets`, `attention_weights`,
    `value_proj`, `output_proj` (reference models/ops/modules/ms_deform_attn.py:34-119),
    sampling through rlipv2_tpu_torch.ops.ms_deform_attn with the config's
    `impl`; `int8_dense` makes the value and output projections W8A8
    (ops/int8_dense.py), while the offset and weight heads stay float.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from rlipv2_tpu_torch.ops.int8_dense import linear
from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn


class MLP(nn.Module):
    """num_layers Linear stack with ReLU between (not after) layers."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims_in, dims_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class FeatureResizer(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, dropout: float = 0.1):
        super().__init__()
        self.fc = nn.Linear(input_dim, output_dim)
        self.layer_norm = nn.LayerNorm(output_dim, eps=1e-12)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.layer_norm(self.fc(x)))


class MultiBranchFusion(nn.Module):
    """relu(sum_k fc_3[k](relu(fc_1[k](a) * fc_2[k](b))))."""

    def __init__(self, in_a: int, in_b: int, representation_dim: int = 256, cardinality: int = 16):
        super().__init__()
        sub = representation_dim // cardinality
        if sub * cardinality != representation_dim:
            raise ValueError("representation_dim must be divisible by cardinality")
        self.fc_1 = nn.ModuleList(nn.Linear(in_a, sub) for _ in range(cardinality))
        self.fc_2 = nn.ModuleList(nn.Linear(in_b, sub) for _ in range(cardinality))
        self.fc_3 = nn.ModuleList(nn.Linear(sub, representation_dim) for _ in range(cardinality))

    @staticmethod
    def _stacked(fcs: nn.ModuleList) -> tuple[torch.Tensor, torch.Tensor]:
        return torch.stack([f.weight for f in fcs]), torch.stack([f.bias for f in fcs])

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        w1, b1 = self._stacked(self.fc_1)  # (k, sub, in_a), (k, sub)
        w2, b2 = self._stacked(self.fc_2)
        w3, b3 = self._stacked(self.fc_3)  # (k, rep, sub), (k, rep)
        ha = torch.einsum("...c,ksc->...ks", a, w1) + b1
        hb = torch.einsum("...c,ksc->...ks", b, w2) + b2
        h = F.relu(ha * hb)
        return F.relu(torch.einsum("...ks,krs->...r", h, w3) + b3.sum(0))


def normalize_pixels(pixels: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> ImageNet-normalized float32 on the tensor's
    device; float input is taken as already normalized."""
    if pixels.dtype != torch.uint8:
        return pixels.float()
    mean = torch.tensor([0.485, 0.456, 0.406], device=pixels.device)
    std = torch.tensor([0.229, 0.224, 0.225], device=pixels.device)
    return (pixels.float() * (1.0 / 255.0) - mean) / std


def sampling_offset_bias_init(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """The reference's radial grid init of the sampling-offset bias
    (reference models/ops/modules/ms_deform_attn.py:66-74)."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (2.0 * math.pi / n_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True)[0]
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    grid = grid * torch.arange(1, n_points + 1, dtype=torch.float32)[None, None, :, None]
    return grid.reshape(-1)


class MSDeformAttention(nn.Module):
    """Multi-scale deformable attention layer: query-conditioned sampling
    offsets and weights over a level-flattened value tensor."""

    def __init__(
        self,
        d_model: int = 256,
        n_levels: int = 4,
        n_heads: int = 8,
        n_points: int = 4,
        impl: str = "auto",
        int8_dense: bool = False,
    ):
        super().__init__()
        self.d_model, self.n_levels, self.n_heads, self.n_points = d_model, n_levels, n_heads, n_points
        self.impl = impl
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = linear(d_model, d_model, int8=int8_dense)
        self.output_proj = linear(d_model, d_model, int8=int8_dense)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(sampling_offset_bias_init(n_heads, n_levels, n_points))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def forward(
        self,
        query: torch.Tensor,  # (B, Q, C); pos already added by the caller
        reference_points: torch.Tensor,  # (B, Q, L, 2) or (B, Q, L, 4) in [0, 1]
        value_flatten: torch.Tensor,  # (B, S, C)
        spatial_shapes: Sequence[tuple[int, int]],
        valid_mask: Optional[torch.Tensor] = None,  # (B, S) True = real token
    ) -> torch.Tensor:
        B, Q, _ = query.shape
        S = value_flatten.shape[1]
        H, L, P = self.n_heads, self.n_levels, self.n_points

        value = self.value_proj(value_flatten)
        if valid_mask is not None:
            value = value.masked_fill(~valid_mask[..., None], 0.0)
        value = value.view(B, S, H, self.d_model // H)

        offsets = self.sampling_offsets(query).view(B, Q, H, L, P, 2)
        attn = self.attention_weights(query).view(B, Q, H, L * P)
        attn = F.softmax(attn.float(), dim=-1).view(B, Q, H, L, P)

        offsets = offsets.float()
        ref = reference_points.float()
        if ref.shape[-1] == 2:
            normalizer = torch.tensor(
                [[w, h] for h, w in spatial_shapes], dtype=torch.float32, device=query.device
            )
            loc = ref[:, :, None, :, None, :] + offsets / normalizer[None, None, None, :, None, :]
        elif ref.shape[-1] == 4:
            loc = ref[:, :, None, :, None, :2] + offsets / P * ref[:, :, None, :, None, 2:] * 0.5
        else:
            raise ValueError("reference_points last dim must be 2 or 4")

        out = ms_deform_attn(value, spatial_shapes, loc, attn, impl=self.impl)
        return self.output_proj(out)
