"""Deformable encoder and the ALIF encoder (counterpart of rlipv2_tpu/models/deformable.py).

  * DeformableEncoderLayer — reference models/deformable_transformer.py:719-758:
    MSDeformAttn self-attention over the flattened multi-level tokens, FFN,
    post-LN; `msda_impl` and `int8_dense` as the JAX layer takes them.
  * encoder_reference_points — pixel-centre grid per level, normalised by
    the valid extent (reference :768-780).
  * ALIFEncoder — reference :791-884: before every `fusion_interval`-th
    deformable layer, a VLFuse bi-attention (on the last feature level only
    when `fusion_last_vis`) and ONE RoBERTa layer on the language path.
    Parameters sit in the reference lists `layers`, `roberta_layers` and
    `VLFuse_layers.{f}.b_attn`; the JAX package scans the same blocks.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from rlipv2_tpu_torch.config import TextEncoderConfig, TransformerConfig
from rlipv2_tpu_torch.models.fusion import BiAttentionBlock
from rlipv2_tpu_torch.models.layers import MSDeformAttention
from rlipv2_tpu_torch.models.roberta import RobertaLayer, alif_additive_bool_mask
from rlipv2_tpu_torch.ops.int8_dense import linear


def encoder_reference_points(
    spatial_shapes: Sequence[tuple[int, int]],
    valid_ratios: torch.Tensor,  # (B, L, 2) as (w_ratio, h_ratio)
) -> torch.Tensor:
    """-> (B, S, L, 2) float32 reference points."""
    refs = []
    dev = valid_ratios.device
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry, rx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij",
        )
        ry = ry.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
        rx = rx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([rx, ry], dim=-1))
    ref = torch.cat(refs, dim=1)
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]


def compute_valid_ratios(valid_masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-level (B, h, w) validity masks -> (B, L, 2) as (w_ratio, h_ratio).
    At least one valid row and column is counted, so an all-padded image
    gives finite reference points."""
    ratios = []
    for m in valid_masks:
        h, w = m.shape[1], m.shape[2]
        valid_h = m[:, :, 0].float().sum(1).clamp(min=1.0)
        valid_w = m[:, 0, :].float().sum(1).clamp(min=1.0)
        ratios.append(torch.stack([valid_w / w, valid_h / h], dim=-1))
    return torch.stack(ratios, dim=1)


class DeformableEncoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.self_attn = MSDeformAttention(
            d, cfg.num_feature_levels, cfg.nheads, cfg.enc_n_points, cfg.msda_impl, cfg.int8_dense
        )
        self.dropout1 = nn.Dropout(cfg.dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = linear(d, cfg.dim_feedforward, int8=cfg.int8_dense)
        self.dropout2 = nn.Dropout(cfg.dropout)
        self.linear2 = linear(cfg.dim_feedforward, d, int8=cfg.int8_dense)
        self.dropout3 = nn.Dropout(cfg.dropout)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes, valid_mask=None):
        attn = self.self_attn(src + pos, reference_points, src, spatial_shapes, valid_mask)
        src = self.norm1(src + self.dropout1(attn))
        ff = self.linear2(self.dropout2(F.relu(self.linear1(src))))
        return self.norm2(src + self.dropout3(ff))


class _VLFuse(nn.Module):
    """Holds the reference's `b_attn` submodule name."""

    def __init__(self, f, v_dim, l_dim, num_feature_levels, int8_dense=False):
        super().__init__()
        self.b_attn = BiAttentionBlock(f, v_dim, l_dim, num_feature_levels, int8_dense)


class ALIFEncoder(nn.Module):
    """Interleaved [VLFuse + RobertaLayer] / deformable-layer encoder.
    Returns (visual tokens (B, S, C), language states): the per-fusion
    language states stacked to (n_fusions, B, T, l_dim) when
    `lang_aux_loss`, else the last one (B, T, l_dim)."""

    def __init__(self, cfg: TransformerConfig, text_cfg: TextEncoderConfig):
        super().__init__()
        f = cfg.fusion
        if cfg.enc_layers % f.fusion_interval:
            raise ValueError(
                f"enc_layers ({cfg.enc_layers}) must be divisible by "
                f"fusion_interval ({f.fusion_interval})"
            )
        self.cfg = cfg
        n_fusion = cfg.enc_layers // f.fusion_interval
        self.layers = nn.ModuleList(DeformableEncoderLayer(cfg) for _ in range(cfg.enc_layers))
        self.roberta_layers = nn.ModuleList(RobertaLayer(text_cfg) for _ in range(n_fusion))
        self.VLFuse_layers = nn.ModuleList(
            _VLFuse(f, cfg.hidden_dim, text_cfg.hidden_size, cfg.num_feature_levels, cfg.int8_dense)
            for _ in range(n_fusion)
        )

    def forward(
        self,
        src: torch.Tensor,  # (B, S, C)
        spatial_shapes: Sequence[tuple[int, int]],
        valid_ratios: torch.Tensor,  # (B, L, 2)
        pos: torch.Tensor,  # (B, S, C)
        valid_mask: torch.Tensor,  # (B, S) True = real token
        lang_hidden: torch.Tensor,  # (B, T, l_dim)
        lang_valid: torch.Tensor,  # (B, T) True = real label slot
    ):
        f = self.cfg.fusion
        refs = encoder_reference_points(spatial_shapes, valid_ratios)
        last_start = sum(h * w for h, w in spatial_shapes[:-1]) if f.fusion_last_vis else 0
        out, lang = src, lang_hidden
        lang_states = []
        for b, (fuse, lang_layer) in enumerate(zip(self.VLFuse_layers, self.roberta_layers)):
            fused_v, lang = fuse.b_attn(
                out[:, last_start:], lang, pos[:, last_start:], lang_valid,
                valid_mask[:, last_start:],
            )
            out = torch.cat([out[:, :last_start], fused_v], dim=1) if last_start else fused_v
            lang = lang_layer(lang, alif_additive_bool_mask(lang_valid, lang.dtype))
            lang_states.append(lang)
            for j in range(f.fusion_interval):
                layer = self.layers[b * f.fusion_interval + j]
                out = layer(out, pos, refs, spatial_shapes, valid_mask)

        if not f.lang_aux_loss:
            return out, lang_states[-1]
        multi_lang = torch.stack(lang_states)
        return out, (multi_lang[::2] if f.fusion_interval == 1 else multi_lang)

