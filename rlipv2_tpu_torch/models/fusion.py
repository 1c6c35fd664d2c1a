"""ALIF cross-modal fusion (counterpart of rlipv2_tpu/models/fusion.py).

  * BiMultiHeadAttention — reference models/fuse_helper.py:314-466: one
    QK^T shared by both directions; softmax over text gives
    vision -> language attention, softmax over visual tokens of the
    (max-stabilised) transpose gives language -> vision attention. The
    fp16-era +-50000 clamps are kept. `int8_dense` makes its six
    projections W8A8 (ops/int8_dense.py).
  * BiAttentionBlock — reference models/fuse_helper.py:591-752: pre-LN on
    both modalities, then a residual on the normed features with the
    gating mechanism. Only the preset's `VXAc` gating is ported; the
    other reference modes raise NotImplementedError.

Reference quirk kept on purpose: the reference fills a BOOL mask with
-9e15, which casts to True, so both attention masks add a constant 1.0 per
softmax row and have no effect. Both masks are therefore ignored here too.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from rlipv2_tpu_torch.config import FusionConfig
from rlipv2_tpu_torch.ops.int8_dense import linear

PORTED_GATINGS = ("VXAc",)


class BiMultiHeadAttention(nn.Module):
    def __init__(
        self,
        v_dim: int = 256,
        l_dim: int = 768,
        embed_dim: int = 2048,
        num_heads: int = 8,
        dropout: float = 0.1,
        stable_softmax_2d: bool = False,
        clamp_min_for_underflow: bool = True,
        clamp_max_for_overflow: bool = True,
        int8_dense: bool = False,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.stable_softmax_2d = stable_softmax_2d
        self.clamp_min = clamp_min_for_underflow
        self.clamp_max = clamp_max_for_overflow
        i8 = int8_dense
        self.v_proj = linear(v_dim, embed_dim, int8=i8)
        self.l_proj = linear(l_dim, embed_dim, int8=i8)
        self.values_v_proj = linear(v_dim, embed_dim, int8=i8)
        self.values_l_proj = linear(l_dim, embed_dim, int8=i8)
        self.out_v_proj = linear(embed_dim, v_dim, int8=i8)
        self.out_l_proj = linear(embed_dim, l_dim, int8=i8)
        self.dropout = nn.Dropout(dropout)

    def _clamp(self, x: torch.Tensor) -> torch.Tensor:
        if self.clamp_min:
            x = x.clamp(min=-50000.0)
        if self.clamp_max:
            x = x.clamp(max=50000.0)
        return x

    def forward(
        self,
        v: torch.Tensor,  # (B, Nv, v_dim)
        l: torch.Tensor,  # (B, Nl, l_dim)
        v_pos: Optional[torch.Tensor] = None,
        mask_l: Optional[torch.Tensor] = None,  # ignored (reference quirk)
        mask_v: Optional[torch.Tensor] = None,  # ignored (reference quirk)
    ):
        del mask_l, mask_v
        B, Nv, _ = v.shape
        Nl = l.shape[1]
        H = self.num_heads
        hd = self.embed_dim // H

        def heads(x, n):
            return x.view(B, n, H, hd).transpose(1, 2)  # (B, H, n, hd)

        q = self.v_proj(v if v_pos is None else v + v_pos) * hd ** -0.5
        k = self.l_proj(l)
        logits = heads(q, Nv) @ heads(k, Nl).transpose(-1, -2)  # (B, H, Nv, Nl)
        if self.stable_softmax_2d:
            logits = logits - logits.max().detach()
        logits = self._clamp(logits)

        logits_t = logits.transpose(2, 3)  # (B, H, Nl, Nv)
        logits_t = self._clamp(logits_t - logits_t.max(dim=-1, keepdim=True)[0].detach())
        attn_l = self.dropout(F.softmax(logits_t.float(), dim=-1))
        attn_v = self.dropout(F.softmax(logits.float(), dim=-1))

        val_v = heads(self.values_v_proj(v), Nv)
        val_l = heads(self.values_l_proj(l), Nl)
        out_v = (attn_v.to(val_l.dtype) @ val_l).transpose(1, 2).reshape(B, Nv, self.embed_dim)
        out_l = (attn_l.to(val_v.dtype) @ val_v).transpose(1, 2).reshape(B, Nl, self.embed_dim)
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


class BiAttentionBlock(nn.Module):
    """Pre-LN bi-attention with the gated residual (parameter names of the
    reference `b_attn`)."""

    def __init__(
        self,
        cfg: FusionConfig,
        v_dim: int = 256,
        l_dim: int = 768,
        num_feature_levels: int = 4,
        int8_dense: bool = False,
    ):
        super().__init__()
        if cfg.gating_mechanism not in PORTED_GATINGS:
            raise NotImplementedError(
                f"gating mechanism {cfg.gating_mechanism!r} is not ported; "
                f"ported: {PORTED_GATINGS}"
            )
        self.gating = cfg.gating_mechanism
        init_values = 1.0 / num_feature_levels
        self.gamma_v = nn.Parameter(torch.full((v_dim,), init_values))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), init_values))
        self.layer_norm_v = nn.LayerNorm(v_dim, eps=1e-5)
        self.layer_norm_l = nn.LayerNorm(l_dim, eps=1e-5)
        self.attn = BiMultiHeadAttention(
            v_dim=v_dim,
            l_dim=l_dim,
            embed_dim=cfg.embed_dim,
            num_heads=cfg.num_heads,
            stable_softmax_2d=cfg.stable_softmax_2d,
            clamp_min_for_underflow=cfg.clamp_min_for_underflow,
            clamp_max_for_overflow=cfg.clamp_max_for_overflow,
            int8_dense=int8_dense,
        )

    def forward(self, v, l, v_pos=None, mask_l=None, mask_v=None):
        v = self.layer_norm_v(v)
        l = self.layer_norm_l(l)
        delta_v, delta_l = self.attn(v, l, v_pos, mask_l, mask_v)
        # VXAc: one scalar gate per modality, the first gamma entry
        return v + self.gamma_v[0] * delta_v, l + self.gamma_l[0] * delta_l
