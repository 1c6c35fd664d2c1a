"""DAB deformable decoders for ParSe HOI decoding (counterpart of
rlipv2_tpu/models/dab_decoder.py; reference
models/dab_deformable/deformable_transformer.py:1346-1649).

  * DeformableDecoderLayer (:1346-1402): self-attention, MSDeformAttn
    cross-attention, FFN, post-LN; `msda_impl` and `int8_dense` (the MSDA
    projections and the FFN) as the JAX layer takes them.
  * DABHOIDecoder (:1404-1649), unrolled over its layers:
      - ParSe mode (ho decoder): queries are [subjects || objects], each half
        with its own 4-d anchor; every layer embeds the anchors of the first
        level (sine embedding -> shared `ref_point_head` MLP), scaled by the
        shared `query_scale(output)` from layer 1 on (layer 0 uses scale 1);
      - verb mode: the reference box is the midpoint of the subject and
        object anchors;
      - box refinement: per-layer `sub_bbox_embed.{i}` / `obj_bbox_embed.{i}`
        MLPs refine the anchors, which are detached between layers.
  * DAB without box refinement (`refine_boxes=False`, ParSe-DAB-DDETR's
    verb decoder, `models/closed_vocab.py`): the anchors' sine embedding
    and its scaling as above, but the anchors stay fixed over the layers
    and the decoder holds no box heads.
  * The plain-deformable mode of the same class (`use_dab=False`; JAX
    :133-340 with `use_dab=False, refine_boxes=False`, reference
    models/deformable_transformer.py:390-483), RLIP-ParSeD's decoders and
    the closed-vocabulary zoo's: a learned `query_pos` comes in, the
    reference points (2-d, or QAHOI two-stage's 4-d proposal boxes) are
    scaled by the valid ratios and stay fixed over the layers (the verb
    decoder takes the subject/object midpoint), and the decoder holds no
    `ref_point_head`, `query_scale` or box heads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from rlipv2_tpu_torch.config import TransformerConfig
from rlipv2_tpu_torch.models.layers import MLP, MSDeformAttention
from rlipv2_tpu_torch.ops.int8_dense import linear
from rlipv2_tpu_torch.ops.positional import gen_sineembed_for_position, inverse_sigmoid


class DeformableDecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.cross_attn = MSDeformAttention(
            d, cfg.num_feature_levels, cfg.nheads, cfg.dec_n_points, cfg.msda_impl, cfg.int8_dense
        )
        self.dropout1 = nn.Dropout(cfg.dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.self_attn = nn.MultiheadAttention(d, cfg.nheads, dropout=cfg.dropout, batch_first=True)
        self.dropout2 = nn.Dropout(cfg.dropout)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = linear(d, cfg.dim_feedforward, int8=cfg.int8_dense)
        self.dropout3 = nn.Dropout(cfg.dropout)
        self.linear2 = linear(cfg.dim_feedforward, d, int8=cfg.int8_dense)
        self.dropout4 = nn.Dropout(cfg.dropout)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)

    def forward(
        self,
        tgt: torch.Tensor,  # (B, nq, C)
        query_pos: torch.Tensor,  # (B, nq, C)
        reference_points: torch.Tensor,  # (B, nq, L, 4) scaled by valid ratios
        src: torch.Tensor,  # (B, S, C)
        spatial_shapes: Sequence[tuple[int, int]],
        src_valid_mask: Optional[torch.Tensor] = None,  # (B, S) True = real
    ) -> torch.Tensor:
        q = tgt + query_pos
        sa = self.self_attn(q, q, tgt, need_weights=False)[0]
        tgt = self.norm2(tgt + self.dropout2(sa))
        ca = self.cross_attn(tgt + query_pos, reference_points, src, spatial_shapes, src_valid_mask)
        tgt = self.norm1(tgt + self.dropout1(ca))
        ff = self.linear2(self.dropout3(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + self.dropout4(ff))


class DABHOIDecoder(nn.Module):
    """The ho path's (parse=True) or the verb path's (parse=False) decoder:
    DAB with 4-d anchors, with box refinement (`refine_boxes`) or without,
    or plain deformable with fixed reference points and a learned query
    position. The JAX class's `refine_boxes` needs `use_dab` here: its
    models build no other combination."""

    def __init__(self, cfg: TransformerConfig, parse: bool = True, use_dab: bool = True,
                 refine_boxes: bool = True):
        super().__init__()
        d = cfg.hidden_dim
        self.parse = parse
        self.use_dab = use_dab
        self.refine_boxes = use_dab and refine_boxes
        self.layers = nn.ModuleList(DeformableDecoderLayer(cfg) for _ in range(cfg.dec_layers))
        if use_dab:
            self.query_scale = MLP(d, d, d, 2)
            self.ref_point_head = MLP(4 * (d // 2), d, d, 2)
        if self.refine_boxes:
            self.sub_bbox_embed = nn.ModuleList(MLP(d, d, 4, 3) for _ in range(cfg.dec_layers))
            self.obj_bbox_embed = nn.ModuleList(MLP(d, d, 4, 3) for _ in range(cfg.dec_layers))

    def forward(
        self,
        tgt: torch.Tensor,  # (B, nq, C); verb mode (B, n_pairs, C)
        sub_ref: torch.Tensor,  # (B, n_pairs, 4) anchors in (0, 1)
        obj_ref: torch.Tensor,
        src: torch.Tensor,  # (B, S, C)
        spatial_shapes: Sequence[tuple[int, int]],
        valid_ratios: torch.Tensor,  # (B, L, 2)
        src_valid_mask: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,  # (B, nq, C): the plain mode's learned position
    ) -> dict:
        """Returns per-layer stacks: hs (layers, B, nq, C); in DAB mode also
        sub_refs/obj_refs (layers, B, n_pairs, 4) detached anchors (fixed
        without refinement) and, refining, sub_boxes/obj_boxes the same
        boxes before detaching."""
        if not self.use_dab:
            return self._plain(tgt, sub_ref, obj_ref, src, spatial_shapes, valid_ratios, src_valid_mask,
                               query_pos)
        if sub_ref.shape[-1] != 4:
            raise ValueError("the DAB decoder needs 4-d anchors")
        n_pairs = sub_ref.shape[1]
        vr = torch.cat([valid_ratios, valid_ratios], dim=-1)[:, None]  # (B, 1, L, 4)
        output = tgt
        hs, sub_refs, obj_refs, sub_boxes, obj_boxes = [], [], [], [], []
        for lid, layer in enumerate(self.layers):
            if self.parse:
                ref_input = torch.cat([sub_ref[:, :, None] * vr, obj_ref[:, :, None] * vr], dim=1)
            else:
                ref_input = (0.5 * (sub_ref + obj_ref))[:, :, None] * vr
            sine = gen_sineembed_for_position(ref_input[:, :, 0, :], dim=output.shape[-1] // 2)
            query_pos = self.ref_point_head(sine)
            if lid > 0:
                query_pos = self.query_scale(output) * query_pos
            output = layer(output, query_pos, ref_input, src, spatial_shapes, src_valid_mask)
            hs.append(output)
            if self.refine_boxes:
                sub_in = output[:, :n_pairs] if self.parse else output
                obj_in = output[:, n_pairs:] if self.parse else output
                new_sub = torch.sigmoid(self.sub_bbox_embed[lid](sub_in) + inverse_sigmoid(sub_ref))
                new_obj = torch.sigmoid(self.obj_bbox_embed[lid](obj_in) + inverse_sigmoid(obj_ref))
                sub_ref, obj_ref = new_sub.detach(), new_obj.detach()
                sub_boxes.append(new_sub)
                obj_boxes.append(new_obj)
            sub_refs.append(sub_ref)
            obj_refs.append(obj_ref)
        out = {"hs": torch.stack(hs), "sub_refs": torch.stack(sub_refs), "obj_refs": torch.stack(obj_refs)}
        if self.refine_boxes:
            out.update(sub_boxes=torch.stack(sub_boxes), obj_boxes=torch.stack(obj_boxes))
        return out

    def _plain(self, tgt, sub_ref, obj_ref, src, spatial_shapes, valid_ratios, src_valid_mask, query_pos):
        """Plain deformable decoding: fixed reference points, 2-d or 4-d
        boxes (the subject/object midpoint on the verb path), scaled by the
        valid ratios, and the caller's query position at every layer."""
        if sub_ref.shape[-1] not in (2, 4) or query_pos is None:
            raise ValueError("the plain deformable decoder takes 2-d or 4-d reference points and a query_pos")
        vr = valid_ratios if sub_ref.shape[-1] == 2 else torch.cat([valid_ratios, valid_ratios], dim=-1)
        vr = vr[:, None]  # (B, 1, L, 2 or 4)
        if self.parse:
            ref_input = torch.cat([sub_ref[:, :, None] * vr, obj_ref[:, :, None] * vr], dim=1)
        else:
            ref_input = (0.5 * (sub_ref + obj_ref))[:, :, None] * vr
        output, hs = tgt, []
        for layer in self.layers:
            output = layer(output, query_pos, ref_input, src, spatial_shapes, src_valid_mask)
            hs.append(output)
        return {"hs": torch.stack(hs)}
