"""ParSe-DAB-DETR, the non-deformable DAB (dynamic anchor box) HOI model
(counterpart of rlipv2_tpu/models/dab_detr.py; reference ParSeDABDETR,
models/hoi.py:1421-1590, and the DAB-DETR transformer and conditional
decoder, models/DAB/transformer.py:71-178, 277-420, 575-700). All
attention is dense: no MSDA.

  * ConditionalDecoderLayer — self-attention with separate content and
    position projections of the queries and keys (scale 1/sqrt(hd)); the
    conditional concat cross-attention, whose per-head query is
    [content | sine position] and key [content | key position], so the
    scale is 1/sqrt(2 hd) and a head's logit is content·content +
    pos·pos; the first layer adds `ca_qpos_proj(query_pos)` to the
    content. Both attentions are explicit per-head matmuls, with float32
    logits (a masked key's logit -1e9), as the JAX einsums with
    preferred_element_type float32; nn.MultiheadAttention cannot express
    the concat form. As the JAX layer, neither attention has an output
    projection, which DAB-DETR's attention module has (ROADMAP queue 3).
  * ParSeDABDETR (`parse_dab_detr`) — one stride-32 ResNet level, DETR
    sine positions, `input_proj`, the dense encoder; 4-d anchors
    (`refpoint_embed`, first half subjects, second objects) whose sine
    embedding through `ref_point_head` is each layer's query position,
    scaled by `query_scale(tgt)` from the second layer on and its x and y
    halves by sigmoid(`ref_anchor_head`(tgt)) over the anchor's w and h
    (modulated HW attention: the JAX class's `modulate_hw_attn`, which no
    caller turns off); after each layer the shared subject and object box
    MLPs refine the anchors as sigmoid(tmp + inverse_sigmoid(ref)),
    detached before the next layer. The verb
    decoder is `models/parse.py`'s DecoderLayer stack from zero targets at
    the position `verb_refpoint(h[-1] + o[-1])`. Closed-vocabulary Linear
    heads (`models/closed_vocab.py`'s base): the object class from the
    object states, verbs from the verb states; the boxes are the refined
    anchors. No decoder applies a final norm (the JAX class has none).

Parameter names: DAB-DETR's where the JAX docstring cites them, the JAX
names elsewhere (the reference checkout, and so its exact keys, is not in
the repository):
  backbone.0.body.*                     <- ResNet_0
  input_proj (1x1 Conv2d)               <- input_proj (Dense)
  transformer.encoder.layers.{i}        <- enc_{i}
  transformer.decoder.layers.{i}.{sa_*_proj, ca_*_proj, norm1-3, linear1, linear2}
                                        <- dec_{i}
  transformer.decoder.{ref_point_head, query_scale, ref_anchor_head}
                                        <- the same names
  transformer.verb_decoder.layers.{i}   <- verb_dec_{i}
  transformer.verb_refpoint             <- verb_refpoint
  refpoint_embed (nn.Embedding), obj_class_embed, verb_class_embed,
  sub_bbox_embed, obj_bbox_embed        <- the same names
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from rlipv2_tpu_torch.config import ModelConfig, TransformerConfig
from rlipv2_tpu_torch.models.closed_vocab import _ClosedVocabBase
from rlipv2_tpu_torch.models.layers import MLP
from rlipv2_tpu_torch.models.parse import DenseDecoder, DenseEncoder, dense_tokens
from rlipv2_tpu_torch.ops.positional import gen_sineembed_for_position, inverse_sigmoid

MASKED_LOGIT = -1e9  # the JAX layer's fill for a padded key


def heads_attention(q, k, v, num_heads: int, key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Lq, H*e), k (B, Lk, H*e), v (B, Lk, H*hd) -> (B, Lq, H*hd): per
    head softmax(q k^T / sqrt(e)) v, the logits and softmax in float32 (a
    key where key_valid is False at MASKED_LOGIT), the weights cast back to
    v's dtype."""
    B, Lq, Lk = q.shape[0], q.shape[1], k.shape[1]
    qh = q.reshape(B, Lq, num_heads, -1).transpose(1, 2)
    kh = k.reshape(B, Lk, num_heads, -1).transpose(1, 2)
    vh = v.reshape(B, Lk, num_heads, -1).transpose(1, 2)
    with torch.autocast(device_type=q.device.type, enabled=False):
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(qh.shape[-1])
        if key_valid is not None:
            logits = logits.masked_fill(~key_valid[:, None, None, :], MASKED_LOGIT)
        att = logits.softmax(-1)
    out = torch.matmul(att.to(vh.dtype), vh)
    return out.transpose(1, 2).reshape(B, Lq, -1)


class ConditionalDecoderLayer(nn.Module):
    """`is_first` builds `ca_qpos_proj`, which only the first layer has."""

    def __init__(self, cfg: TransformerConfig, is_first: bool):
        super().__init__()
        d = cfg.hidden_dim
        self.nhead = cfg.nheads
        for name in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj", "sa_kpos_proj", "sa_v_proj"):
            self.add_module(name, nn.Linear(d, d))
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.ca_qcontent_proj = nn.Linear(d, d)
        self.ca_qpos_proj = nn.Linear(d, d) if is_first else None
        for name in ("ca_kcontent_proj", "ca_kpos_proj", "ca_v_proj", "ca_qpos_sine_proj"):
            self.add_module(name, nn.Linear(d, d))
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = nn.Linear(d, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, d)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)
        self.dropout1, self.dropout2, self.dropout3, self.dropout4 = (nn.Dropout(cfg.dropout) for _ in range(4))

    def forward(self, tgt, query_pos, query_sine_embed, memory, pos, mem_valid=None):
        """tgt and query_pos (B, nq, C), query_sine_embed (B, nq, C),
        memory and pos (B, S, C), mem_valid (B, S) bool."""
        B, nq, d = tgt.shape
        S, H = memory.shape[1], self.nhead
        q = self.sa_qcontent_proj(tgt) + self.sa_qpos_proj(query_pos)
        k = self.sa_kcontent_proj(tgt) + self.sa_kpos_proj(query_pos)
        sa = heads_attention(q, k, self.sa_v_proj(tgt), H)
        tgt = self.norm1(tgt + self.dropout1(sa))

        q_content = self.ca_qcontent_proj(tgt)
        if self.ca_qpos_proj is not None:
            q_content = q_content + self.ca_qpos_proj(query_pos)
        q_sine = self.ca_qpos_sine_proj(query_sine_embed)
        k_content, k_pos = self.ca_kcontent_proj(memory), self.ca_kpos_proj(pos)
        # per head [content | position]: (B, L, H, 2 hd) flattened
        q = torch.cat([q_content.view(B, nq, H, -1), q_sine.view(B, nq, H, -1)], dim=-1).view(B, nq, 2 * d)
        k = torch.cat([k_content.view(B, S, H, -1), k_pos.view(B, S, H, -1)], dim=-1).view(B, S, 2 * d)
        ca = heads_attention(q, k, self.ca_v_proj(memory), H, mem_valid)
        tgt = self.norm2(tgt + self.dropout2(ca))
        ff = self.linear2(self.dropout3(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + self.dropout4(ff))


class _DABDecoder(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.layers = nn.ModuleList(ConditionalDecoderLayer(cfg, i == 0) for i in range(cfg.dec_layers))
        self.ref_point_head = MLP(2 * d, d, d, 2)
        if cfg.dec_layers > 1:  # the JAX init creates it at the second layer's call
            self.query_scale = MLP(d, d, d, 2)
        self.ref_anchor_head = MLP(d, d, 2, 2)


class _DABTransformer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.encoder = DenseEncoder(cfg, cfg.enc_layers)
        self.decoder = _DABDecoder(cfg)
        self.verb_decoder = DenseDecoder(cfg, cfg.dec_layers)
        self.verb_refpoint = nn.Linear(cfg.hidden_dim, cfg.hidden_dim)


class ParSeDABDETR(_ClosedVocabBase):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d = cfg.transformer.hidden_dim
        self.input_proj = nn.Conv2d(self.backbone[0].body.out_channels[-1], d, 1)
        self.transformer = _DABTransformer(cfg.transformer)
        self.refpoint_embed = nn.Embedding(cfg.num_queries, 4)

    def _forward(self, pixels, pixel_valid):
        tr = self.transformer
        dec = tr.decoder
        src, pos, valid = dense_tokens(self._features(pixels)[-1], self.input_proj, pixel_valid)
        memory = tr.encoder(src, pos, valid)
        B, d = memory.shape[0], memory.shape[2]
        np_ = self.cfg.num_queries // 2
        ref = torch.sigmoid(self.refpoint_embed.weight.float())[None].expand(B, -1, -1)
        tgt = torch.zeros(B, ref.shape[1], d, dtype=memory.dtype, device=memory.device)
        hs, refs = [], []
        for lid, layer in enumerate(dec.layers):
            sine = gen_sineembed_for_position(ref, dim=d // 2)  # (B, nq, 2 d): [y, x, w, h]
            query_pos = dec.ref_point_head(sine)
            q_sine = sine[..., :d] if lid == 0 else sine[..., :d] * dec.query_scale(tgt)
            cond = torch.sigmoid(dec.ref_anchor_head(tgt))  # (B, nq, 2): conditions on (w, h)
            wy = cond[..., 1:2] / ref[..., 3:4].clamp(min=1e-6)
            wx = cond[..., 0:1] / ref[..., 2:3].clamp(min=1e-6)
            q_sine = torch.cat([q_sine[..., : d // 2] * wy, q_sine[..., d // 2:] * wx], dim=-1)
            tgt = layer(tgt, query_pos, q_sine, memory, pos, valid)
            hs.append(tgt)
            tmp = torch.cat([self.sub_bbox_embed(tgt[:, :np_]), self.obj_bbox_embed(tgt[:, np_:])], dim=1)
            new_ref = torch.sigmoid(tmp.float() + inverse_sigmoid(ref))
            refs.append(new_ref)
            ref = new_ref.detach()
        hs, boxes = torch.stack(hs), torch.stack(refs)
        hs_h, hs_o = hs[:, :, :np_], hs[:, :, np_:]
        vqpos = tr.verb_refpoint(hs_h[-1] + hs_o[-1])
        hs_v = tr.verb_decoder(torch.zeros_like(vqpos), vqpos, memory, pos, valid)
        return self.outputs(self.obj_class_embed(hs_o).float(), self.verb_class_embed(hs_v).float(),
                            boxes[:, :, :np_], boxes[:, :, np_:])
