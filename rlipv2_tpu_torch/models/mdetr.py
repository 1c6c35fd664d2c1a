"""RLIP-ParSe v1 as the reference wires it (counterpart of
rlipv2_tpu/models/mdetr.py::RLIPParSeV1Joint, :203-375; reference
models/ParSetransformer.py:963-1207 and models/hoi.py:2259-2515).

  * one stride-32 backbone level, DETR sine positions, `input_proj`;
  * the label texts' pooled features, resized to hidden_dim, joined to the
    image tokens: [image ; text] through the post-norm encoder with zero
    text positions and one key mask over both; no final norm, so each
    layer's output is an intermediate;
  * the ho and verb decoders cross-attend the last joint memory, each with
    one final LayerNorm applied to every layer's output; the verb decoder's
    queries are zero targets at position h[-1] + o[-1] (normed);
  * classification of decoder layer i reads the text half of encoder
    intermediate (enc_layers - dec_layers + i), normalised, halved and
    projected, in RLIP-ParSe's einsum heads.
The model has no text encoder: it takes pooled label features, which a
caller computes (the JAX class has none either). `forward(...,
return_states=True)` adds `states`: the ho and verb decoders' normed
per-layer states and every encoder layer's text half (the JAX
`return_states`). The JAX class's `features=` (a bypass of the backbone
that only its reference-parity test sets) is not ported (ROADMAP queue 1
item 20).

Parameter names are the reference ParSeTransformer's under `transformer.`
(the names `tests/test_parse_v1_parity.py::_convert` and the JAX
`convert_detr_detector` read), and RLIP_ParSe's around it:
  backbone.0.body.*                      <- ResNet_0
  input_proj (1x1 Conv2d)                <- input_proj (Dense)
  transformer.resizer.{fc,layer_norm}    <- resizer
  transformer.encoder.layers.{i}         <- enc_{i}
  transformer.{ho,verb}_decoder.layers.{i}.{self_attn, cross_attn_image,
    norm1, norm3, norm4, linear1, linear2}
                                         <- {ho,verb}_dec_{i}.{self_attn, cross_attn, norm1, norm2, norm3, ...}
  transformer.{ho,verb}_decoder.norm     <- {ho,verb}_decoder_norm
  query_embed, {sub,obj}_bbox_embed, projection_text, bias_obj_a,
  bias_pred_a                            <- the same names
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rlipv2_tpu_torch.config import ModelConfig
from rlipv2_tpu_torch.models.layers import FeatureResizer
from rlipv2_tpu_torch.models.parse import DenseDecoder, DenseEncoder, DenseParSe, MDETRDecoderLayer


class _JointTransformer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        t = cfg.transformer
        self.encoder = DenseEncoder(t, t.enc_layers)
        self.ho_decoder = DenseDecoder(t, t.dec_layers, MDETRDecoderLayer, norm=True)
        self.verb_decoder = DenseDecoder(t, t.dec_layers, MDETRDecoderLayer, norm=True)
        self.resizer = FeatureResizer(cfg.text_encoder.hidden_size, t.hidden_dim, dropout=t.dropout)


class RLIPParSeV1Joint(DenseParSe):
    def __init__(self, cfg: ModelConfig):
        if not cfg.backbone.name.startswith("resnet"):
            raise NotImplementedError(f"RLIPParSeV1Joint takes a ResNet backbone (as its JAX class), "
                                      f"not {cfg.backbone.name}")
        super().__init__(cfg)
        self.transformer = _JointTransformer(cfg)
        self.query_embed = nn.Embedding(cfg.num_queries, cfg.transformer.hidden_dim)

    def forward(
        self,
        pixels: torch.Tensor,  # (B, H, W, 3) uint8, or float32 normalized
        pixel_valid: torch.Tensor,  # (B, H, W) bool, True = real pixel
        text_emb: torch.Tensor,  # (B, T, l_dim) pooled label features
        text_valid: torch.Tensor,  # (B, T) bool, True = real label slot
        n_obj_texts: Optional[int] = None,
        generator: Optional[torch.Generator] = None,  # unused: a ResNet draws nothing
        return_states: bool = False,
    ) -> dict:
        n_obj = self.cfg.max_obj_texts if n_obj_texts is None else n_obj_texts
        with self._autocast(pixels.device):
            return self._forward(pixels, pixel_valid, text_emb, text_valid, n_obj, return_states)

    def _forward(self, pixels, pixel_valid, text_emb, text_valid, n_obj, return_states):
        t = self.cfg.transformer
        tr = self.transformer
        src, pos, valid = self._image_tokens(pixels, pixel_valid)
        S = src.shape[1]
        text = tr.resizer(text_emb)
        joint = torch.cat([src, text], dim=1)
        joint_pos = torch.cat([pos, torch.zeros(text.shape, dtype=pos.dtype, device=pos.device)], dim=1)
        joint_valid = torch.cat([valid, text_valid], dim=1)
        inters = tr.encoder(joint, joint_pos, joint_valid, intermediates=True)
        memory = inters[-1]

        B = src.shape[0]
        qpos = self.query_embed.weight[None].expand(B, *self.query_embed.weight.shape)
        hs_ho = tr.ho_decoder(torch.zeros_like(qpos), qpos, memory, joint_pos, joint_valid)
        np_ = hs_ho.shape[2] // 2
        hs_h, hs_o = hs_ho[:, :, :np_], hs_ho[:, :, np_:]
        vqpos = hs_h[-1] + hs_o[-1]
        hs_verb = tr.verb_decoder(torch.zeros_like(vqpos), vqpos, memory, joint_pos, joint_valid)

        levels = []
        for lvl in range(t.dec_layers):
            # the text states of the last dec_layers encoder layers
            # (reference hoi.py:2406)
            proj = self._project_text(inters[t.enc_layers - t.dec_layers + lvl][:, S:])
            levels.append((self._logits(hs_o[lvl], self.bias_obj_a, proj[:, :n_obj]),
                           self._logits(hs_verb[lvl], self.bias_pred_a, proj[:, n_obj:]), hs_h[lvl], hs_o[lvl]))
        out = self._outputs(levels)
        if return_states:
            out["states"] = {"hs_ho": hs_ho.float(), "hs_verb": hs_verb.float(),
                             "text_states": torch.stack([x[:, S:] for x in inters]).float()}
        return out
