"""The MDETR-style joint image-text models: RLIP-MDETR and RLIP-ParSe v1 as
the reference wires it (counterpart of rlipv2_tpu/models/mdetr.py). Both
take pooled label features (no text encoder of their own: a caller
computes them, as for the JAX classes) and share one joint encoding:

  * one stride-32 backbone level, DETR sine positions, `input_proj`;
  * the label texts' pooled features, resized to hidden_dim, joined to the
    image tokens: [image ; text] through the post-norm encoder with zero
    text positions and one key mask over both; no final norm;
  * the ho and verb decoders cross-attend the joint memory.

RLIPMDETR (`rlip_mdetr`; JAX :39-200, reference
models/mdetr_transformer.py:25-186, 358-404): the ho decoder from zero
targets at the learned query positions, the verb decoder from the MBF
fusion of each pair's last subject and object states at `verb_query_embed`;
no decoder norm; every decoder layer's heads read the text half of the
LAST encoder layer's output, normalised, halved and projected, in
RLIP-ParSe's einsum heads.

RLIPParSeV1Joint (`rlip_parse_v1_joint`; JAX :203-375, reference
models/ParSetransformer.py:963-1207 and models/hoi.py:2259-2515):
  * each layer's encoder output is an intermediate;
  * the decoders each apply one final LayerNorm to every layer's output;
    the verb decoder's queries are zero targets at position h[-1] + o[-1]
    (normed);
  * classification of decoder layer i reads the text half of encoder
    intermediate (enc_layers - dec_layers + i).
`forward(..., return_states=True)` adds `states`: the ho and verb decoders'
normed per-layer states and every encoder layer's text half (the JAX
`return_states`). `forward(..., features=(src, pos, valid))` takes image
tokens (B, S, C), their positions (B, S, C) and validity (B, S) in place
of the backbone's (the JAX `features=`).

Parameter names are the reference ParSeTransformer's under `transformer.`
(the names `tests/test_parse_v1_parity.py::_convert` and the JAX
`convert_detr_detector` read; its MDETR decoder layer's text
cross-attention slot, norm2, is unused upstream), and RLIP_ParSe's around
it:
  backbone.0.body.*                      <- ResNet_0 (V1Joint), backbone (RLIPMDETR)
  input_proj (1x1 Conv2d)                <- input_proj (Dense)
  transformer.resizer.{fc,layer_norm}    <- resizer
  transformer.encoder.layers.{i}         <- enc_{i}
  transformer.{ho,verb}_decoder.layers.{i}.{self_attn, cross_attn_image,
    norm1, norm3, norm4, linear1, linear2}
                                         <- {ho,verb}_dec_{i}.{self_attn, cross_attn, norm1, norm2, norm3, ...}
  transformer.{ho,verb}_decoder.norm     <- {ho,verb}_decoder_norm (V1Joint)
  transformer.verb_tgt_generator.fc_{1,2,3}.{k}
                                         <- verb_tgt_generator (RLIPMDETR)
  query_embed, verb_query_embed (RLIPMDETR), {sub,obj}_bbox_embed,
  projection_text, bias_obj_a, bias_pred_a
                                         <- the same names
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rlipv2_tpu_torch.config import ModelConfig
from rlipv2_tpu_torch.models.layers import FeatureResizer, MultiBranchFusion
from rlipv2_tpu_torch.models.parse import DenseDecoder, DenseEncoder, DenseParSe, MDETRDecoderLayer


class _JointTransformer(nn.Module):
    def __init__(self, cfg: ModelConfig, decoder_norm: bool):
        super().__init__()
        t = cfg.transformer
        self.encoder = DenseEncoder(t, t.enc_layers)
        self.ho_decoder = DenseDecoder(t, t.dec_layers, MDETRDecoderLayer, norm=decoder_norm)
        self.verb_decoder = DenseDecoder(t, t.dec_layers, MDETRDecoderLayer, norm=decoder_norm)
        self.resizer = FeatureResizer(cfg.text_encoder.hidden_size, t.hidden_dim, dropout=t.dropout)


class _JointParSe(DenseParSe):
    """The joint [image ; text] encoding both models share."""

    DECODER_NORM = False

    def __init__(self, cfg: ModelConfig):
        if not cfg.backbone.name.startswith("resnet"):
            raise NotImplementedError(f"{type(self).__name__} takes a ResNet backbone (as its JAX class), "
                                      f"not {cfg.backbone.name}")
        super().__init__(cfg)
        self.transformer = _JointTransformer(cfg, self.DECODER_NORM)
        self.query_embed = nn.Embedding(cfg.num_queries, cfg.transformer.hidden_dim)

    def _joint_encode(self, image_tokens: tuple, text_emb, text_valid) -> tuple:
        """(src, pos, valid) of the image and the pooled text features ->
        (every encoder layer's output over [image ; text], the joint
        positions, the joint key validity, the count of image tokens)."""
        src, pos, valid = image_tokens
        text = self.transformer.resizer(text_emb)
        joint = torch.cat([src, text], dim=1)
        joint_pos = torch.cat([pos, torch.zeros(text.shape, dtype=pos.dtype, device=pos.device)], dim=1)
        joint_valid = torch.cat([valid, text_valid], dim=1)
        return self.transformer.encoder(joint, joint_pos, joint_valid, intermediates=True), joint_pos, joint_valid, \
            src.shape[1]

    def _decode_ho(self, memory, joint_pos, joint_valid) -> torch.Tensor:
        B = memory.shape[0]
        qpos = self.query_embed.weight[None].expand(B, *self.query_embed.weight.shape)
        return self.transformer.ho_decoder(torch.zeros_like(qpos), qpos, memory, joint_pos, joint_valid)


class RLIPMDETR(_JointParSe):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d = cfg.transformer.hidden_dim
        self.verb_query_embed = nn.Embedding(cfg.num_queries // 2, d)
        self.transformer.verb_tgt_generator = MultiBranchFusion(d, d, d, 16)

    def forward(
        self,
        pixels: torch.Tensor,  # (B, H, W, 3) uint8, or float32 normalized
        pixel_valid: torch.Tensor,  # (B, H, W) bool, True = real pixel
        text_emb: torch.Tensor,  # (B, T, l_dim) pooled label features
        text_valid: torch.Tensor,  # (B, T) bool, True = real label slot
        n_obj_texts: Optional[int] = None,
        generator: Optional[torch.Generator] = None,  # unused: a ResNet draws nothing
    ) -> dict:
        n_obj = self.cfg.max_obj_texts if n_obj_texts is None else n_obj_texts
        with self._autocast(pixels.device):
            return self._forward(pixels, pixel_valid, text_emb, text_valid, n_obj)

    def _forward(self, pixels, pixel_valid, text_emb, text_valid, n_obj):
        tr = self.transformer
        inters, joint_pos, joint_valid, S = self._joint_encode(self._image_tokens(pixels, pixel_valid), text_emb,
                                                               text_valid)
        memory = inters[-1]
        hs_ho = self._decode_ho(memory, joint_pos, joint_valid)
        np_ = hs_ho.shape[2] // 2
        hs_h, hs_o = hs_ho[:, :, :np_], hs_ho[:, :, np_:]
        B = memory.shape[0]
        vqpos = self.verb_query_embed.weight[None].expand(B, *self.verb_query_embed.weight.shape)
        vt = tr.verb_tgt_generator(hs_h[-1], hs_o[-1])
        hs_verb = tr.verb_decoder(vt, vqpos, memory, joint_pos, joint_valid)
        proj = self._project_text(memory[:, S:])  # the post-encoder text states
        return self._outputs([(self._logits(hs_o[lvl], self.bias_obj_a, proj[:, :n_obj]),
                               self._logits(hs_verb[lvl], self.bias_pred_a, proj[:, n_obj:]), hs_h[lvl], hs_o[lvl])
                              for lvl in range(hs_ho.shape[0])])


class RLIPParSeV1Joint(_JointParSe):
    DECODER_NORM = True

    def forward(
        self,
        pixels: torch.Tensor,  # (B, H, W, 3) uint8, or float32 normalized
        pixel_valid: torch.Tensor,  # (B, H, W) bool, True = real pixel
        text_emb: torch.Tensor,  # (B, T, l_dim) pooled label features
        text_valid: torch.Tensor,  # (B, T) bool, True = real label slot
        n_obj_texts: Optional[int] = None,
        generator: Optional[torch.Generator] = None,  # unused: a ResNet draws nothing
        return_states: bool = False,
        features: Optional[tuple] = None,  # (src, pos, valid) in place of the backbone's
    ) -> dict:
        n_obj = self.cfg.max_obj_texts if n_obj_texts is None else n_obj_texts
        with self._autocast(pixels.device):
            return self._forward(pixels, pixel_valid, text_emb, text_valid, n_obj, return_states, features)

    def _forward(self, pixels, pixel_valid, text_emb, text_valid, n_obj, return_states, features):
        t = self.cfg.transformer
        tr = self.transformer
        image_tokens = self._image_tokens(pixels, pixel_valid) if features is None else features
        inters, joint_pos, joint_valid, S = self._joint_encode(image_tokens, text_emb, text_valid)
        memory = inters[-1]
        hs_ho = self._decode_ho(memory, joint_pos, joint_valid)
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
