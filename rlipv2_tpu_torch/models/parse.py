"""RLIP-ParSe, the vanilla-DETR open-vocabulary relation detectors
(counterpart of rlipv2_tpu/models/parse.py; reference models/hoi.py:2259-2515
and models/ParSetransformer.py:963-1503). All attention here is dense: no
MSDA. With a Swin backbone window attention runs in the backbone.

  * DenseAttention — flax `nn.MultiHeadDotProductAttention` under
    `nn.MultiheadAttention`'s parameter names: `key_valid` True where a key
    is attended; a masked key's logit is the dtype's minimum, as flax fills
    it, so a query with no valid key attends to all evenly.
  * EncoderLayer — DETR encoder layer, self-attention with the position
    added to the queries and keys, then the FFN, post-norm (JAX :48-92;
    its `pre_norm` form, which no caller sets, is not ported: ROADMAP queue
    1 item 20).
  * DecoderLayer — self-attention, cross-attention to the memory, FFN,
    post-norm (JAX :94-125); `MDETRDecoderLayer` is the same layer under the
    reference's MDETR names (`cross_attn_image`, norms 1/3/4), which
    `models/mdetr.py` uses.
  * FusionEncoder — encoder layers over [queries ; text], both halves
    returned (JAX :127-148).
  * VanillaALIFEncoder — every `fusion_interval` layers a VLFuse block over
    the one feature level and ONE RoBERTa layer on the language path, then
    the dense encoder layer (JAX :150-205; reference
    ParSetransformer.py:1535-1610).
  * RLIPParSe (`parse`, `rlip_parse`; JAX :207-372) — one backbone level
    (stride 32), DETR sine positions, `input_proj`, the dense encoder, the ho
    decoder from zero targets, MBF verb targets for the verb decoder, and
    decode-time fusion: each decoder layer's object (verb) states run
    through `obj_fusion` (`verb_fusion`) with the resized object (verb)
    texts, whose text half the einsum heads read.
  * RLIPParSeV2 (`rlip_parse_v2`; JAX :373-544) — the same backbone and
    decoders behind the VanillaALIFEncoder; verb queries are zero targets at
    position h[-1] + o[-1]; the heads read the per-fusion language states
    resized to hidden_dim; it also returns `verb_decoder_out` and
    `lang_states`.
Heads, as RLIP-ParSeDA's: states (+ `bias_obj_a` / `bias_pred_a`) against
the L2-normalised, halved, projected texts in float32, plus the prior-prob
bias; boxes are sigmoid(MLP(state)). `cfg.dtype == "bfloat16"` runs the
forward under bf16 autocast.

Parameter names, and the JAX leaves they hold (`engine/convert.py`):
  backbone.0.body.*                     <- backbone
  input_proj (1x1 Conv2d)               <- input_proj (Dense)
  transformer.text_encoder.*            <- text_encoder
  transformer.resizer.{fc,layer_norm}   <- resizer
  transformer.encoder.layers.{i}        <- enc_{i} (RLIPParSe), encoder/layer_{i} (V2)
  transformer.encoder.roberta_layers.{f}, .VLFuse_layers.{f}.b_attn
                                        <- encoder/lang_layer_{f}, encoder/vl_fuse_{f} (V2)
  transformer.{ho,verb}_decoder.layers.{i}
                                        <- {ho,verb}_dec_{i}
  transformer.{obj,verb}_fusion.layers.{i}
                                        <- {obj,verb}_fusion/layer_{i} (RLIPParSe)
  transformer.verb_tgt_generator.fc_{1,2,3}.{k}
                                        <- verb_tgt_generator (RLIPParSe)
  query_embed, verb_query_embed (RLIPParSe), {sub,obj}_bbox_embed,
  projection_text, bias_obj_a, bias_pred_a
                                        <- the same names
Each attention's `in_proj_weight` / `in_proj_bias` / `out_proj` packs the
flax query, key, value and out kernels. The optimizer groups follow from
`backbone.` and `transformer.text_encoder.` (`engine/optim.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from rlipv2_tpu_torch.config import ModelConfig, TextEncoderConfig, TransformerConfig
from rlipv2_tpu_torch.models.deformable import VLFuse
from rlipv2_tpu_torch.models.layers import MLP, FeatureResizer, MultiBranchFusion, normalize_pixels
from rlipv2_tpu_torch.models.parseda import BIAS_C, _Backbone, check_options, downsample_mask, text_per_decoder_layer
from rlipv2_tpu_torch.models.roberta import RobertaLayer, RobertaModel, alif_additive_bool_mask
from rlipv2_tpu_torch.models.swin import SwinTransformer
from rlipv2_tpu_torch.ops.positional import sine_position_embedding


class DenseAttention(nn.Module):
    """Multi-head attention: q, k, v projected, softmax(q k^T / sqrt(hd))
    v per head, the heads projected out; attention dropout in train mode."""

    def __init__(self, d: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v, key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q (B, Lq, d), k and v (B, Lk, d), key_valid (B, Lk) bool."""
        B, Lq, d = q.shape
        Lk = k.shape[1]
        H = self.num_heads
        ws, bs = self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)

        def heads(x, i, n):
            return F.linear(x, ws[i], bs[i]).view(B, n, H, d // H).transpose(1, 2)

        qh, kh, vh = heads(q, 0, Lq), heads(k, 1, Lk), heads(v, 2, Lk)
        mask = None
        if key_valid is not None:
            mask = torch.zeros(B, 1, 1, Lk, dtype=qh.dtype, device=q.device).masked_fill(
                ~key_valid[:, None, None, :], torch.finfo(qh.dtype).min)
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                             dropout_p=self.dropout if self.training else 0.0)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, d))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.self_attn = DenseAttention(d, cfg.nheads, cfg.dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = nn.Linear(d, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, d)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.dropout1, self.dropout2, self.dropout3 = (nn.Dropout(cfg.dropout) for _ in range(3))

    def forward(self, x, pos, key_valid=None):
        x = self.norm1(x + self.dropout1(self.self_attn(x + pos, x + pos, x, key_valid)))
        return self.norm2(x + self.dropout3(self.linear2(self.dropout2(F.relu(self.linear1(x))))))


class DecoderLayer(nn.Module):
    # the names of the cross-attention and of the norms after it and after the FFN
    CROSS, NORM_CROSS, NORM_FFN = "cross_attn", "norm2", "norm3"

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.self_attn = DenseAttention(d, cfg.nheads, cfg.dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.add_module(self.CROSS, DenseAttention(d, cfg.nheads, cfg.dropout))
        self.add_module(self.NORM_CROSS, nn.LayerNorm(d, eps=1e-5))
        self.linear1 = nn.Linear(d, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, d)
        self.add_module(self.NORM_FFN, nn.LayerNorm(d, eps=1e-5))
        self.dropout1, self.dropout2, self.dropout3, self.dropout4 = (nn.Dropout(cfg.dropout) for _ in range(4))

    def forward(self, tgt, query_pos, memory, pos, mem_valid=None):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.dropout1(self.self_attn(q, q, tgt)))
        ca = self._modules[self.CROSS](tgt + query_pos, memory + pos, memory, mem_valid)
        tgt = self._modules[self.NORM_CROSS](tgt + self.dropout2(ca))
        ff = self.linear2(self.dropout3(F.relu(self.linear1(tgt))))
        return self._modules[self.NORM_FFN](tgt + self.dropout4(ff))


class MDETRDecoderLayer(DecoderLayer):
    """DecoderLayer under the reference ParSeTransformer's names (its MDETR
    layer's text cross-attention slot, norm2, is unused upstream)."""

    CROSS, NORM_CROSS, NORM_FFN = "cross_attn_image", "norm3", "norm4"


class DenseEncoder(nn.Module):
    """`num_layers` EncoderLayers under `layers.{i}`; returns the last
    output, or with `intermediates` every layer's."""

    def __init__(self, cfg: TransformerConfig, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(num_layers))

    def forward(self, x, pos, key_valid=None, intermediates: bool = False):
        outs = []
        for layer in self.layers:
            x = layer(x, pos, key_valid)
            outs.append(x)
        return outs if intermediates else x


class DenseDecoder(nn.Module):
    """`num_layers` decoder layers under `layers.{i}`, and with `norm` one
    LayerNorm applied to every layer's output (torch DETR's
    TransformerDecoder); returns the per-layer states (layers, B, nq, C)."""

    def __init__(self, cfg: TransformerConfig, num_layers: int, layer=DecoderLayer, norm: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(layer(cfg) for _ in range(num_layers))
        self.norm = nn.LayerNorm(cfg.hidden_dim, eps=1e-5) if norm else None

    def forward(self, tgt, query_pos, memory, pos, mem_valid=None) -> torch.Tensor:
        hs = []
        for layer in self.layers:
            tgt = layer(tgt, query_pos, memory, pos, mem_valid)
            hs.append(tgt if self.norm is None else self.norm(tgt))
        return torch.stack(hs)


class FusionEncoder(DenseEncoder):
    def forward(self, queries, text, text_valid):
        """-> (query half, text half) after the layers over [queries ; text]."""
        nq = queries.shape[1]
        x = torch.cat([queries, text], dim=1)
        valid = torch.cat([torch.ones(queries.shape[:2], dtype=torch.bool, device=x.device), text_valid], dim=1)
        x = super().forward(x, torch.zeros_like(x), valid)
        return x[:, :nq], x[:, nq:]


class VanillaALIFEncoder(nn.Module):
    """Returns (visual tokens (B, S, C), language states): stacked to
    (F, B, T, l_dim) when `lang_aux_loss` (every other state when
    `fusion_interval` is 1), else the last (B, T, l_dim)."""

    def __init__(self, cfg: TransformerConfig, text_cfg: TextEncoderConfig):
        super().__init__()
        f = cfg.fusion
        self.fusion = f
        n_fusion = -(-cfg.enc_layers // f.fusion_interval)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.enc_layers))
        self.roberta_layers = nn.ModuleList(RobertaLayer(text_cfg) for _ in range(n_fusion))
        self.VLFuse_layers = nn.ModuleList(
            VLFuse(f, cfg.hidden_dim, text_cfg.hidden_size, 1, cfg.int8_dense) for _ in range(n_fusion))

    def forward(self, src, pos, valid, lang_hidden, lang_valid):
        f = self.fusion
        out, lang = src, lang_hidden
        lang_states = []
        for idx, layer in enumerate(self.layers):
            if idx % f.fusion_interval == 0:
                k = idx // f.fusion_interval
                out, lang = self.VLFuse_layers[k].b_attn(out, lang, pos, lang_valid, valid)
                lang = self.roberta_layers[k](lang, alif_additive_bool_mask(lang_valid, lang.dtype))
                lang_states.append(lang)
            out = layer(out, pos, valid)
        if not f.lang_aux_loss:
            return out, lang_states[-1]
        multi_lang = torch.stack(lang_states)
        return out, (multi_lang[::2] if f.fusion_interval == 1 else multi_lang)


def dense_tokens(feat: torch.Tensor, input_proj: nn.Conv2d, pixel_valid: torch.Tensor) -> tuple:
    """One backbone level (B, C_in, h, w) -> its projected tokens (B, h*w,
    C), their sine positions (B, h*w, C) and validity (B, h*w)."""
    B, (h, w), d = feat.shape[0], feat.shape[-2:], input_proj.out_channels
    mask = downsample_mask(pixel_valid, h, w)
    pos = sine_position_embedding(mask, num_pos_feats=d // 2).reshape(B, h * w, d)
    return input_proj(feat).flatten(2).transpose(1, 2), pos, mask.reshape(B, h * w)


def check_supported(cfg: ModelConfig) -> None:
    """Raise on options the dense models do not have: the subject head and
    `two_stage` (the JAX classes ignore them, and the criterion would find
    no output for the subject head); a ResNet `backbone.use_checkpoint`."""
    check_options(cfg, {"subject_class": cfg.subject_class},
                  f"variant {cfg.variant} has no {{}} (its JAX class ignores them)")


class DenseParSe(nn.Module):
    """What the dense models share: one stride-32 backbone level projected
    to tokens with their sine positions and validity, the open-vocabulary
    heads and the output dict. Its outputs carry no `lang_states` unless a
    subclass says so (LANG_STATES)."""

    LANG_STATES = False

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        d = cfg.transformer.hidden_dim
        backbone = _Backbone(cfg, num_outputs=1)
        self.backbone = nn.ModuleList([backbone])
        self.input_proj = nn.Conv2d(backbone.body.out_channels[-1], d, 1)
        self.sub_bbox_embed = MLP(d, d, 4, 3)
        self.obj_bbox_embed = MLP(d, d, 4, 3)
        self.projection_text = nn.Linear(d, d)
        self.bias_obj_a = nn.Parameter(torch.zeros(d))
        self.bias_pred_a = nn.Parameter(torch.zeros(d))

    def _autocast(self, device: torch.device):
        return torch.autocast(device_type=device.type, dtype=torch.bfloat16, enabled=self.cfg.dtype == "bfloat16")

    def _image_tokens(self, pixels, pixel_valid, generator=None):
        """-> src (B, S, C), pos (B, S, C) float32, valid (B, S) bool over
        the backbone's last level."""
        body = self.backbone[0].body
        x = normalize_pixels(pixels)
        feat = (body(x, generator) if isinstance(body, SwinTransformer) else body(x))[-1]
        return dense_tokens(feat, self.input_proj, pixel_valid)

    def _project_text(self, tm: torch.Tensor) -> torch.Tensor:
        """L2-normalised, halved and projected text states."""
        tm = tm / tm.float().norm(dim=-1, keepdim=True).clamp(min=1e-12).to(tm.dtype)
        return self.projection_text(tm / 2.0)

    def _logits(self, states, bias, text) -> torch.Tensor:
        """einsum of states (+ bias) against texts in float32, as the JAX
        heads' preferred_element_type, plus the prior-prob bias."""
        with torch.autocast(device_type=states.device.type, enabled=False):
            return torch.einsum("bcd,bed->bce", (states + bias).float(), text.float()) + BIAS_C

    def _outputs(self, levels: list) -> dict:
        """levels: per decoder layer (obj logits, verb logits, subject
        states, object states) -> the output dict, aux layers included."""
        def head(ol, vl, hs_h, hs_o):
            return {"pred_obj_logits": ol, "pred_verb_logits": vl,
                    "pred_sub_boxes": torch.sigmoid(self.sub_bbox_embed(hs_h)).float(),
                    "pred_obj_boxes": torch.sigmoid(self.obj_bbox_embed(hs_o)).float()}

        out = head(*levels[-1])
        if self.cfg.aux_loss:
            out["aux_outputs"] = [head(*lv) for lv in levels[:-1]]
        return out


class _ParSeTransformer(nn.Module):
    """Parameter container under `transformer.`."""

    def __init__(self, cfg: ModelConfig, v2: bool):
        super().__init__()
        t = cfg.transformer
        d = t.hidden_dim
        if v2:
            self.encoder = VanillaALIFEncoder(t, cfg.text_encoder)
        else:
            self.encoder = DenseEncoder(t, t.enc_layers)
        self.ho_decoder = DenseDecoder(t, t.dec_layers)
        self.verb_decoder = DenseDecoder(t, t.dec_layers)
        if not v2:
            self.obj_fusion = FusionEncoder(t, 2)
            self.verb_fusion = FusionEncoder(t, 2)
            self.verb_tgt_generator = MultiBranchFusion(d, d, d, 16)
        self.text_encoder = RobertaModel(cfg.text_encoder)
        self.resizer = FeatureResizer(cfg.text_encoder.hidden_size, d, dropout=0.1)


class RLIPParSe(DenseParSe):
    V2 = False

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d = cfg.transformer.hidden_dim
        self.transformer = _ParSeTransformer(cfg, v2=self.V2)
        self.query_embed = nn.Embedding(cfg.num_queries, d)
        if not self.V2:
            self.verb_query_embed = nn.Embedding(cfg.num_queries // 2, d)

    def encode_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Tokenized label texts -> pooled per-label features (N, l_dim)."""
        with self._autocast(input_ids.device):
            return self.transformer.text_encoder(input_ids, attention_mask)[1].float()

    def forward(
        self,
        pixels: torch.Tensor,  # (B, H, W, 3) uint8, or float32 normalized
        pixel_valid: torch.Tensor,  # (B, H, W) bool, True = real pixel
        text_emb: torch.Tensor,  # (B, T, l_dim) pooled label features
        text_valid: torch.Tensor,  # (B, T) bool, True = real label slot
        n_obj_texts: Optional[int] = None,
        generator: Optional[torch.Generator] = None,  # the Swin DropPath masks' (train mode)
    ) -> dict:
        n_obj = self.cfg.max_obj_texts if n_obj_texts is None else n_obj_texts
        with self._autocast(pixels.device):
            return self._forward(pixels, pixel_valid, text_emb, text_valid, n_obj, generator)

    def _decode_ho(self, memory, pos, valid):
        """The ho decoder from zero targets at the learned query positions."""
        B = memory.shape[0]
        qpos = self.query_embed.weight[None].expand(B, *self.query_embed.weight.shape)
        return self.transformer.ho_decoder(torch.zeros_like(qpos), qpos, memory, pos, valid)

    def _forward(self, pixels, pixel_valid, text_emb, text_valid, n_obj, generator):
        tr = self.transformer
        src, pos, valid = self._image_tokens(pixels, pixel_valid, generator)
        memory = tr.encoder(src, pos, valid)
        text = tr.resizer(text_emb)
        hs_ho = self._decode_ho(memory, pos, valid)
        np_ = hs_ho.shape[2] // 2
        B = memory.shape[0]
        vqpos = self.verb_query_embed.weight[None].expand(B, *self.verb_query_embed.weight.shape)
        vt = tr.verb_tgt_generator(hs_ho[-1][:, :np_], hs_ho[-1][:, np_:])
        hs_verb = tr.verb_decoder(vt, vqpos, memory, pos, valid)
        levels = []
        for lvl in range(hs_ho.shape[0]):
            hs_h, hs_o = hs_ho[lvl][:, :np_], hs_ho[lvl][:, np_:]
            fused_o, obj_text = tr.obj_fusion(hs_o, text[:, :n_obj], text_valid[:, :n_obj])
            fused_v, verb_text = tr.verb_fusion(hs_verb[lvl], text[:, n_obj:], text_valid[:, n_obj:])
            levels.append((self._logits(fused_o, self.bias_obj_a, self._project_text(obj_text)),
                           self._logits(fused_v, self.bias_pred_a, self._project_text(verb_text)), hs_h, hs_o))
        return self._outputs(levels)


class RLIPParSeV2(RLIPParSe):
    V2 = True
    LANG_STATES = True

    def _forward(self, pixels, pixel_valid, text_emb, text_valid, n_obj, generator):
        tr = self.transformer
        src, pos, valid = self._image_tokens(pixels, pixel_valid, generator)
        memory, multi_lang = tr.encoder(src, pos, valid, text_emb, text_valid)
        text_dec = text_per_decoder_layer(tr.resizer(multi_lang), self.cfg.transformer.dec_layers)
        hs_ho = self._decode_ho(memory, pos, valid)
        np_ = hs_ho.shape[2] // 2
        # verb queries: zero targets at the sum of the last layer's subject
        # and object states (reference ParSetransformer.py:1487-1489)
        vqpos = hs_ho[-1][:, :np_] + hs_ho[-1][:, np_:]
        hs_verb = tr.verb_decoder(torch.zeros_like(vqpos), vqpos, memory, pos, valid)
        levels = []
        for lvl in range(hs_ho.shape[0]):
            proj = self._project_text(text_dec[lvl])
            hs_h, hs_o = hs_ho[lvl][:, :np_], hs_ho[lvl][:, np_:]
            levels.append((self._logits(hs_o, self.bias_obj_a, proj[:, :n_obj]),
                           self._logits(hs_verb[lvl], self.bias_pred_a, proj[:, n_obj:]), hs_h, hs_o))
        out = self._outputs(levels)
        out["verb_decoder_out"] = hs_verb[-1].float()
        out["lang_states"] = (multi_lang if multi_lang.ndim == 3 else multi_lang[-1]).float()
        return out
