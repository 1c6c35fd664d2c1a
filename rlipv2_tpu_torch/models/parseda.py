"""RLIP-ParSeDA, the open-vocabulary relation detector (counterpart of
rlipv2_tpu/models/parseda.py; reference models/hoi.py:1871-2257 and
models/dab_deformable/deformable_transformer.py:234-744).

  * multi-level input projections (1x1 conv + GroupNorm(32), an extra
    stride-2 level);
  * DAB queries: tgt_embed + verb_tgt_embed + 4-d refpoint anchors, split
    into (subject, object) halves;
  * the ALIF encoder over the flattened multi-scale tokens and the label
    texts;
  * the ho decoder, then the verb decoder seeded by vanilla_MBF verb queries;
  * open-vocabulary heads: decoder states (+ a learned bias vector) against
    L2-normalised, halved, projected text states, plus the prior-prob bias.

Parameter names are the reference state-dict keys, registered in the
reference order; the per-layer box heads are one set of modules registered
both at the top (`sub_bbox_embed.{i}`) and inside the decoders, as in the
reference. `cfg.dtype == "bfloat16"` runs the forward under bf16 autocast.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from rlipv2_tpu_torch.config import ModelConfig
from rlipv2_tpu_torch.models.dab_decoder import DABHOIDecoder
from rlipv2_tpu_torch.models.deformable import ALIFEncoder, compute_valid_ratios
from rlipv2_tpu_torch.models.layers import FeatureResizer, MultiBranchFusion, normalize_pixels
from rlipv2_tpu_torch.models.resnet import ResNet
from rlipv2_tpu_torch.models.roberta import RobertaModel
from rlipv2_tpu_torch.models.swin import SwinTransformer
from rlipv2_tpu_torch.ops.ms_deform_attn import IMPLS
from rlipv2_tpu_torch.ops.positional import sine_position_embedding

BIAS_C = -math.log((1 - 0.01) / 0.01)  # prior-prob 0.01 bias


def downsample_mask(valid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W) bool -> (B, h, w) bool by nearest sampling at half-pixel
    centres (what jax.image.resize "nearest" does)."""
    return F.interpolate(valid[:, None].float(), size=(h, w), mode="nearest-exact")[:, 0] > 0.5


def check_supported(cfg: ModelConfig) -> None:
    """The port covers RLIP-ParSeDA with a ResNet or Swin backbone; raise on
    config options it does not implement yet."""
    t = cfg.transformer
    unsupported = {
        "backbone.use_checkpoint": cfg.backbone.use_checkpoint,
        "fusion_type (GLIP_attn only)": t.fusion.fusion_type != "GLIP_attn",
        "use_dab=False": not cfg.use_dab,
        "with_box_refine=False": not cfg.with_box_refine,
        "two_stage": cfg.two_stage,
        "subject_class": cfg.subject_class,
        "verb_curing": cfg.verb_curing,
        "masked_entity_modeling": cfg.masked_entity_modeling,
        "msda_impl 'pallas_zerograd' (a JAX profiling aid)": t.msda_impl == "pallas_zerograd",
    }
    missing = [k for k, bad in unsupported.items() if bad]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
    if t.msda_impl not in IMPLS:
        raise ValueError(f"unknown msda_impl {t.msda_impl!r}; known: {IMPLS}")


class _Backbone(nn.Module):
    """Holds the reference's `backbone.0.body` name."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        b = cfg.backbone
        if b.name.startswith("resnet"):
            self.body = ResNet(b.name, b.num_outputs)
        else:
            self.body = SwinTransformer.from_name(b.name, b.drop_path_rate, b.int8_dense)


class _Transformer(nn.Module):
    """Parameter container under the reference's `transformer.` prefix."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        t = cfg.transformer
        self.level_embed = nn.Parameter(torch.zeros(t.num_feature_levels, t.hidden_dim))
        self.ho_decoder = DABHOIDecoder(t, parse=True)
        self.verb_decoder = DABHOIDecoder(t, parse=False)
        if "MBF" in t.verb_query_tgt_type:
            self.verb_tgt_generator = MultiBranchFusion(t.hidden_dim, t.hidden_dim, t.hidden_dim, 16)
        self.encoder = ALIFEncoder(t, cfg.text_encoder)
        self.text_encoder = RobertaModel(cfg.text_encoder)
        self.resizer = FeatureResizer(cfg.text_encoder.hidden_size, t.hidden_dim, dropout=0.1)


class RLIPParSeDA(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        t = cfg.transformer
        d = t.hidden_dim
        self.bias_obj_a = nn.Parameter(torch.zeros(d))
        self.bias_pred_a = nn.Parameter(torch.zeros(d))
        self.transformer = _Transformer(cfg)
        tr = self.transformer
        # one module per box head, registered here and in the decoders
        self.sub_bbox_embed = nn.ModuleList([*tr.ho_decoder.sub_bbox_embed, *tr.verb_decoder.sub_bbox_embed])
        self.obj_bbox_embed = nn.ModuleList([*tr.ho_decoder.obj_bbox_embed, *tr.verb_decoder.obj_bbox_embed])
        self.projection_text = nn.Linear(d, d)
        self.tgt_embed = nn.Embedding(cfg.num_queries, d)
        self.verb_tgt_embed = nn.Embedding(cfg.num_queries, d)
        self.refpoint_embed = nn.Embedding(cfg.num_queries, 4)
        backbone = _Backbone(cfg)
        in_channels = backbone.body.out_channels
        n_out = len(in_channels)
        projs = []
        for i in range(t.num_feature_levels):
            if i < n_out:
                conv = nn.Conv2d(in_channels[i], d, 1)
            else:
                conv = nn.Conv2d(in_channels[-1] if i == n_out else d, d, 3, stride=2, padding=1)
            projs.append(nn.Sequential(conv, nn.GroupNorm(32, d, eps=1e-5)))
        self.input_proj = nn.ModuleList(projs)
        self.backbone = nn.ModuleList([backbone])

    def encode_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Tokenized label texts -> pooled per-label features (N, l_dim)."""
        with self._autocast(input_ids.device):
            return self.transformer.text_encoder(input_ids, attention_mask)[1].float()

    def _autocast(self, device: torch.device):
        return torch.autocast(
            device_type=device.type, dtype=torch.bfloat16, enabled=self.cfg.dtype == "bfloat16"
        )

    def _encode(self, pixels, pixel_valid, text_emb, text_valid) -> dict:
        """backbone -> input projections -> ALIF encoder -> per-decoder-layer
        text memories."""
        c = self.cfg
        t = c.transformer
        B = pixels.shape[0]
        tr = self.transformer
        feats = self.backbone[0].body(normalize_pixels(pixels))

        srcs, masks, pos_flat = [], [], []
        for i, proj in enumerate(self.input_proj):
            if i < c.backbone.num_outputs:
                src = proj(feats[i])
            elif i == c.backbone.num_outputs:
                src = proj(feats[-1])
            else:
                src = proj(srcs[-1])
            h, w = src.shape[-2:]
            mask = downsample_mask(pixel_valid, h, w)
            pos = sine_position_embedding(mask, num_pos_feats=t.hidden_dim // 2)
            srcs.append(src)
            masks.append(mask)
            pos_flat.append((pos + tr.level_embed[i]).reshape(B, h * w, t.hidden_dim))

        spatial_shapes = tuple(tuple(s.shape[-2:]) for s in srcs)
        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], dim=1)
        mask_flat = torch.cat([m.reshape(B, -1) for m in masks], dim=1)
        pos_flat = torch.cat(pos_flat, dim=1)
        valid_ratios = compute_valid_ratios(masks)

        img_memory, multi_lang = tr.encoder(
            src_flat, spatial_shapes, valid_ratios, pos_flat, mask_flat, text_emb, text_valid
        )
        text_resized = tr.resizer(multi_lang)  # ([F,] B, T, C)
        if text_resized.ndim == 3:
            text_dec = text_resized[None].expand(t.dec_layers, *text_resized.shape)
        else:
            # the preset has one fused state per decoder layer (enc 6 /
            # interval 2 = dec 3); otherwise repeat or drop the last ones
            text_dec = text_resized
            F_ = text_dec.shape[0]
            if F_ < t.dec_layers:
                pad = text_dec[-1:].expand(t.dec_layers - F_, *text_dec.shape[1:])
                text_dec = torch.cat([text_dec, pad], dim=0)
            elif F_ > t.dec_layers:
                text_dec = text_dec[-t.dec_layers :]
        return {
            "img_memory": img_memory,
            "spatial_shapes": spatial_shapes,
            "valid_ratios": valid_ratios,
            "mask_flat": mask_flat,
            "text_dec": text_dec,
            "lang_states": multi_lang if multi_lang.ndim == 3 else multi_lang[-1],
        }

    def forward(
        self,
        pixels: torch.Tensor,  # (B, H, W, 3) uint8, or float32 normalized
        pixel_valid: torch.Tensor,  # (B, H, W) bool, True = real pixel
        text_emb: torch.Tensor,  # (B, T, l_dim) pooled label features
        text_valid: torch.Tensor,  # (B, T) bool, True = real label slot
        n_obj_texts: Optional[int] = None,
    ) -> dict:
        with self._autocast(pixels.device):
            return self._forward(pixels, pixel_valid, text_emb, text_valid, n_obj_texts)

    def _forward(self, pixels, pixel_valid, text_emb, text_valid, n_obj_texts):
        c = self.cfg
        t = c.transformer
        tr = self.transformer
        B = pixels.shape[0]
        n_obj = c.max_obj_texts if n_obj_texts is None else n_obj_texts
        enc = self._encode(pixels, pixel_valid, text_emb, text_valid)
        memory = (enc["img_memory"], enc["spatial_shapes"], enc["valid_ratios"], enc["mask_flat"])

        np_ = c.num_queries // 2
        refs = torch.sigmoid(self.refpoint_embed.weight)
        sub_ref = refs[None, :np_].expand(B, np_, 4)
        obj_ref = refs[None, np_:].expand(B, np_, 4)
        tgt = self.tgt_embed.weight[None].expand(B, c.num_queries, t.hidden_dim)
        ho = tr.ho_decoder(tgt, sub_ref, obj_ref, *memory)
        hs_ho = ho["hs"]  # (layers, B, nq, C)

        verb_tgt = self.verb_tgt_embed.weight
        hs_last = hs_ho[-1]
        vanilla = (verb_tgt[None, :np_] + verb_tgt[None, np_:]).expand(B, np_, t.hidden_dim)
        if t.verb_query_tgt_type == "vanilla":
            verb_query = vanilla
        elif t.verb_query_tgt_type == "MBF":
            verb_query = tr.verb_tgt_generator(hs_last[:, :np_], hs_last[:, np_:])
        elif t.verb_query_tgt_type == "vanilla_MBF":
            verb_query = tr.verb_tgt_generator(hs_last[:, :np_], hs_last[:, np_:]) + vanilla
        else:
            raise ValueError(t.verb_query_tgt_type)
        verb = tr.verb_decoder(verb_query, ho["sub_refs"][-1], ho["obj_refs"][-1], *memory)
        hs_verb = verb["hs"]  # (layers, B, np, C)

        obj_logits, verb_logits = [], []
        for lvl in range(t.dec_layers):
            tm = enc["text_dec"][lvl]
            tm = tm / tm.float().norm(dim=-1, keepdim=True).clamp(min=1e-12).to(tm.dtype)
            proj = self.projection_text(tm / 2.0)  # (B, T, C)
            # float32 products, as the JAX heads' preferred_element_type
            with torch.autocast(device_type=pixels.device.type, enabled=False):
                obj_logits.append(torch.einsum(
                    "bcd,bed->bce", (hs_ho[lvl, :, np_:] + self.bias_obj_a).float(),
                    proj[:, :n_obj].float()) + BIAS_C)
                verb_logits.append(torch.einsum(
                    "bcd,bed->bce", (hs_verb[lvl] + self.bias_pred_a).float(),
                    proj[:, n_obj:].float()) + BIAS_C)
        sub_boxes = ho["sub_boxes"].float()
        obj_boxes = ho["obj_boxes"].float()

        def head(lvl):
            return {
                "pred_obj_logits": obj_logits[lvl],
                "pred_verb_logits": verb_logits[lvl],
                "pred_sub_boxes": sub_boxes[lvl],
                "pred_obj_boxes": obj_boxes[lvl],
            }

        out = head(-1)
        out["verb_decoder_out"] = hs_verb[-1].float()
        out["lang_states"] = enc["lang_states"].float()
        if c.aux_loss:
            out["aux_outputs"] = [head(lvl) for lvl in range(t.dec_layers - 1)]
        return out
