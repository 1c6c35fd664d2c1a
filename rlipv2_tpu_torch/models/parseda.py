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

Memory options, each honoured where gradients are taken: the Swin
backbone's `backbone.use_checkpoint` (its blocks rematerialized,
`models/swin.py`; the JAX RLIPParSeDA does not pass it to its Swin, ROADMAP
queue 3), the encoder's `transformer.remat_encoder` with
`remat_save_names`, and `fusion.use_checkpoint_fusion`
(`models/deformable.py`). In train mode the Swin backbone's DropPath draws
its masks from the `generator` given to `forward`.

`fusion_type` "no_fusion" builds the plain deformable encoder
(`models/deformable.py::DeformableEncoder`) in place of the ALIF one, and
the language states are then the text features themselves (JAX :158-161,
:273-287): RLIP-ParSeD v1 (`rlip_parsed`, `models/factory.py`). The JAX
class builds the plain encoder for any type other than GLIP_attn, so its
"MDETR_attn" runs with no fusion at all (ROADMAP queue 3); here
MDETR_attn raises.

With `cfg.subject_class` a subject head scores the subject half of the ho
decoder's states against the object texts with `bias_obj_a` (JAX :497,
:526, :606), as `pred_sub_logits`. `RLIPParSeDA(cfg, tagger=True)` adds the
R-Tagger's `transformer.coord_proj` (JAX `coord_proj`, reference
models/ParSetransformer.py:507-518) for `forward_tagger`.

Two training options add heads under the JAX parameter names (JAX
:185-203, :530-612):
  * `verb_curing`: `sub_curing` and `obj_curing` (Linear C -> 1) score the
    last ho-decoder layer's subject and object states; the product of their
    sigmoids, (B, np, 1), is `curing_score`, shared by every aux layer. The
    criterion multiplies the verb scores by it, and so does evaluation
    (`eval/postprocess.py`);
  * `masked_entity_modeling`: cross-reconstruction at every decoder layer.
    `recon_linear` (Linear 2C -> C) makes subject states from the (object,
    verb) states and object states from the (subject, verb) ones; the MLPs
    `recon_sub_bbox` / `recon_obj_bbox` add their boxes to the layer's
    detached anchor in logit space (`sub_refs[lvl]`, as the JAX scan's
    per-layer anchor), and the object texts classify both. The layer's
    dict is `recon_stat`, in the outputs and in each aux layer's. The JAX
    recon boxes use these MLPs and not the decoder's box heads, so a
    reference checkpoint trained with masked-entity modeling does not load
    (ROADMAP queue 3).
RLIP-ParSeD and the dense models never call such heads in their JAX
classes: they have no HEAD_PREFIXES, and the factory raises ValueError
on both options for them (`models/factory.py::check_heads`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from rlipv2_tpu_torch.config import ModelConfig
from rlipv2_tpu_torch.models.dab_decoder import DABHOIDecoder
from rlipv2_tpu_torch.models.deformable import SAVE_NAMES, ALIFEncoder, DeformableEncoder, compute_valid_ratios
from rlipv2_tpu_torch.models.layers import MLP, FeatureResizer, GroupNorm, MultiBranchFusion, normalize_pixels
from rlipv2_tpu_torch.models.resnet import ResNet
from rlipv2_tpu_torch.models.roberta import RobertaModel
from rlipv2_tpu_torch.models.swin import SwinTransformer
from rlipv2_tpu_torch.models.tagger import prepare_tagger_queries, tagger_box_queries
from rlipv2_tpu_torch.ops.ms_deform_attn import IMPLS
from rlipv2_tpu_torch.ops.positional import inverse_sigmoid, sine_position_embedding
from rlipv2_tpu_torch.structures import HOITargets

BIAS_C = -math.log((1 - 0.01) / 0.01)  # prior-prob 0.01 bias


def downsample_mask(valid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W) bool -> (B, h, w) bool by nearest sampling at half-pixel
    centres (what jax.image.resize "nearest" does)."""
    return F.interpolate(valid[:, None].float(), size=(h, w), mode="nearest-exact")[:, 0] > 0.5


FUSION_TYPES = ("GLIP_attn", "no_fusion")


def check_options(cfg: ModelConfig, unsupported: dict, message: str) -> None:
    """What every ported model checks: raise NotImplementedError with
    `message` formatted with the names of the options of `unsupported` that
    are set, `two_stage` (no ported model has it) among them; ValueError
    on a ResNet `backbone.use_checkpoint`."""
    unsupported = {**unsupported, "two_stage": cfg.two_stage}
    missing = [k for k, bad in unsupported.items() if bad]
    if missing:
        raise NotImplementedError(message.format(", ".join(missing)))
    if cfg.backbone.use_checkpoint and cfg.backbone.name.startswith("resnet"):
        raise ValueError("backbone.use_checkpoint rematerializes Swin blocks; a ResNet backbone has none")


def check_supported(cfg: ModelConfig, dab: bool = True) -> None:
    """The port covers RLIP-ParSeDA and RLIP-ParSeD v1 and v2 (`dab`
    False: decoders that ignore `use_dab` and `with_box_refine`, as the JAX
    class's do) with a ResNet or Swin backbone, with the ALIF or the plain
    encoder; raise on config options it does not implement yet."""
    t = cfg.transformer
    check_options(cfg, {
        f"fusion_type {t.fusion.fusion_type!r} (ported: {', '.join(FUSION_TYPES)})":
            t.fusion.fusion_type not in FUSION_TYPES,
        "use_dab=False": dab and not cfg.use_dab,
        "with_box_refine=False": dab and not cfg.with_box_refine,
        # the JAX RLIPParSeD builds its verb queries as vanilla_MBF whatever the option says
        "RLIP-ParSeD with verb_query_tgt_type other than vanilla_MBF":
            not dab and t.verb_query_tgt_type != "vanilla_MBF",
        "msda_impl 'pallas_zerograd' (a JAX profiling aid)": t.msda_impl == "pallas_zerograd",
    }, "not ported yet: {} (ROADMAP queue 1 item 7)")
    if t.msda_impl not in IMPLS:
        raise ValueError(f"unknown msda_impl {t.msda_impl!r}; known: {IMPLS}")
    unknown = set(t.remat_save_names) - set(SAVE_NAMES)
    if unknown:
        raise ValueError(f"remat_save_names {sorted(unknown)} name no tag of the encoder; known: {SAVE_NAMES}")


def text_per_decoder_layer(text_resized: torch.Tensor, dec_layers: int) -> torch.Tensor:
    """The resized language states ([F,] B, T, C) -> one per decoder layer
    (dec_layers, B, T, C): a single state repeated; F fused states as they
    are where F == dec_layers (the preset: enc 6 / interval 2 = dec 3),
    else the last repeated or the first dropped."""
    if text_resized.ndim == 3:
        return text_resized[None].expand(dec_layers, *text_resized.shape)
    F_ = text_resized.shape[0]
    if F_ < dec_layers:
        pad = text_resized[-1:].expand(dec_layers - F_, *text_resized.shape[1:])
        return torch.cat([text_resized, pad], dim=0)
    return text_resized[-dec_layers:]


class _Backbone(nn.Module):
    """Holds the reference's `backbone.0.body` name; `num_outputs` (default
    the config's) is the ResNet's count of returned stages."""

    def __init__(self, cfg: ModelConfig, num_outputs: Optional[int] = None):
        super().__init__()
        b = cfg.backbone
        if b.name.startswith("resnet"):
            self.body = ResNet(b.name, num_outputs or b.num_outputs)
        else:
            self.body = SwinTransformer.from_name(b.name, b.drop_path_rate, b.int8_dense, b.use_checkpoint)


class _Transformer(nn.Module):
    """Parameter container under the reference's `transformer.` prefix;
    `dab` builds the DAB decoders."""

    def __init__(self, cfg: ModelConfig, dab: bool = True):
        super().__init__()
        t = cfg.transformer
        self.level_embed = nn.Parameter(torch.zeros(t.num_feature_levels, t.hidden_dim))
        if dab:
            self.ho_decoder = DABHOIDecoder(t, parse=True)
            self.verb_decoder = DABHOIDecoder(t, parse=False)
        if "MBF" in t.verb_query_tgt_type:
            self.verb_tgt_generator = MultiBranchFusion(t.hidden_dim, t.hidden_dim, t.hidden_dim, 16)
        if t.fusion.fusion_type == "GLIP_attn":
            self.encoder = ALIFEncoder(t, cfg.text_encoder)
        else:
            self.encoder = DeformableEncoder(t)
        self.text_encoder = RobertaModel(cfg.text_encoder)
        self.resizer = FeatureResizer(cfg.text_encoder.hidden_size, t.hidden_dim, dropout=0.1)


class RLIPParSeDA(nn.Module):
    # the parameters only the R-Tagger has (tagger=True)
    TAGGER_PREFIXES = ("transformer.coord_proj.",)
    # the verb-curing and masked-entity heads (cfg.verb_curing,
    # cfg.masked_entity_modeling), which a pre-trained file may lack
    HEAD_PREFIXES = ("sub_curing.", "obj_curing.", "recon_linear.", "recon_sub_bbox.", "recon_obj_bbox.")
    # whether its relation decoders are the DAB ones (RLIP-ParSeD's are
    # plain, and it holds the DAB ones only for the tagger)
    DAB = True

    def __init__(self, cfg: ModelConfig, tagger: bool = False):
        super().__init__()
        check_supported(cfg, self.DAB)
        self.cfg = cfg
        self.tagger = tagger
        t = cfg.transformer
        d = t.hidden_dim
        self.bias_obj_a = nn.Parameter(torch.zeros(d))
        self.bias_pred_a = nn.Parameter(torch.zeros(d))
        self.transformer = _Transformer(cfg, dab=self.DAB or tagger)
        self._box_heads()
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
            projs.append(nn.Sequential(conv, GroupNorm(32, d, eps=1e-5)))
        self.input_proj = nn.ModuleList(projs)
        self.backbone = nn.ModuleList([backbone])
        if tagger:
            self.transformer.coord_proj = nn.Linear(4, d)  # a box (in logits) -> a query
        if cfg.verb_curing:
            self.sub_curing = nn.Linear(d, 1)
            self.obj_curing = nn.Linear(d, 1)
        if cfg.masked_entity_modeling:
            self.recon_linear = nn.Linear(2 * d, d)
            self.recon_sub_bbox = MLP(d, d, 4, 3)
            self.recon_obj_bbox = MLP(d, d, 4, 3)

    def _box_heads(self) -> None:
        """One module per box head, registered here and in the decoders."""
        tr = self.transformer
        self.sub_bbox_embed = nn.ModuleList([*tr.ho_decoder.sub_bbox_embed, *tr.verb_decoder.sub_bbox_embed])
        self.obj_bbox_embed = nn.ModuleList([*tr.ho_decoder.obj_bbox_embed, *tr.verb_decoder.obj_bbox_embed])

    def encode_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Tokenized label texts -> pooled per-label features (N, l_dim)."""
        with self._autocast(input_ids.device):
            return self.transformer.text_encoder(input_ids, attention_mask)[1].float()

    def _autocast(self, device: torch.device):
        return torch.autocast(
            device_type=device.type, dtype=torch.bfloat16, enabled=self.cfg.dtype == "bfloat16"
        )

    def _encode(self, pixels, pixel_valid, text_emb, text_valid, generator=None) -> dict:
        """backbone -> input projections -> ALIF encoder -> per-decoder-layer
        text memories."""
        c = self.cfg
        t = c.transformer
        B = pixels.shape[0]
        tr = self.transformer
        body = self.backbone[0].body
        x = normalize_pixels(pixels)
        feats = body(x, generator) if isinstance(body, SwinTransformer) else body(x)

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

        if isinstance(tr.encoder, ALIFEncoder):
            img_memory, multi_lang = tr.encoder(
                src_flat, spatial_shapes, valid_ratios, pos_flat, mask_flat, text_emb, text_valid
            )
        else:  # no_fusion: the language states are the text features
            img_memory = tr.encoder(src_flat, spatial_shapes, valid_ratios, pos_flat, mask_flat)
            multi_lang = text_emb
        text_resized = tr.resizer(multi_lang)  # ([F,] B, T, C)
        text_dec = text_per_decoder_layer(text_resized, t.dec_layers)
        return {
            "img_memory": img_memory,
            "spatial_shapes": spatial_shapes,
            "valid_ratios": valid_ratios,
            "mask_flat": mask_flat,
            "text_dec": text_dec,
            "text_resized_last": text_resized if text_resized.ndim == 3 else text_resized[-1],
            "lang_states": multi_lang if multi_lang.ndim == 3 else multi_lang[-1],
        }

    def forward(
        self,
        pixels: torch.Tensor,  # (B, H, W, 3) uint8, or float32 normalized
        pixel_valid: torch.Tensor,  # (B, H, W) bool, True = real pixel
        text_emb: torch.Tensor,  # (B, T, l_dim) pooled label features
        text_valid: torch.Tensor,  # (B, T) bool, True = real label slot
        n_obj_texts: Optional[int] = None,
        generator: Optional[torch.Generator] = None,  # the Swin DropPath masks' (train mode)
    ) -> dict:
        with self._autocast(pixels.device):
            return self._forward(pixels, pixel_valid, text_emb, text_valid, n_obj_texts, generator)

    def _forward(self, pixels, pixel_valid, text_emb, text_valid, n_obj_texts, generator):
        c = self.cfg
        t = c.transformer
        B = pixels.shape[0]
        n_obj = c.max_obj_texts if n_obj_texts is None else n_obj_texts
        enc = self._encode(pixels, pixel_valid, text_emb, text_valid, generator)
        np_ = c.num_queries // 2
        refs = torch.sigmoid(self.refpoint_embed.weight)
        sub_ref = refs[None, :np_].expand(B, np_, 4)
        obj_ref = refs[None, np_:].expand(B, np_, 4)
        tgt = self.tgt_embed.weight[None].expand(B, c.num_queries, t.hidden_dim)
        return self._decode_and_classify(enc, tgt, sub_ref, obj_ref, n_obj)

    def forward_tagger(
        self,
        pixels: torch.Tensor,
        pixel_valid: torch.Tensor,
        text_emb: torch.Tensor,
        text_valid: torch.Tensor,
        targets: HOITargets,  # M = num_queries // 2 pair slots
        n_obj_texts: Optional[int],
        box_noise_scale: float,  # 0 at inference (the JAX training=False)
        label_noise_scale: float,
        generator: Optional[torch.Generator] = None,  # the box and label noise's, and the Swin DropPath masks'
    ) -> dict:
        """R-Tagger forward (JAX :357-409): the GT (sub, obj) pairs become
        noised queries, the noised boxes the 4-d anchors of the DAB
        decoders and the query content the label text feature plus
        `coord_proj(inverse_sigmoid(box))`. Outputs are slot-aligned with
        `targets`, plus `tagger_slot_valid` (B, M). On RLIP-ParSeD the
        tagger runs the DAB decoders too, as the JAX package does (the
        reference's tagger runs its own decoders: ROADMAP queue 3)."""
        if not self.tagger:
            raise ValueError("forward_tagger needs a model built with tagger=True (its coord_proj)")
        with self._autocast(pixels.device):
            c = self.cfg
            n_obj = c.max_obj_texts if n_obj_texts is None else n_obj_texts
            enc = self._encode(pixels, pixel_valid, text_emb, text_valid, generator)
            label_embeds = enc["text_resized_last"][:, :n_obj]
            sub_ref, obj_ref, sub_lq, obj_lq, slot_valid = prepare_tagger_queries(
                label_embeds, targets, generator, box_noise_scale, label_noise_scale)
            sub_bq, obj_bq = tagger_box_queries(self.transformer.coord_proj, sub_ref, obj_ref)
            tgt = torch.cat([sub_lq + sub_bq, obj_lq + obj_bq], dim=1)
            out = self._decode_and_classify(enc, tgt, sub_ref, obj_ref, n_obj)
        out["tagger_slot_valid"] = slot_valid
        return out

    def _verb_queries(self, hs_last: torch.Tensor) -> torch.Tensor:
        """The verb decoder's queries from the ho decoder's last states
        (vanilla, MBF or vanilla_MBF)."""
        t = self.cfg.transformer
        B, nq, C = hs_last.shape
        np_ = nq // 2
        verb_tgt = self.verb_tgt_embed.weight
        vanilla = (verb_tgt[None, :np_] + verb_tgt[None, np_:]).expand(B, np_, C)
        if t.verb_query_tgt_type == "vanilla":
            return vanilla
        merged = self.transformer.verb_tgt_generator(hs_last[:, :np_], hs_last[:, np_:])
        if t.verb_query_tgt_type == "MBF":
            return merged
        if t.verb_query_tgt_type == "vanilla_MBF":
            return merged + vanilla
        raise ValueError(t.verb_query_tgt_type)

    def _decode_and_classify(self, enc, tgt, sub_ref, obj_ref, n_obj) -> dict:
        """The DAB decoders from (tgt, 4-d anchors), then the heads (JAX :411)."""
        tr = self.transformer
        memory = (enc["img_memory"], enc["spatial_shapes"], enc["valid_ratios"], enc["mask_flat"])
        np_ = sub_ref.shape[1]
        ho = tr.ho_decoder(tgt, sub_ref, obj_ref, *memory)
        hs_ho = ho["hs"]  # (layers, B, nq, C)
        verb = tr.verb_decoder(self._verb_queries(hs_ho[-1]), ho["sub_refs"][-1], ho["obj_refs"][-1], *memory)
        return self._heads(enc, hs_ho[:, :, :np_], hs_ho[:, :, np_:], verb["hs"], ho["sub_boxes"],
                           ho["obj_boxes"], n_obj, (ho["sub_refs"], ho["obj_refs"]))

    def _text_logits(self, states, text, bias) -> torch.Tensor:
        """(states + bias) against the projected texts, a float32 product as
        the JAX heads' preferred_element_type, plus the prior bias."""
        with torch.autocast(device_type=states.device.type, enabled=False):
            return torch.einsum("bcd,bed->bce", (states + bias).float(), text.float()) + BIAS_C

    def _heads(self, enc, hs_h, hs_o, hs_verb, sub_boxes, obj_boxes, n_obj, refs=None) -> dict:
        """Open-vocabulary classification of every decoder layer's states
        and the output dict, aux layers included. hs_h, hs_o (layers, B, np,
        C) the subject and object halves of the ho decoder's states, hs_verb
        the verb decoder's; boxes (layers, B, np, 4); `refs` the DAB
        decoder's detached anchors (sub_refs, obj_refs) of each layer, which
        the recon boxes start from."""
        c = self.cfg
        obj_texts, obj_logits, verb_logits, sub_logits = [], [], [], []
        for lvl in range(c.transformer.dec_layers):
            tm = enc["text_dec"][lvl]
            tm = tm / tm.float().norm(dim=-1, keepdim=True).clamp(min=1e-12).to(tm.dtype)
            proj = self.projection_text(tm / 2.0)  # (B, T, C)
            obj_texts.append(proj[:, :n_obj])
            obj_logits.append(self._text_logits(hs_o[lvl], obj_texts[lvl], self.bias_obj_a))
            verb_logits.append(self._text_logits(hs_verb[lvl], proj[:, n_obj:], self.bias_pred_a))
            if c.subject_class:
                sub_logits.append(self._text_logits(hs_h[lvl], obj_texts[lvl], self.bias_obj_a))
        sub_boxes = sub_boxes.float()
        obj_boxes = obj_boxes.float()
        curing = None
        if c.verb_curing:  # the last layer's pair quality, shared by the aux layers (JAX :530-538)
            curing = (torch.sigmoid(self.sub_curing(hs_h[-1]).float())
                      * torch.sigmoid(self.obj_curing(hs_o[-1]).float()))  # (B, np, 1)

        def head(lvl):
            out = {
                "pred_obj_logits": obj_logits[lvl],
                "pred_verb_logits": verb_logits[lvl],
                "pred_sub_boxes": sub_boxes[lvl],
                "pred_obj_boxes": obj_boxes[lvl],
            }
            if c.subject_class:
                out["pred_sub_logits"] = sub_logits[lvl]
            if curing is not None:
                out["curing_score"] = curing
            if c.masked_entity_modeling:
                out["recon_stat"] = self._recon(hs_h[lvl], hs_o[lvl], hs_verb[lvl], refs[0][lvl], refs[1][lvl],
                                                obj_texts[lvl])
            return out

        out = head(-1)
        out["verb_decoder_out"] = hs_verb[-1].float()
        out["lang_states"] = enc["lang_states"].float()
        if c.aux_loss:
            out["aux_outputs"] = [head(lvl) for lvl in range(c.transformer.dec_layers - 1)]
        return out

    def _recon(self, hs_h, hs_o, hs_verb, sub_ref, obj_ref, obj_text) -> dict:
        """One decoder layer's masked-entity cross-reconstruction (JAX
        :541-593): subject states from the (object, verb) states and object
        states from the (subject, verb) ones, their boxes refined from the
        layer's detached anchors, both classified against the object texts."""
        h_rec = self.recon_linear(torch.cat([hs_o, hs_verb], dim=-1))
        o_rec = self.recon_linear(torch.cat([hs_h, hs_verb], dim=-1))
        return {
            "pred_sub_logits": self._text_logits(h_rec, obj_text, self.bias_obj_a),
            "pred_obj_logits": self._text_logits(o_rec, obj_text, self.bias_obj_a),
            "pred_sub_boxes": torch.sigmoid(self.recon_sub_bbox(h_rec).float() + inverse_sigmoid(sub_ref.float())),
            "pred_obj_boxes": torch.sigmoid(self.recon_obj_bbox(o_rec).float() + inverse_sigmoid(obj_ref.float())),
        }
