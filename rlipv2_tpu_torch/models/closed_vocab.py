"""The closed-vocabulary HOI zoo (counterpart of
rlipv2_tpu/models/closed_vocab.py): the fixed-class baselines that the RLIP
papers compare against. Each takes `forward(pixels, pixel_valid)` and no
text: Linear heads give `max_obj_texts` object columns (the classes, then
no-object LAST) and `max_verb_texts` verb columns, in the repo-wide output
dict, with `dec_layers - 1` aux layers under `cfg.aux_loss`.

Dense DETR (one stride-32 level, `models/parse.py`'s EncoderLayer and
DecoderLayer; attention through SDPA):
  * QPICModel (`qpic`) — one decoder whose states feed every head;
  * CDNModel (`cdn`) — a verb decoder whose query positions are the ho
    decoder's last states (the cascade);
  * SepDETRHOIModel (`sep_detr_hoi`) — paired (subject, object) queries,
    a verb decoder over the MBF fusion of each pair's last states;
  * OCNModel (`ocn`) — QPIC plus the verb-semantic graph over word
    embeddings, the object-verb prior at the argmax object class, the
    cross-modal calibration and `count_fusion` before the verb head;
  * SeqDETRHOIModel (`seq_detr_hoi`) — chained human, object and verb
    decoders;
  * StochasticDETRHOIModel (`stochastic_detr_hoi`) — `SAMPLING_NUM`
    reparameterized draws through the verb head, and `verb_kl_divergence`;
  * IterativeDETRHOIModel (`iterative_detr_hoi`) — QPIC plus the raw 4-d
    `ref_points` of a linear over the query embeddings;
  * DETRHOIhmModel (`detr_hoi_hm`) — a heatmap branch over the encoder
    memory (3x3 conv, offsets, the nine-tap deformable 3x3 conv in stock
    ops) whose top locations seed the query positions; `verb_hm` for
    `SetCriterionHOI.loss_verb_hm`;
  * CoupledDETRHOIModel (`coupled_detr_hoi`) — after each decoder layer
    the prior row of its argmax object class gathers the verb semantics,
    gated back into the query stream.
Multi-scale deformable (three ResNet levels and one stride-2 level, the
GroupNorm input projections, `models/deformable.py::DeformableEncoder`):
  * QAHOIModel (`qahoi`) — the plain deformable decoder on 2-d reference
    points;
  * QAHOITwoStageModel (`qahoi_two_stage`) — encoder proposals scored by
    `enc_class`, the top-k (ties to the lower index, as `lax.top_k`) as the
    decoder's 4-d reference boxes; `enc_outputs` for the two-stage loss;
  * SepDDETRHOIv3Model (`sep_ddetr_hoi_v3`) — the plain ParSe ho decoder
    with subject and object reference heads, and an MBF verb decoder;
  * ParSeDABDDETRModel (`parse_dab_ddetr`) — the DAB ho decoder with box
    refinement and the DAB verb decoder without it (`models/dab_decoder.py`).
`cfg.dtype == "bfloat16"` runs the forward under bf16 autocast.

Parameter names: the reference's where the port's blocks fix them, the JAX
names elsewhere, under `transformer.` for what the reference's transformer
holds (`engine/convert.py::closed_vocab_state_dict` maps the flax trees):
  backbone.0.body.*, input_proj (1x1 Conv2d, or the deformable
  models' `input_proj.{i}.{0,1}`)        <- backbone, input_proj[_{i}], input_norm_{i}
  transformer.encoder.layers.{i}        <- enc_{i} (dense), encoder/layers (deformable, scanned)
  transformer.{decoder,obj_decoder,verb_decoder}.layers.{i}
                                        <- dec_{i}, obj_dec_{i}, verb_dec_{i}
  transformer.{decoder,ho_decoder,verb_decoder,ho_decoder_dab,verb_decoder_dab}.*
                                        <- the same names (deformable, scanned)
  transformer.{level_embed, reference_points[_sub,_obj], verb_tgt_generator, enc_output[_norm],
  enc_class, enc_bbox, pos_trans[_norm], hm_*, semantic_*, verb_norm, dec_norm,
  verb_word_embedding, obj_verb_co}     <- the same names (Coupled's priors)
  query_embed, verb_query_embed, tgt_embed, verb_tgt_embed, refpoint_embed (nn.Embedding),
  obj_class_embed, verb_class_embed, sub_bbox_embed, obj_bbox_embed, verb_mbf, latent_mu,
  latent_log_var, and OCN's semantic_graph, cross_att, vision_intra, semantic_intra,
  fusion_{1,2}, verb_word_embedding, obj_verb_co
                                        <- the same names
The OCN and Coupled word-embedding tables and co-occurrence priors are
buffers: the JAX classes hold them as params under stop_gradient. As in the
JAX trees, `query_embed` of ParSe-DAB-DDETR and QAHOI two-stage exists and
goes unused; the decoders that ParSe-DAB-DDETR's JAX `setup` declares and
never calls are not built.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from rlipv2_tpu_torch.config import ModelConfig, TransformerConfig
from rlipv2_tpu_torch.models.dab_decoder import DABHOIDecoder
from rlipv2_tpu_torch.models.deformable import DeformableEncoder
from rlipv2_tpu_torch.models.layers import MLP, MultiBranchFusion, normalize_pixels
from rlipv2_tpu_torch.models.parse import DenseDecoder, DenseEncoder, dense_tokens
from rlipv2_tpu_torch.models.parseda import _Backbone, check_options, downsample_mask, input_projections, \
    multi_level_tokens
from rlipv2_tpu_torch.ops.positional import gen_sineembed_for_position


def check_supported(cfg: ModelConfig, two_stage: bool = False) -> None:
    """Raise on options the zoo's JAX classes ignore or cannot take: the
    subject head, `two_stage` on any class but QAHOI two-stage (which runs
    two-stage whatever the option says, as its JAX class), a Swin backbone
    (the JAX classes build a ResNet of `backbone.name`), and a ResNet
    `backbone.use_checkpoint`."""
    check_options(dataclasses.replace(cfg, two_stage=False) if two_stage else cfg, {
        "subject_class": cfg.subject_class,
        f"backbone {cfg.backbone.name!r} (the JAX zoo builds a ResNet)": not cfg.backbone.name.startswith("resnet"),
    }, f"variant {cfg.variant}: no {{}} (its JAX class has none)")


def top_k_lower_index_first(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest of x's last axis, equal values in index
    order, as `jax.lax.top_k` gives them (`torch.topk` promises no order
    among ties)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


class _ClosedVocabBase(nn.Module):
    """The ResNet and the Linear and MLP heads that the zoo shares; the
    class counts `num_obj_classes` (+ no-object) and `num_verb_classes` as
    max_obj_texts - 1 and max_verb_texts, as the JAX base does."""

    NUM_LEVELS = 1  # ResNet stages the model reads
    BOX_HEADS = True  # the top-level box MLPs (ParSe-DAB-DDETR's boxes come from its decoder)
    TWO_STAGE = False

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg, self.TWO_STAGE)
        self.cfg = cfg
        d = cfg.transformer.hidden_dim
        self.n_obj, self.n_verb = cfg.max_obj_texts - 1, cfg.max_verb_texts
        self.backbone = nn.ModuleList([_Backbone(cfg, num_outputs=self.NUM_LEVELS)])
        self.obj_class_embed = nn.Linear(d, self.n_obj + 1)
        self.verb_class_embed = nn.Linear(d, self.n_verb)
        if self.BOX_HEADS:
            self.sub_bbox_embed = MLP(d, d, 4, 3)
            self.obj_bbox_embed = MLP(d, d, 4, 3)

    def forward(self, pixels: torch.Tensor, pixel_valid: torch.Tensor, **kw) -> dict:
        """pixels (B, H, W, 3) uint8 or normalized float32; pixel_valid
        (B, H, W) bool, True = real pixel."""
        with torch.autocast(device_type=pixels.device.type, dtype=torch.bfloat16,
                            enabled=self.cfg.dtype == "bfloat16"):
            return self._forward(pixels, pixel_valid, **kw)

    def _features(self, pixels) -> list:
        return self.backbone[0].body(normalize_pixels(pixels))

    def outputs(self, obj_logits, verb_logits, sub_boxes, obj_boxes, **extra) -> dict:
        """Per-layer stacks (layers, B, nq, ...) -> the last layer's dict
        and, with `cfg.aux_loss`, the others' as `aux_outputs`; each of
        `extra` (per-layer stacks) joins every layer's dict."""
        def layer(lvl):
            return {"pred_obj_logits": obj_logits[lvl], "pred_verb_logits": verb_logits[lvl],
                    "pred_sub_boxes": sub_boxes[lvl], "pred_obj_boxes": obj_boxes[lvl],
                    **{k: v[lvl] for k, v in extra.items()}}

        out = layer(-1)
        if self.cfg.aux_loss:
            out["aux_outputs"] = [layer(lvl) for lvl in range(obj_logits.shape[0] - 1)]
        return out

    def heads(self, hs_sub, hs_obj, hs_verb, **extra) -> dict:
        """The Linear and MLP heads on per-layer states: object class and
        box from the object states, subject box from the subject states,
        verbs from the verb states (QPIC passes one stack thrice)."""
        return self.outputs(self.obj_class_embed(hs_obj).float(), self.verb_class_embed(hs_verb).float(),
                            torch.sigmoid(self.sub_bbox_embed(hs_sub)).float(),
                            torch.sigmoid(self.obj_bbox_embed(hs_obj)).float(), **extra)


# ------------------------------------------------------------------ dense DETR


class _DenseTransformer(nn.Module):
    def __init__(self, t: TransformerConfig, decoders: tuple):
        super().__init__()
        self.encoder = DenseEncoder(t, t.enc_layers)
        for name in decoders:
            self.add_module(name, DenseDecoder(t, t.dec_layers))


class QPICModel(_ClosedVocabBase):
    """QPIC (reference DETRHOI, models/hoi.py:3536-3588; JAX :150-206)."""

    DECODERS = ("decoder",)

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d = cfg.transformer.hidden_dim
        self.input_proj = nn.Conv2d(self.backbone[0].body.out_channels[-1], d, 1)
        self.transformer = _DenseTransformer(cfg.transformer, self.DECODERS)
        self.query_embed = nn.Embedding(cfg.num_queries, d)

    def _encode(self, pixels, pixel_valid):
        """-> memory (B, S, C), pos (B, S, C), valid (B, S) of the last level."""
        src, pos, valid = dense_tokens(self._features(pixels)[-1], self.input_proj, pixel_valid)
        return self.transformer.encoder(src, pos, valid), pos, valid

    def _query_pos(self, B: int) -> torch.Tensor:
        return self.query_embed.weight[None].expand(B, *self.query_embed.weight.shape)

    @staticmethod
    def _decode(decoder, qpos, memory, pos, valid) -> torch.Tensor:
        """A dense decoder from zero targets at `qpos` -> (layers, B, nq, C)."""
        return decoder(torch.zeros_like(qpos), qpos, memory, pos, valid)

    def _forward(self, pixels, pixel_valid):
        memory, pos, valid = self._encode(pixels, pixel_valid)
        hs = self._decode(self.transformer.decoder, self._query_pos(memory.shape[0]), memory, pos, valid)
        return self.heads(hs, hs, hs)


class CDNModel(QPICModel):
    """CDN (reference CDNHOI + the cascade transformer; JAX :208-246)."""

    DECODERS = ("decoder", "verb_decoder")

    def _forward(self, pixels, pixel_valid):
        memory, pos, valid = self._encode(pixels, pixel_valid)
        hs_ho = self._decode(self.transformer.decoder, self._query_pos(memory.shape[0]), memory, pos, valid)
        hs_v = self._decode(self.transformer.verb_decoder, hs_ho[-1], memory, pos, valid)
        return self.heads(hs_ho, hs_ho, hs_v)


class SepDETRHOIModel(QPICModel):
    """SepDETRHOI (reference models/hoi.py:1295-1349; JAX :359-434): the
    first half of the queries subjects, the second objects."""

    DECODERS = ("decoder", "verb_decoder")

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d = cfg.transformer.hidden_dim
        self.verb_query_embed = nn.Embedding(cfg.num_queries // 2, d)
        self.transformer.verb_tgt_generator = MultiBranchFusion(d, d, d, 16)

    def _forward(self, pixels, pixel_valid):
        memory, pos, valid = self._encode(pixels, pixel_valid)
        B, np_ = memory.shape[0], self.cfg.num_queries // 2
        hs_ho = self._decode(self.transformer.decoder, self._query_pos(B), memory, pos, valid)
        vt = self.transformer.verb_tgt_generator(hs_ho[-1][:, :np_], hs_ho[-1][:, np_:])
        vqpos = self.verb_query_embed.weight[None].expand(B, np_, vt.shape[-1])
        hs_verb = self.transformer.verb_decoder(vt, vqpos, memory, pos, valid)
        return self.heads(hs_ho[:, :, :np_], hs_ho[:, :, np_:], hs_verb)


def count_fusion(x, y):
    """Count-sketch style fusion (reference models/hoi.py:299-300)."""
    return F.relu(x + y) - (x - y) * (x - y)


class SemanticGraph(nn.Module):
    """Verb semantics over the word-embedding table, `embedded_dot_pro`
    mode (reference models/hoi.py:302-398; JAX :560-586): single-head
    softmax attention plus, at layer 0, a residual projection."""

    def __init__(self, word_dim: int, hidden_dim: int, num_layers: int = 1):
        super().__init__()
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        for i in range(num_layers):
            n_in = word_dim if i == 0 else hidden_dim
            for name in ("q", "k", "v"):
                self.add_module(f"semantic_{name}_{i}", nn.Linear(n_in, hidden_dim))
        self.semantic_proj_res = nn.Linear(word_dim, hidden_dim)

    def forward(self, x):  # (V, E)
        for i in range(self.num_layers):
            q, k, v = (self._modules[f"semantic_{n}_{i}"](x) for n in ("q", "k", "v"))
            att = torch.softmax((q @ k.T).float() / math.sqrt(self.hidden_dim), dim=-1).to(v.dtype)
            agg = F.relu(att @ v)
            x = agg + (self.semantic_proj_res(x) if i == 0 else x)
        return x


class _BilinearTransformerLayer(nn.Module):
    """Intra-modal layer, `bilinear` relation (reference models/hoi.py:
    467-548; JAX :589-625): per-head bilinear attention over the queries,
    the heads concatenated, a d -> d bottleneck with LayerNorm, residual."""

    def __init__(self, d: int, nheads: int = 2):
        super().__init__()
        self.nheads = nheads
        for i in range(nheads):
            self.add_module(f"bilinear1_{i}", nn.Linear(d, d))
            self.add_module(f"bilinear2_{i}", nn.Linear(d, d))
            self.register_parameter(f"coef_{i}", nn.Parameter(torch.full((d,), 1.0 / math.sqrt(d))))
            self.add_module(f"W3_{i}", nn.Linear(d, d // nheads))
        self.W2 = nn.Linear(d, d)
        self.ln = nn.LayerNorm(d, eps=1e-5)
        self.W1 = nn.Linear(d, d)

    def forward(self, x):  # (..., nq, C)
        heads = []
        for i in range(self.nheads):
            m = self._modules
            b1 = m[f"bilinear1_{i}"](x) * getattr(self, f"coef_{i}")
            att = torch.softmax(torch.einsum("...cd,...ed->...ce", b1, m[f"bilinear2_{i}"](x)).float(), dim=-1)
            emb = m[f"W3_{i}"](x)
            heads.append(torch.einsum("...ce,...ef->...cf", att.to(emb.dtype), emb))
        return x + self.W1(F.relu(self.ln(self.W2(torch.cat(heads, dim=-1)))))


class _MHCrossAttLayer(nn.Module):
    """Inter-modal calibration, `GClike` relation (reference
    models/hoi.py:668-745; JAX :628-669): squeeze-excite gates across the
    vision and semantic streams, each branch with its own weights."""

    TAGS = ("vision", "semantic")

    def __init__(self, d: int, nheads: int = 2):
        super().__init__()
        self.nheads = nheads
        hh = d // nheads
        for tag in self.TAGS:
            for i in range(nheads):
                self.add_module(f"{tag}_sq_{i}", nn.Linear(d, hh))
                self.add_module(f"{tag}_ex_{i}", nn.Linear(hh, hh))
                self.add_module(f"{tag}_W3_{i}", nn.Linear(d, hh))
            self.add_module(f"{tag}_W2", nn.Linear(d, d))
            self.add_module(f"{tag}_ln", nn.LayerNorm(d, eps=1e-5))
            self.add_module(f"{tag}_W1", nn.Linear(d, d))

    def _branch(self, x_self, x_other, tag):
        m = self._modules
        outs = [torch.sigmoid(m[f"{tag}_ex_{i}"](F.relu(m[f"{tag}_sq_{i}"](x_other)))) * m[f"{tag}_W3_{i}"](x_self)
                for i in range(self.nheads)]
        cat = F.relu(m[f"{tag}_ln"](m[f"{tag}_W2"](torch.cat(outs, dim=-1))))
        return x_self + m[f"{tag}_W1"](cat)

    def forward(self, vx, sx):
        return self._branch(vx, sx, "vision"), self._branch(sx, vx, "semantic")


def _word_prior_buffers(module: nn.Module, n_obj: int, n_verb: int, word_dim: int) -> None:
    """The verb word-embedding table and the object-verb co-occurrence
    prior, frozen (the reference's register_buffer; the JAX classes hold
    params under stop_gradient), with the JAX inits."""
    module.register_buffer("verb_word_embedding", torch.randn(n_verb, word_dim))
    module.register_buffer("obj_verb_co", torch.full((n_obj + 1, n_verb), 1.0 / n_verb))


class OCNModel(QPICModel):
    """OCN (reference models/hoi.py:1048-1240; JAX :672-773)."""

    WORD_DIM = 300

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d = cfg.transformer.hidden_dim
        _word_prior_buffers(self, self.n_obj, self.n_verb, self.WORD_DIM)
        self.semantic_graph = SemanticGraph(self.WORD_DIM, d, 1)
        self.cross_att = _MHCrossAttLayer(d, 2)
        self.vision_intra = _BilinearTransformerLayer(d, 2)
        self.semantic_intra = _BilinearTransformerLayer(d, 2)
        self.fusion_1 = nn.Linear(d, d)
        self.fusion_2 = nn.Linear(d, d)

    def _forward(self, pixels, pixel_valid):
        memory, pos, valid = self._encode(pixels, pixel_valid)
        hs = self._decode(self.transformer.decoder, self._query_pos(memory.shape[0]), memory, pos, valid)
        emb = self.verb_word_embedding
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-12)  # the reference's norm_tensor
        semantic = self.semantic_graph(emb)  # (V, C)
        obj_logits = self.obj_class_embed(hs).float()
        # the statistical prior at each query's argmax object class
        co = self.obj_verb_co[obj_logits.argmax(-1)]  # (layers, B, nq, V)
        semantic_aug = torch.einsum("lbqv,vc->lbqc", co.to(semantic.dtype), semantic)
        cross_hs, cross_sem = self.cross_att(hs, semantic_aug)
        hs_aug = count_fusion(self.fusion_1(self.vision_intra(cross_hs)),
                              self.fusion_2(self.semantic_intra(cross_sem)))
        return self.outputs(obj_logits, self.verb_class_embed(hs_aug).float(),
                            torch.sigmoid(self.sub_bbox_embed(hs)).float(),
                            torch.sigmoid(self.obj_bbox_embed(hs)).float())


class SeqDETRHOIModel(QPICModel):
    """SeqDETRHOI (reference models/hoi.py:1242-1294, SeqTransformer; JAX
    :775-840): the object decoder's query positions are the human decoder's
    last states, the verb decoder's the object decoder's."""

    DECODERS = ("decoder", "obj_decoder", "verb_decoder")

    def _forward(self, pixels, pixel_valid):
        memory, pos, valid = self._encode(pixels, pixel_valid)
        tr = self.transformer
        hs_h = self._decode(tr.decoder, self._query_pos(memory.shape[0]), memory, pos, valid)
        hs_o = self._decode(tr.obj_decoder, hs_h[-1], memory, pos, valid)
        hs_v = self._decode(tr.verb_decoder, hs_o[-1], memory, pos, valid)
        return self.heads(hs_h, hs_o, hs_v)


class StochasticDETRHOIModel(QPICModel):
    """VanillaStochasticDETRHOI (reference models/hoi.py:181-300; JAX
    :842-925): SAMPLING_NUM draws of mu + exp(log_var / 2) * eps through
    the verb head, averaged and added to the deterministic verb logits; the
    KL against N(0, 1) per layer as `verb_kl_divergence`."""

    SAMPLING_NUM = 5

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d = cfg.transformer.hidden_dim
        self.latent_mu = nn.Linear(d, d)
        self.latent_log_var = nn.Linear(d, d)

    def _forward(self, pixels, pixel_valid, generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None):
        """The draws `eps` (SAMPLING_NUM, layers, B, nq, C) come from
        `generator`, or without one from a generator seeded 0 on the
        model's device (the JAX class's PRNGKey(0) when it has no rng);
        never from the global random state. `eps` given (a test's shared
        draws) is used as it is."""
        memory, pos, valid = self._encode(pixels, pixel_valid)
        hs = self._decode(self.transformer.decoder, self._query_pos(memory.shape[0]), memory, pos, valid)
        mu, log_var = self.latent_mu(hs), self.latent_log_var(hs)
        if eps is None:
            if generator is None:
                generator = torch.Generator(device=mu.device).manual_seed(0)
            eps = torch.randn((self.SAMPLING_NUM, *mu.shape), generator=generator, device=mu.device,
                              dtype=mu.dtype)
        latent = mu[None] + torch.exp(0.5 * log_var)[None] * eps.to(mu.dtype)
        verb_logits = self.verb_class_embed(latent).float().mean(0) + self.verb_class_embed(hs).float()
        mu32, lv32 = mu.float(), log_var.float()
        kl = -0.5 * (1 + lv32 - mu32**2 - lv32.exp()).mean(dim=(1, 2, 3))  # (layers,)
        return self.outputs(self.obj_class_embed(hs).float(), verb_logits,
                            torch.sigmoid(self.sub_bbox_embed(hs)).float(),
                            torch.sigmoid(self.obj_bbox_embed(hs)).float(), verb_kl_divergence=kl)


class IterativeDETRHOIModel(QPICModel):
    """IterativeTransformer-backed DETRHOI (reference
    models/transformer.py:545-609; JAX :1148-1171): QPIC plus the raw
    linear `ref_points` (B, nq, 4) of the query embeddings, which the
    reference's DETRHOI wrapper never reads."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.transformer.reference_points = nn.Linear(cfg.transformer.hidden_dim, 4)

    def _forward(self, pixels, pixel_valid):
        out = super()._forward(pixels, pixel_valid)
        rp = self.transformer.reference_points(self.query_embed.weight).float()
        out["ref_points"] = rp[None].expand(pixels.shape[0], *rp.shape)
        return out


def bilinear_taps(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """x (B, h, w, C); py, px (B, T, h, w) fractional rows and columns ->
    (B, T, h, w, C) bilinear samples, zero outside the map (torchvision
    DeformConv2d's padding; JAX `_bilinear_sample_2d`, :1173-1196)."""
    B, h, w, C = x.shape
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = (px - x0)[..., None], (py - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = x.reshape(B, h * w, C)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(B, -1, 1).expand(-1, -1, C)
        g = torch.gather(flat, 1, idx).reshape(*yi.shape, C)
        return torch.where(inside[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))

    return (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
            + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)


class DETRHOIhmModel(QPICModel):
    """Transformerhm-backed DETRHOI (reference models/transformer.py:
    611-678; JAX :1199-1289): the encoder memory through `hm_conv` + ReLU,
    `hm_off` (18 offsets: (dy, dx) of each of the nine taps) and the
    deformable 3x3 conv (`hm_deform_kernel` (tap, C_in, C_out) and
    `hm_deform_bias`, here nine bilinear gathers); the sigmoid heatmap of
    `hm_embed`, with padded locations at -1, picks the top num_queries
    locations (ties to the lower index, as `lax.top_k`; a map smaller than
    that tiles them), whose deformed features are the query positions.
    `verb_hm` is (heatmap (B, n_hm, h, w), padding (B, h, w) True = pad)."""

    NUM_HM_CLASSES = 1

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d = cfg.transformer.hidden_dim
        tr = self.transformer
        tr.hm_conv = nn.Conv2d(d, d, 3, padding=1)
        tr.hm_off = nn.Conv2d(d, 18, 3, padding=1)
        tr.hm_embed = nn.Linear(d, self.NUM_HM_CLASSES)
        bound = math.sqrt(1.0 / (3 * d))  # flax's variance_scaling(1, fan_in = 9 d, uniform)
        tr.hm_deform_kernel = nn.Parameter(torch.empty(9, d, d).uniform_(-bound, bound))
        tr.hm_deform_bias = nn.Parameter(torch.zeros(d))

    def _deform_conv3x3(self, x, off):
        """x (B, h, w, C), off (B, h, w, 18) float32 -> (B, h, w, C)."""
        B, h, w, _ = x.shape
        gy, gx = torch.meshgrid(torch.arange(h, device=x.device), torch.arange(w, device=x.device), indexing="ij")
        taps = torch.tensor([(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)], device=x.device)
        py = gy + taps[:, 0, None, None] + off[..., 0::2].permute(0, 3, 1, 2)  # (B, 9, h, w)
        px = gx + taps[:, 1, None, None] + off[..., 1::2].permute(0, 3, 1, 2)
        samples = bilinear_taps(x, py, px)  # (B, 9, h, w, C)
        tr = self.transformer
        return torch.einsum("bthwc,tcd->bhwd", samples, tr.hm_deform_kernel.to(samples.dtype)) + tr.hm_deform_bias

    def _forward(self, pixels, pixel_valid):
        c = self.cfg
        tr = self.transformer
        feat = self._features(pixels)[-1]
        (h, w), pad = feat.shape[-2:], ~downsample_mask(pixel_valid, *feat.shape[-2:])
        src, pos, valid = dense_tokens(feat, self.input_proj, pixel_valid)
        memory = tr.encoder(src, pos, valid)
        B, _, C = memory.shape
        hm_feat = F.relu(tr.hm_conv(memory.transpose(1, 2).reshape(B, C, h, w)))
        off = tr.hm_off(hm_feat).float().permute(0, 2, 3, 1)
        hm_feat = hm_feat.permute(0, 2, 3, 1)  # (B, h, w, C)
        deform_feat = self._deform_conv3x3(hm_feat, off)
        verb_hm = torch.sigmoid(tr.hm_embed(hm_feat).float())  # (B, h, w, n_hm)
        masked_hm = torch.where(valid, verb_hm.amax(-1).reshape(B, h * w), -1.0)
        k = min(c.num_queries, h * w)
        inds = top_k_lower_index_first(masked_hm, k)
        if k < c.num_queries:
            inds = inds.repeat(1, -(-c.num_queries // k))[:, :c.num_queries]
        qpos = torch.gather(deform_feat.reshape(B, h * w, C), 1, inds[..., None].expand(-1, -1, C))
        qpos = qpos.to(memory.dtype)
        hs = self._decode(tr.decoder, qpos, memory, pos, valid)
        out = self.heads(hs, hs, hs)
        out["verb_hm"] = (verb_hm.permute(0, 3, 1, 2), pad)
        return out


class CoupledDETRHOIModel(QPICModel):
    """TransformerCoupled-backed DETRHOI (reference models/transformer.py:
    683-829; JAX :1291-1402): after each decoder layer the normed state's
    argmax object class gathers a prior row, which aggregates the verb
    semantics (attention WITHOUT softmax, reference :780-782); a sigmoid
    gate blends them into the state, which feeds the verb head and the next
    layer. The box heads read each layer's normed state before the blend,
    the last layer's after it (reference :799-800, :820-824)."""

    WORD_DIM = 300

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d = cfg.transformer.hidden_dim
        tr = self.transformer
        _word_prior_buffers(tr, self.n_obj, self.n_verb, self.WORD_DIM)
        for name in ("semantic_q", "semantic_k", "semantic_v", "semantic_proj_res"):
            tr.add_module(name, nn.Linear(self.WORD_DIM, d))
        tr.semantic_gate = nn.Linear(d, d)
        tr.verb_norm = nn.LayerNorm(d, eps=1e-5)
        tr.dec_norm = nn.LayerNorm(d, eps=1e-5)

    def _forward(self, pixels, pixel_valid):
        tr = self.transformer
        memory, pos, valid = self._encode(pixels, pixel_valid)
        qpos = self._query_pos(memory.shape[0])
        emb = tr.verb_word_embedding
        att = torch.einsum("ac,bc->ab", tr.semantic_q(emb), tr.semantic_k(emb))
        semantic = F.relu(att @ tr.semantic_v(emb)) + tr.semantic_proj_res(emb)
        tgt = torch.zeros_like(qpos)
        hs, obj_logits, verb_logits = [], [], []
        for layer in tr.decoder.layers:
            tgt = layer(tgt, qpos, memory, pos, valid)
            normed = tr.dec_norm(tgt)
            obj_logits.append(self.obj_class_embed(normed).float())
            co = tr.obj_verb_co[obj_logits[-1].argmax(-1)]  # (B, nq, V)
            semantic_aug = torch.einsum("bqv,vc->bqc", co.to(semantic.dtype), semantic)
            tgt = torch.sigmoid(tr.semantic_gate(normed)) * semantic_aug + normed
            verb_logits.append(self.verb_class_embed(tr.verb_norm(tgt)).float())
            hs.append(normed)
        hs[-1] = tr.dec_norm(tgt)
        hs = torch.stack(hs)
        return self.outputs(torch.stack(obj_logits), torch.stack(verb_logits),
                            torch.sigmoid(self.sub_bbox_embed(hs)).float(),
                            torch.sigmoid(self.obj_bbox_embed(hs)).float())


# ------------------------------------------------------------------ deformable


class _DeformableTransformer(nn.Module):
    def __init__(self, t: TransformerConfig):
        super().__init__()
        self.level_embed = nn.Parameter(torch.randn(t.num_feature_levels, t.hidden_dim))
        self.encoder = DeformableEncoder(t)


class _DeformableBase(_ClosedVocabBase):
    """Three ResNet levels and the stride-2 ones after them through the
    GroupNorm input projections, the deformable encoder (JAX
    `_deformable_encode`, :105-147)."""

    NUM_LEVELS = 3

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        t = cfg.transformer
        self.input_proj = input_projections(self.backbone[0].body.out_channels, t.hidden_dim,
                                            t.num_feature_levels)
        self.transformer = _DeformableTransformer(t)

    def _encode(self, pixels, pixel_valid):
        """-> (memory (B, S, C), spatial_shapes, valid_ratios, mask_flat)."""
        tr = self.transformer
        src, pos, mask, shapes, ratios = multi_level_tokens(self._features(pixels), self.input_proj,
                                                            tr.level_embed, pixel_valid, self.NUM_LEVELS)
        return tr.encoder(src, shapes, ratios, pos, mask), shapes, ratios, mask

    def _split_query_embed(self, B: int) -> tuple:
        """`query_embed` (nq, 2C) -> (query_pos, tgt), each (B, nq, C)."""
        qe = self.query_embed.weight
        d = qe.shape[1] // 2
        return qe[None, :, :d].expand(B, -1, d), qe[None, :, d:].expand(B, -1, d)


class QAHOIModel(_DeformableBase):
    """QAHOI (reference DDETRHOI, models/hoi.py:2655-2838; JAX :248-357)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        t = cfg.transformer
        self.transformer.decoder = DABHOIDecoder(t, parse=False, use_dab=False)
        self.query_embed = nn.Embedding(cfg.num_queries, 2 * t.hidden_dim)
        self._query_heads(t.hidden_dim)

    def _query_heads(self, d: int) -> None:
        self.transformer.reference_points = nn.Linear(d, 2)

    def _forward(self, pixels, pixel_valid):
        memory, shapes, ratios, mask = self._encode(pixels, pixel_valid)
        qpos, tgt = self._split_query_embed(memory.shape[0])
        ref = torch.sigmoid(self.transformer.reference_points(qpos))  # (B, nq, 2)
        hs = self.transformer.decoder(tgt, ref, ref, memory, shapes, ratios, mask, query_pos=qpos)["hs"]
        return self.heads(hs, hs, hs)


def gen_encoder_output_proposals(memory, valid, spatial_shapes, base_scale: float = 0.05):
    """Two-stage proposals (reference models/deformable_transformer.py:
    106-134; JAX :1026-1063): per level the pixel-centre grid over the
    valid extent with w = h = 0.05 * 2^level, kept where every coordinate
    lies in (0.01, 0.99) and the token is real. Returns (memory zeroed at
    the others, the inverse-sigmoid proposals with +inf there, keep)."""
    B = memory.shape[0]
    proposals, off = [], 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        m = valid[:, off:off + h * w].reshape(B, h, w)
        valid_h = m[:, :, 0].float().sum(1).clamp(min=1.0)
        valid_w = m[:, 0, :].float().sum(1).clamp(min=1.0)
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=memory.device),
                                torch.arange(w, dtype=torch.float32, device=memory.device), indexing="ij")
        grid = torch.stack([gx, gy], -1).reshape(-1, 2)
        ctr = (grid[None] + 0.5) / torch.stack([valid_w, valid_h], -1)[:, None, :]
        proposals.append(torch.cat([ctr, torch.full_like(ctr, base_scale * 2.0**lvl)], dim=-1))
        off += h * w
    prop = torch.cat(proposals, dim=1)  # (B, S, 4)
    keep = ((prop > 0.01) & (prop < 0.99)).all(-1) & valid
    prop = torch.where(keep[..., None], torch.log(prop / (1.0 - prop)), torch.inf)
    return torch.where(keep[..., None], memory, 0.0), prop, keep


class QAHOITwoStageModel(QAHOIModel):
    """QAHOI with two-stage queries (reference models/deformable_transformer.py:
    176-191; JAX :1065-1146): `enc_class` scores the encoder's proposals,
    the top min(two_stage_num_proposals, num_queries) become the decoder's
    4-d reference boxes (held out of the gradient), and their sine
    embeddings through `pos_trans` give (query_pos, tgt). `enc_outputs`
    holds the proposals' logits, boxes (0.5 where a proposal is dropped)
    and `proposal_valid` for the two-stage loss."""

    TWO_STAGE = True

    def _query_heads(self, d: int) -> None:
        tr = self.transformer
        tr.enc_output = nn.Linear(d, d)
        tr.enc_output_norm = nn.LayerNorm(d, eps=1e-5)
        tr.enc_class = nn.Linear(d, self.n_obj + 1)
        tr.enc_bbox = MLP(d, d, 4, 3)
        tr.pos_trans = nn.Linear(2 * d, 2 * d)
        tr.pos_trans_norm = nn.LayerNorm(2 * d, eps=1e-5)

    def _forward(self, pixels, pixel_valid):
        c = self.cfg
        tr = self.transformer
        nq = min(c.two_stage_num_proposals, c.num_queries)
        memory, shapes, ratios, mask = self._encode(pixels, pixel_valid)
        mem0, prop, keep = gen_encoder_output_proposals(memory.float(), mask, shapes)
        out_mem = tr.enc_output_norm(tr.enc_output(mem0.to(memory.dtype)))
        enc_logits = tr.enc_class(out_mem).float()
        enc_coords = tr.enc_bbox(out_mem).float() + prop  # +inf at the dropped proposals
        score = torch.where(keep, enc_logits[..., 0], -torch.inf)
        topk = top_k_lower_index_first(score, nq)
        refs = torch.sigmoid(torch.gather(enc_coords, 1, topk[..., None].expand(-1, -1, 4)).detach())
        pt = tr.pos_trans_norm(tr.pos_trans(gen_sineembed_for_position(refs, dim=c.transformer.hidden_dim // 2)))
        query_pos, tgt = pt.chunk(2, dim=-1)
        # one reference box a query: the midpoint of (refs, refs) is refs
        hs = tr.decoder(tgt, refs, refs, memory, shapes, ratios, mask, query_pos=query_pos)["hs"]
        out = self.heads(hs, hs, hs)
        out["enc_outputs"] = {
            "pred_logits": enc_logits,
            "pred_boxes": torch.sigmoid(torch.where(torch.isfinite(enc_coords), enc_coords, 0.0)),
            "proposal_valid": keep,
        }
        return out


class SepDDETRHOIv3Model(_DeformableBase):
    """SepDDETRHOI v3 (reference models/deformable_transformer.py:29-223;
    JAX :436-553): the plain ParSe ho decoder with separate subject and
    object 2-d reference heads, then the verb decoder over the MBF fusion
    of each pair's last states at the pair's midpoint."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self._decoders(cfg.transformer)

    def _decoders(self, t: TransformerConfig) -> None:
        d = t.hidden_dim
        tr = self.transformer
        tr.ho_decoder = DABHOIDecoder(t, parse=True, use_dab=False)
        tr.verb_decoder = DABHOIDecoder(t, parse=False, use_dab=False)
        self.query_embed = nn.Embedding(self.cfg.num_queries, 2 * d)
        tr.reference_points_sub = nn.Linear(d, 2)
        tr.reference_points_obj = nn.Linear(d, 2)
        tr.verb_tgt_generator = MultiBranchFusion(d, d, d, 16)

    def _forward(self, pixels, pixel_valid):
        tr = self.transformer
        memory, shapes, ratios, mask = self._encode(pixels, pixel_valid)
        np_ = self.cfg.num_queries // 2
        query_pos, tgt = self._split_query_embed(memory.shape[0])
        sub_ref = torch.sigmoid(tr.reference_points_sub(query_pos[:, :np_]))
        obj_ref = torch.sigmoid(tr.reference_points_obj(query_pos[:, np_:]))
        hs_ho = tr.ho_decoder(tgt, sub_ref, obj_ref, memory, shapes, ratios, mask, query_pos=query_pos)["hs"]
        vt = tr.verb_tgt_generator(hs_ho[-1][:, :np_], hs_ho[-1][:, np_:])
        hs_verb = tr.verb_decoder(vt, sub_ref, obj_ref, memory, shapes, ratios, mask,
                                  query_pos=query_pos[:, :np_] + query_pos[:, np_:])["hs"]
        return self.heads(hs_ho[:, :, :np_], hs_ho[:, :, np_:], hs_verb)


class ParSeDABDDETRModel(SepDDETRHOIv3Model):
    """ParSeDABDDETR (reference models/hoi.py:1592-1870; JAX :927-1024):
    content targets and 4-d anchors (subjects, then objects), the DAB ho
    decoder with box refinement, whose boxes are the outputs', and the DAB
    verb decoder at its last anchors, without refinement, over the MBF
    fusion of each pair's last states plus the pair's verb targets."""

    BOX_HEADS = False

    def _decoders(self, t: TransformerConfig) -> None:
        nq, d = self.cfg.num_queries, t.hidden_dim
        self.transformer.ho_decoder_dab = DABHOIDecoder(t, parse=True, use_dab=True, refine_boxes=True)
        self.transformer.verb_decoder_dab = DABHOIDecoder(t, parse=False, use_dab=True, refine_boxes=False)
        self.query_embed = nn.Embedding(nq, 2 * d)  # unused, as in the JAX tree
        self.tgt_embed = nn.Embedding(nq, d)
        self.verb_tgt_embed = nn.Embedding(nq, d)
        self.refpoint_embed = nn.Embedding(nq, 4)
        nn.init.uniform_(self.refpoint_embed.weight)
        self.verb_mbf = MultiBranchFusion(d, d, d, 16)

    def _forward(self, pixels, pixel_valid):
        tr = self.transformer
        memory, shapes, ratios, mask = self._encode(pixels, pixel_valid)
        B, nq = memory.shape[0], self.cfg.num_queries
        np_ = nq // 2
        refs = torch.sigmoid(self.refpoint_embed.weight)
        tgt = self.tgt_embed.weight[None].expand(B, nq, -1)
        ho = tr.ho_decoder_dab(tgt, refs[None, :np_].expand(B, np_, 4), refs[None, np_:].expand(B, np_, 4),
                               memory, shapes, ratios, mask)
        hs_ho = ho["hs"]
        verb_tgt = self.verb_tgt_embed.weight
        vt = self.verb_mbf(hs_ho[-1][:, :np_], hs_ho[-1][:, np_:]) + verb_tgt[None, :np_] + verb_tgt[None, np_:]
        hs_verb = tr.verb_decoder_dab(vt, ho["sub_refs"][-1], ho["obj_refs"][-1], memory, shapes, ratios,
                                      mask)["hs"]
        return self.outputs(self.obj_class_embed(hs_ho[:, :, np_:]).float(), self.verb_class_embed(hs_verb).float(),
                            ho["sub_boxes"].float(), ho["obj_boxes"].float())


def evaluation_columns(out: dict, n_obj_texts: int, n_verb_texts: int) -> dict:
    """A zoo output with the columns of a split of `n_obj_texts` object
    slots (its classes, then no-object) and `n_verb_texts` verbs: object
    columns [0, n_obj_texts - 1) and the model's last (no-object), verb
    columns [0, n_verb_texts); every layer's. The HICO evaluator indexes
    its (verbs, classes) correct matrix by the post-process's labels, so it
    reads these columns only. The same as the JAX `postprocess_hoi` with
    slot masks that are ones on these columns and zeros elsewhere: a masked
    object column's softmax weight is exactly 0 there."""
    def cut(o):
        obj = o["pred_obj_logits"]
        return {**o, "pred_obj_logits": torch.cat([obj[..., :n_obj_texts - 1], obj[..., -1:]], dim=-1),
                "pred_verb_logits": o["pred_verb_logits"][..., :n_verb_texts]}

    res = cut(out)
    if "aux_outputs" in out:
        res["aux_outputs"] = [cut(a) for a in out["aux_outputs"]]
    return res
