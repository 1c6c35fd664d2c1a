"""JAX -> torch weight conversion: the inverse of
rlipv2_tpu/engine/convert.py::convert_rlip_parseda.

`state_dict_from_jax(params, cfg)` turns a flax param tree of the model
`cfg.variant` names (RLIPParSeDA, RLIPParSeD with the ALIF or, as
RLIP-ParSeD v1, the plain encoder, RLIPParSe, RLIPParSeV2,
RLIPParSeV1Joint or a closed-vocabulary model of `models/closed_vocab.py`,
its priors into buffers) into a state dict in the reference key space (for the
port's own designs the names their modules give: `models/parsed.py`,
`models/parse.py`, `models/mdetr.py`), which loads into the port's model
of that class with `load_state_dict(strict=True)`. A tree
with the R-Tagger's leaves (`init_model_params(..., include_tagger=True)`:
`coord_proj`, and on RLIPParSeD the DAB decoders) loads into the model
built with `tagger=True`. It
  * un-stacks the scanned trees (`group_alif_blocks`,
    `group_dab_decoder_layers`, the scanned RoBERTa `layers`, the plain
    deformable encoder's `layers`);
  * un-folds FrozenAffine into the four FrozenBN buffers:
    weight = scale * sqrt(1 + eps), bias, running_mean = 0, running_var = 1;
  * transposes Dense/Conv kernels (the dense models' `input_proj` Dense
    becomes a 1x1 convolution) and unpacks the flax MultiHeadDotProduct
    projections into `in_proj_weight` / `out_proj`;
  * un-permutes the Swin PatchMerging blocks (`swin`);
  * writes each per-layer box head under both of its reference names, the
    top-level `sub_bbox_embed.{i}` (ho heads first, then verb heads) and
    `transformer.{ho,verb}_decoder.sub_bbox_embed.{i}`;
  * maps RLIP-ParSeDA's verb-curing (`sub_curing`, `obj_curing`) and
    masked-entity heads (`recon_linear`, the MLPs `recon_sub_bbox` and
    `recon_obj_bbox`) to the same names.

The per-module functions take a flax subtree and a key prefix, so a single
module converts the same way as the whole model. Input arrays may be jax or
numpy; outputs are float32 numpy arrays.

A reference checkpoint needs no conversion, because the port's names are
the reference's: `load_reference_checkpoint` (the counterpart of
`convert_rlip_parseda`, rlipv2_tpu/engine/convert.py:321) loads its `model`
entry strictly after `filter_query_embeddings` fits the query embeddings to
the model's `num_queries`; the dense models' embeddings, which the JAX
filter does not know, must have the model's shapes.
"""

from __future__ import annotations

import argparse
import re
from typing import Mapping

import numpy as np

FROZEN_BN_EPS = 1e-5


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _unstack(tree, i: int):
    """Slice index i of the leading (scan) axis of every leaf."""
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def linear(p, prefix: str) -> dict:
    return {f"{prefix}.weight": _np(p["kernel"]).T.copy(), f"{prefix}.bias": _np(p["bias"])}


def layernorm(p, prefix: str) -> dict:
    return {f"{prefix}.weight": _np(p["scale"]), f"{prefix}.bias": _np(p["bias"])}


def conv(p, prefix: str) -> dict:
    """flax (kh, kw, I, O) -> torch (O, I, kh, kw), bias if present."""
    out = {f"{prefix}.weight": _np(p["kernel"]).transpose(3, 2, 0, 1).copy()}
    if "bias" in p:
        out[f"{prefix}.bias"] = _np(p["bias"])
    return out


def frozen_bn(p, prefix: str) -> dict:
    scale = np.asarray(p["scale"], np.float64)
    return {
        f"{prefix}.weight": (scale * np.sqrt(1.0 + FROZEN_BN_EPS)).astype(np.float32),
        f"{prefix}.bias": _np(p["bias"]),
        f"{prefix}.running_mean": np.zeros(scale.shape, np.float32),
        f"{prefix}.running_var": np.ones(scale.shape, np.float32),
    }


def mlp(p, prefix: str) -> dict:
    out = {}
    i = 0
    while f"layers_{i}" in p:
        out.update(linear(p[f"layers_{i}"], f"{prefix}.layers.{i}"))
        i += 1
    return out


def resnet(p, blocks, prefix: str) -> dict:
    out = {**conv(p["conv1"], f"{prefix}conv1"), **frozen_bn(p["bn1"], f"{prefix}bn1")}
    for stage, n in enumerate(blocks):
        for b in range(n):
            blk = p[f"layer{stage + 1}_block{b}"]
            q = f"{prefix}layer{stage + 1}.{b}"
            for j in (1, 2, 3):
                out.update(conv(blk[f"conv{j}"], f"{q}.conv{j}"))
                out.update(frozen_bn(blk[f"bn{j}"], f"{q}.bn{j}"))
            if "downsample_conv" in blk:
                out.update(conv(blk["downsample_conv"], f"{q}.downsample.0"))
                out.update(frozen_bn(blk["downsample_bn"], f"{q}.downsample.1"))
    return out


def swin(p, spec, prefix: str) -> dict:
    """flax SwinTransformer params -> the reference keys (the inverse of
    `convert_swin`). The JAX PatchMerging concatenates the 2x2 block as
    [r0c0, r0c1, r1c0, r1c1] and the reference as [r0c0, r1c0, r0c1, r1c1],
    so the reduction's input blocks and the norm's params are permuted by
    perm4, which is its own inverse."""
    perm4 = [0, 2, 1, 3]
    out = {**conv(p["patch_embed"], f"{prefix}patch_embed.proj"),
           **layernorm(p["patch_norm"], f"{prefix}patch_embed.norm")}
    for s, depth in enumerate(spec.depths):
        dim = spec.embed_dim * 2**s
        for b in range(depth):
            blk = p[f"stage{s}_block{b}"]
            q = f"{prefix}layers.{s}.blocks.{b}"
            out.update({
                **layernorm(blk["norm1"], f"{q}.norm1"),
                f"{q}.attn.relative_position_bias_table": _np(blk["attn"]["relative_position_bias_table"]),
                **linear(blk["attn"]["qkv"], f"{q}.attn.qkv"),
                **linear(blk["attn"]["proj"], f"{q}.attn.proj"),
                **layernorm(blk["norm2"], f"{q}.norm2"),
                **linear(blk["mlp_fc1"], f"{q}.mlp.fc1"),
                **linear(blk["mlp_fc2"], f"{q}.mlp.fc2"),
            })
        if f"merge{s}" in p:
            m = p[f"merge{s}"]
            w = _np(m["reduction"]["kernel"]).T.reshape(2 * dim, 4, dim)[:, perm4]
            q = f"{prefix}layers.{s}.downsample"
            out[f"{q}.reduction.weight"] = w.reshape(2 * dim, 4 * dim).copy()
            for k, name in (("scale", "weight"), ("bias", "bias")):
                out[f"{q}.norm.{name}"] = _np(m["norm"][k]).reshape(4, dim)[perm4].reshape(-1).copy()
    for s in (1, 2, 3):
        out.update(layernorm(p[f"out_norm{s}"], f"{prefix}norm{s}"))
    return out


def roberta_layer(p, prefix: str) -> dict:
    return {
        **linear(p["attention_self"]["query"], f"{prefix}.attention.self.query"),
        **linear(p["attention_self"]["key"], f"{prefix}.attention.self.key"),
        **linear(p["attention_self"]["value"], f"{prefix}.attention.self.value"),
        **linear(p["attention_output_dense"], f"{prefix}.attention.output.dense"),
        **layernorm(p["attention_output_ln"], f"{prefix}.attention.output.LayerNorm"),
        **linear(p["intermediate_dense"], f"{prefix}.intermediate.dense"),
        **linear(p["output_dense"], f"{prefix}.output.dense"),
        **layernorm(p["output_ln"], f"{prefix}.output.LayerNorm"),
    }


def roberta_model(p, num_layers: int, prefix: str = "") -> dict:
    e = p["embeddings"]
    out = {
        f"{prefix}embeddings.word_embeddings.weight": _np(e["word_embeddings"]["embedding"]),
        f"{prefix}embeddings.position_embeddings.weight": _np(e["position_embeddings"]["embedding"]),
        f"{prefix}embeddings.token_type_embeddings.weight": _np(e["token_type_embeddings"]["embedding"]),
        **layernorm(e["ln"], f"{prefix}embeddings.LayerNorm"),
    }
    for i in range(num_layers):
        out.update(roberta_layer(_unstack(p["layers"], i), f"{prefix}encoder.layer.{i}"))
    if "pooler_dense" in p:
        out.update(linear(p["pooler_dense"], f"{prefix}pooler.dense"))
    return out


def msda(p, prefix: str) -> dict:
    return {
        **linear(p["sampling_offsets"], f"{prefix}.sampling_offsets"),
        **linear(p["attention_weights"], f"{prefix}.attention_weights"),
        **linear(p["value_proj"], f"{prefix}.value_proj"),
        **linear(p["output_proj"], f"{prefix}.output_proj"),
    }


def bi_attention_block(p, prefix: str) -> dict:
    out = {
        f"{prefix}.gamma_v": _np(p["gamma_v"]),
        f"{prefix}.gamma_l": _np(p["gamma_l"]),
        **layernorm(p["layer_norm_v"], f"{prefix}.layer_norm_v"),
        **layernorm(p["layer_norm_l"], f"{prefix}.layer_norm_l"),
    }
    for name in ("v_proj", "l_proj", "values_v_proj", "values_l_proj", "out_v_proj", "out_l_proj"):
        out.update(linear(p["attn"][name], f"{prefix}.attn.{name}"))
    return out


def encoder_layer(p, prefix: str) -> dict:
    return {
        **msda(p["self_attn"], f"{prefix}.self_attn"),
        **layernorm(p["norm1"], f"{prefix}.norm1"),
        **linear(p["linear1"], f"{prefix}.linear1"),
        **linear(p["linear2"], f"{prefix}.linear2"),
        **layernorm(p["norm2"], f"{prefix}.norm2"),
    }


def alif_encoder(p, enc_layers: int, fusion_interval: int, prefix: str = "") -> dict:
    """Scanned `blocks` tree (leading axis = fusion block) -> the reference
    `layers.{i}`, `roberta_layers.{f}`, `VLFuse_layers.{f}.b_attn` keys."""
    out = {}
    for f in range(enc_layers // fusion_interval):
        blk = _unstack(p["blocks"], f)
        out.update(bi_attention_block(blk["vl_fuse"], f"{prefix}VLFuse_layers.{f}.b_attn"))
        out.update(roberta_layer(blk["lang_layer"], f"{prefix}roberta_layers.{f}"))
        for j in range(fusion_interval):
            out.update(encoder_layer(blk[f"layer_{j}"], f"{prefix}layers.{f * fusion_interval + j}"))
    return out


def mha(p, prefix: str) -> dict:
    """flax MultiHeadDotProductAttention -> torch nn.MultiheadAttention."""
    def w(name):
        k = _np(p[name]["kernel"])  # (d, heads, hd)
        return k.reshape(k.shape[0], -1).T, _np(p[name]["bias"]).reshape(-1)

    (wq, bq), (wk, bk), (wv, bv) = w("query"), w("key"), w("value")
    ko = _np(p["out"]["kernel"])  # (heads, hd, d)
    return {
        f"{prefix}.in_proj_weight": np.concatenate([wq, wk, wv], axis=0),
        f"{prefix}.in_proj_bias": np.concatenate([bq, bk, bv]),
        f"{prefix}.out_proj.weight": ko.reshape(-1, ko.shape[-1]).T.copy(),
        f"{prefix}.out_proj.bias": _np(p["out"]["bias"]),
    }


def dense_encoder_layer(p, prefix: str) -> dict:
    """`models/parse.py::EncoderLayer`."""
    return {
        **mha(p["self_attn"], f"{prefix}.self_attn"),
        **layernorm(p["norm1"], f"{prefix}.norm1"),
        **linear(p["linear1"], f"{prefix}.linear1"),
        **linear(p["linear2"], f"{prefix}.linear2"),
        **layernorm(p["norm2"], f"{prefix}.norm2"),
    }


def dense_decoder_layer(p, prefix: str, names=("cross_attn", "norm2", "norm3")) -> dict:
    """`models/parse.py::DecoderLayer`; `names` are the port's for the JAX
    cross_attn, norm2 and norm3 (MDETRDecoderLayer's: cross_attn_image,
    norm3, norm4)."""
    cross, norm_cross, norm_ffn = names
    return {
        **mha(p["self_attn"], f"{prefix}.self_attn"),
        **layernorm(p["norm1"], f"{prefix}.norm1"),
        **mha(p["cross_attn"], f"{prefix}.{cross}"),
        **layernorm(p["norm2"], f"{prefix}.{norm_cross}"),
        **linear(p["linear1"], f"{prefix}.linear1"),
        **linear(p["linear2"], f"{prefix}.linear2"),
        **layernorm(p["norm3"], f"{prefix}.{norm_ffn}"),
    }


def vanilla_alif_encoder(p, enc_layers: int, fusion_interval: int, prefix: str = "") -> dict:
    """`models/parse.py::VanillaALIFEncoder`: `vl_fuse_{f}`, `lang_layer_{f}`
    and `layer_{i}` -> `VLFuse_layers.{f}.b_attn`, `roberta_layers.{f}`,
    `layers.{i}`."""
    out = {}
    for f in range(-(-enc_layers // fusion_interval)):
        out.update(bi_attention_block(p[f"vl_fuse_{f}"], f"{prefix}VLFuse_layers.{f}.b_attn"))
        out.update(roberta_layer(p[f"lang_layer_{f}"], f"{prefix}roberta_layers.{f}"))
    for i in range(enc_layers):
        out.update(dense_encoder_layer(p[f"layer_{i}"], f"{prefix}layers.{i}"))
    return out


def decoder_layer(p, prefix: str) -> dict:
    return {
        **msda(p["cross_attn"], f"{prefix}.cross_attn"),
        **layernorm(p["norm1"], f"{prefix}.norm1"),
        **mha(p["self_attn"], f"{prefix}.self_attn"),
        **layernorm(p["norm2"], f"{prefix}.norm2"),
        **linear(p["linear1"], f"{prefix}.linear1"),
        **linear(p["linear2"], f"{prefix}.linear2"),
        **layernorm(p["norm3"], f"{prefix}.norm3"),
    }


def dab_decoder(p, dec_layers: int, prefix: str = "", head_prefix: str | None = None,
                head_offset: int = 0) -> dict:
    """Scanned DAB decoder tree -> reference keys. The box heads, where the
    decoder refines its boxes, go under `{prefix}sub_bbox_embed.{i}` and,
    when `head_prefix` is given, also under
    `{head_prefix}sub_bbox_embed.{head_offset + i}`."""
    out = {}
    for i in range(dec_layers):
        step = _unstack(p["layers"], i)
        out.update(decoder_layer(step["layer"], f"{prefix}layers.{i}"))
        for name in ("sub_bbox_embed", "obj_bbox_embed"):
            if name not in step:  # a decoder without box refinement
                continue
            out.update(mlp(step[name], f"{prefix}{name}.{i}"))
            if head_prefix is not None:
                out.update(mlp(step[name], f"{head_prefix}{name}.{head_offset + i}"))
    out.update(mlp(p["query_scale"], f"{prefix}query_scale"))
    out.update(mlp(p["ref_point_head"], f"{prefix}ref_point_head"))
    return out


def multi_branch_fusion(p, prefix: str) -> dict:
    out = {}
    for name, w, b in (("fc_1", "w1", "b1"), ("fc_2", "w2", "b2"), ("fc_3", "w3", "b3")):
        ws, bs = _np(p[w]), _np(p[b])
        for k in range(ws.shape[0]):
            out[f"{prefix}.{name}.{k}.weight"] = ws[k].T.copy()
            out[f"{prefix}.{name}.{k}.bias"] = bs[k]
    return out


def backbone(p, cfg, prefix: str = "backbone.0.body.") -> dict:
    """The ResNet or Swin of `cfg.backbone.name`."""
    from rlipv2_tpu_torch.models.resnet import STAGE_BLOCKS
    from rlipv2_tpu_torch.models.swin import SWIN_SPECS

    name = cfg.backbone.name
    if name.startswith("resnet"):
        return resnet(p, STAGE_BLOCKS[name], prefix)
    return swin(p, SWIN_SPECS[name], prefix)


def dense_input_proj(p, prefix: str) -> dict:
    """A flax Dense over channels -> the 1x1 Conv2d `prefix`."""
    return {f"{prefix}.weight": _np(p["kernel"]).T[:, :, None, None].copy(), f"{prefix}.bias": _np(p["bias"])}


def dense_state_dict(p, cfg) -> dict[str, np.ndarray]:
    """Flax RLIPParSe, RLIPParSeV2, RLIPParSeV1Joint or RLIPMDETR params ->
    state dict for the port's model of that class. The MDETR-named decoder
    layers are V1Joint's (told by its decoders' final norms) and RLIPMDETR's
    (`cfg.variant` rlip_mdetr, whose tree otherwise reads as RLIPParSe's);
    the other parts go by content: RLIPParSeV2's one `encoder`, the
    `verb_query_embed` and MBF of RLIPParSe and RLIPMDETR, RLIPParSe's
    fusion encoders, the text encoder where the tree has one."""
    t = cfg.transformer
    sd = {
        "bias_obj_a": _np(p["bias_obj_a"]),
        "bias_pred_a": _np(p["bias_pred_a"]),
        **linear(p["projection_text"], "projection_text"),
        "query_embed.weight": _np(p["query_embed"]),
        **mlp(p["sub_bbox_embed"], "sub_bbox_embed"),
        **mlp(p["obj_bbox_embed"], "obj_bbox_embed"),
        **dense_input_proj(p["input_proj"], "input_proj"),
        **linear(p["resizer"]["fc"], "transformer.resizer.fc"),
        **layernorm(p["resizer"]["layer_norm"], "transformer.resizer.layer_norm"),
    }
    mdetr_names = "ho_decoder_norm" in p or cfg.variant == "rlip_mdetr"
    names = ("cross_attn_image", "norm3", "norm4") if mdetr_names else ("cross_attn", "norm2", "norm3")
    for side in ("ho", "verb"):
        for i in range(t.dec_layers):
            sd.update(dense_decoder_layer(p[f"{side}_dec_{i}"], f"transformer.{side}_decoder.layers.{i}", names))
        if f"{side}_decoder_norm" in p:
            sd.update(layernorm(p[f"{side}_decoder_norm"], f"transformer.{side}_decoder.norm"))
    if "encoder" in p:
        sd.update(vanilla_alif_encoder(p["encoder"], t.enc_layers, t.fusion.fusion_interval, "transformer.encoder."))
    else:
        for i in range(t.enc_layers):
            sd.update(dense_encoder_layer(p[f"enc_{i}"], f"transformer.encoder.layers.{i}"))
    if "verb_query_embed" in p:
        sd["verb_query_embed.weight"] = _np(p["verb_query_embed"])
        sd.update(multi_branch_fusion(p["verb_tgt_generator"], "transformer.verb_tgt_generator"))
    for side in ("obj", "verb"):
        if f"{side}_fusion" in p:
            for i in range(2):
                sd.update(dense_encoder_layer(p[f"{side}_fusion"][f"layer_{i}"],
                                              f"transformer.{side}_fusion.layers.{i}"))
    if "text_encoder" in p:
        sd.update(roberta_model(p["text_encoder"], cfg.text_encoder.num_layers, "transformer.text_encoder."))
    sd.update(backbone(p["ResNet_0" if "ResNet_0" in p else "backbone"], cfg))
    return sd


def dab_detr_state_dict(p, cfg) -> dict[str, np.ndarray]:
    """Flax ParSeDABDETR params -> the state dict of the port's class
    (`models/dab_detr.py`)."""
    t = cfg.transformer
    sd = {"refpoint_embed.weight": _np(p["refpoint_embed"]), **dense_input_proj(p["input_proj"], "input_proj"),
          **linear(p["verb_refpoint"], "transformer.verb_refpoint"), **backbone(p["ResNet_0"], cfg)}
    for name in ("obj_class_embed", "verb_class_embed", "sub_bbox_embed", "obj_bbox_embed"):
        sd.update(named_leaves(p[name], name))
    for name in ("ref_point_head", "query_scale", "ref_anchor_head"):
        if name in p:  # query_scale from the second layer on
            sd.update(mlp(p[name], f"transformer.decoder.{name}"))
    for i in range(t.enc_layers):
        sd.update(dense_encoder_layer(p[f"enc_{i}"], f"transformer.encoder.layers.{i}"))
    for i in range(t.dec_layers):
        # ConditionalDecoderLayer: each Dense and LayerNorm under its own name
        sd.update(named_leaves(p[f"dec_{i}"], f"transformer.decoder.layers.{i}"))
        sd.update(dense_decoder_layer(p[f"verb_dec_{i}"], f"transformer.verb_decoder.layers.{i}"))
    return sd


def detector_state_dict_from_jax(params) -> dict[str, np.ndarray]:
    """Flax `DETRDetector` params (with or without the outer "params" key)
    -> the state dict of the port's `models/detection.py::DETRDetector`,
    reference DETR's keys; the ResNet's blocks are read from the tree."""
    p = params["params"] if "params" in params else params
    sd = {"query_embed.weight": _np(p["query_embed"]), **linear(p["class_embed"], "class_embed"),
          **mlp(p["bbox_embed"], "bbox_embed"), **dense_input_proj(p["input_proj"], "input_proj")}
    for k, v in p.items():
        layer = re.fullmatch(r"(enc|dec)_(\d+)", k)
        if layer and layer[1] == "enc":
            sd.update(dense_encoder_layer(v, f"transformer.encoder.layers.{layer[2]}"))
        elif layer:
            sd.update(dense_decoder_layer(v, f"transformer.decoder.layers.{layer[2]}",
                                          ("multihead_attn", "norm2", "norm3")))
    res = p["ResNet_0"]
    blocks = tuple(sum(k.startswith(f"layer{s}_block") for k in res) for s in (1, 2, 3, 4))
    sd.update(resnet(res, blocks, "backbone.0.body."))
    return sd


def named_leaves(p, prefix: str) -> dict:
    """A flax subtree whose torch names are its own: a Dense (a Conv, by its
    4-D kernel), a LayerNorm, an MLP, an array, or a module of these, each
    under `prefix`.`name`."""
    if not isinstance(p, Mapping):
        return {prefix: _np(p)}
    if "kernel" in p:
        return conv(p, prefix) if np.ndim(p["kernel"]) == 4 else linear(p, prefix)
    if "scale" in p:
        return layernorm(p, prefix)
    if "layers_0" in p:
        return mlp(p, prefix)
    return {k: v for name, sub in p.items() for k, v in named_leaves(sub, f"{prefix}.{name}").items()}


# what the closed-vocabulary models hold under `transformer.`, as the
# reference's transformers do; CoupledDETRHOI's transformer holds its
# semantic table and priors too (OCN's sit on the model)
CLOSED_VOCAB_TRANSFORMER = ("level_embed", "reference_points", "reference_points_sub", "reference_points_obj",
                            "enc_output", "enc_output_norm", "enc_class", "enc_bbox", "pos_trans", "pos_trans_norm",
                            "hm_conv", "hm_off", "hm_embed", "hm_deform_kernel", "hm_deform_bias")
COUPLED_TRANSFORMER = ("semantic_q", "semantic_k", "semantic_v", "semantic_proj_res", "semantic_gate", "verb_norm",
                       "dec_norm", "verb_word_embedding", "obj_verb_co")
QUERY_TABLES = ("query_embed", "verb_query_embed", "tgt_embed", "verb_tgt_embed", "refpoint_embed")


def closed_vocab_state_dict(p, cfg) -> dict[str, np.ndarray]:
    """Flax params of a `models/closed_vocab.py` model -> its state dict:
    `enc_{i}` and `[obj_|verb_]dec_{i}` (dense) into the DenseEncoder and
    DenseDecoders, the scanned deformable encoder and decoders unstacked,
    `input_proj_{i}` / `input_norm_{i}` into `input_proj.{i}.{0,1}`, the
    query tables into nn.Embedding weights, and every other leaf under its
    own name (`named_leaves`), in `transformer.` where the model keeps it."""
    t = cfg.transformer
    inside = CLOSED_VOCAB_TRANSFORMER + (COUPLED_TRANSFORMER if "dec_norm" in p else ())
    sd = {}
    for k, v in p.items():
        dense_dec = re.fullmatch(r"(obj_|verb_)?dec_(\d+)", k)
        level = re.fullmatch(r"input_(proj|norm)_(\d+)", k)
        if k == "backbone":
            sd.update(backbone(v, cfg))
        elif k.startswith("enc_") and k[4:].isdigit():
            sd.update(dense_encoder_layer(v, f"transformer.encoder.layers.{k[4:]}"))
        elif dense_dec:
            sd.update(dense_decoder_layer(v, f"transformer.{dense_dec[1] or ''}decoder.layers.{dense_dec[2]}"))
        elif k == "encoder":
            for i in range(t.enc_layers):
                sd.update(encoder_layer(_unstack(v["layers"], i), f"transformer.encoder.layers.{i}"))
        elif k in ("decoder", "ho_decoder", "verb_decoder"):  # plain deformable
            for i in range(t.dec_layers):
                sd.update(decoder_layer(_unstack(v["layers"], i)["layer"], f"transformer.{k}.layers.{i}"))
        elif k in ("ho_decoder_dab", "verb_decoder_dab"):
            sd.update(dab_decoder(v, t.dec_layers, f"transformer.{k}."))
        elif k == "input_proj":
            sd.update(dense_input_proj(v, "input_proj"))
        elif level:  # the convolution, then its GroupNorm
            proj = level[1] == "proj"
            sd.update((conv if proj else layernorm)(v, f"input_proj.{level[2]}.{0 if proj else 1}"))
        elif k in ("verb_tgt_generator", "verb_mbf"):
            sd.update(multi_branch_fusion(v, "transformer.verb_tgt_generator" if k == "verb_tgt_generator" else k))
        elif k in QUERY_TABLES:
            sd[f"{k}.weight"] = _np(v)
        else:
            sd.update(named_leaves(v, f"transformer.{k}" if k in inside else k))
    return sd


def state_dict_from_jax(params, cfg) -> dict[str, np.ndarray]:
    """Full flax params of the model `cfg.variant` names (with or without
    the outer "params" key) -> state dict for the port's model of that
    class. The trees are told apart by their content: the closed-vocabulary
    ones by their `obj_class_embed`, the deformable ones by `level_embed`
    (RLIP-ParSeD's by `query_embed`, its plain encoder by no ALIF
    `blocks`), the dense ones as `dense_state_dict` says."""
    p = params["params"] if "params" in params else params
    # ParSeDABDETR's tree reads as a closed-vocabulary one and RLIPMDETR's
    # as RLIPParSe's: their variants route them
    if cfg.variant == "parse_dab_detr":
        return dab_detr_state_dict(p, cfg)
    if cfg.variant == "rlip_mdetr":
        return dense_state_dict(p, cfg)
    if "obj_class_embed" in p:
        return closed_vocab_state_dict(p, cfg)
    if "level_embed" not in p:
        return dense_state_dict(p, cfg)
    t = cfg.transformer
    parsed = "query_embed" in p
    sd = {
        "bias_obj_a": _np(p["bias_obj_a"]),
        "bias_pred_a": _np(p["bias_pred_a"]),
        "transformer.level_embed": _np(p["level_embed"]),
        **linear(p["projection_text"], "projection_text"),
        "tgt_embed.weight": _np(p["tgt_embed"]),
        "verb_tgt_embed.weight": _np(p["verb_tgt_embed"]),
        "refpoint_embed.weight": _np(p["refpoint_embed"]),
    }
    for name, offset in (("ho_decoder", 0), ("verb_decoder", t.dec_layers)):
        if name in p:  # on RLIPParSeD, only in a tree with the tagger's leaves
            sd.update(dab_decoder(p[name], t.dec_layers, f"transformer.{name}.", None if parsed else "", offset))
    if parsed:
        sd["query_embed.weight"] = _np(p["query_embed"])
        for side in ("sub", "obj"):
            sd.update(linear(p[f"reference_points_{side}"], f"transformer.reference_points_{side}"))
            for i in range(t.dec_layers):
                sd.update(mlp(p[f"{side}_bbox_embed_{i}"], f"{side}_bbox_embed.{i}"))
        for name in ("ho_decoder_nd", "verb_decoder_nd"):
            for i in range(t.dec_layers):
                step = _unstack(p[name]["layers"], i)
                sd.update(decoder_layer(step["layer"], f"transformer.{name}.layers.{i}"))
    if "coord_proj" in p:
        sd.update(linear(p["coord_proj"], "transformer.coord_proj"))
    for name in ("sub_curing", "obj_curing", "recon_linear"):  # verb curing, masked-entity modeling
        if name in p:
            sd.update(linear(p[name], name))
    for name in ("recon_sub_bbox", "recon_obj_bbox"):
        if name in p:
            sd.update(mlp(p[name], name))
    if "verb_tgt_generator" in p:
        sd.update(multi_branch_fusion(p["verb_tgt_generator"], "transformer.verb_tgt_generator"))
    if "blocks" in p["encoder"]:
        sd.update(alif_encoder(p["encoder"], t.enc_layers, t.fusion.fusion_interval, "transformer.encoder."))
    else:  # no_fusion: the plain encoder's scanned layers
        for i in range(t.enc_layers):
            sd.update(encoder_layer(_unstack(p["encoder"]["layers"], i), f"transformer.encoder.layers.{i}"))
    sd.update(roberta_model(p["text_encoder"], cfg.text_encoder.num_layers, "transformer.text_encoder."))
    sd.update(linear(p["resizer"]["fc"], "transformer.resizer.fc"))
    sd.update(layernorm(p["resizer"]["layer_norm"], "transformer.resizer.layer_norm"))
    for i in range(t.num_feature_levels):
        sd.update(conv(p[f"input_proj_{i}"], f"input_proj.{i}.0"))
        sd.update(layernorm(p[f"input_norm_{i}"], f"input_proj.{i}.1"))
    sd.update(backbone(p["backbone"], cfg))
    return sd


def filter_query_embeddings(tgt: np.ndarray, refpoint: np.ndarray, num_queries: int) -> tuple[np.ndarray, np.ndarray]:
    """Warm-start query filtering (rlipv2_tpu/engine/convert.py:815-827;
    reference util/misc.py:466-505): truncate when the checkpoint has more
    queries, tile when it has fewer."""
    n = tgt.shape[0]
    if n >= num_queries:
        return tgt[:num_queries], refpoint[:num_queries]
    reps = -(-num_queries // n)
    return np.tile(tgt, (reps, 1))[:num_queries], np.tile(refpoint, (reps, 1))[:num_queries]


QUERY_EMBEDDINGS = ("tgt_embed.weight", "verb_tgt_embed.weight", "refpoint_embed.weight", "query_embed.weight")


def fit_query_embeddings(state: dict, num_queries: int) -> dict:
    """`state` with its query embeddings (QUERY_EMBEDDINGS; RLIP-ParSeD's
    (nq, 2C) `query_embed` where the state has one) fitted to `num_queries`
    rows by `filter_query_embeddings`: truncated, or tiled; other entries
    as they are. A state without `refpoint_embed.weight` (a dense model's,
    whose embeddings the JAX filter does not know) comes back as it is."""
    import torch

    if "refpoint_embed.weight" not in state:
        return dict(state)

    def fit(name, ref="refpoint_embed.weight"):
        tgt, refpoint = filter_query_embeddings(state[name].numpy(), state[ref].numpy(), num_queries)
        return torch.from_numpy(np.ascontiguousarray(tgt)), torch.from_numpy(np.ascontiguousarray(refpoint))

    out = dict(state)
    out["tgt_embed.weight"], out["refpoint_embed.weight"] = fit("tgt_embed.weight")
    out["verb_tgt_embed.weight"], _ = fit("verb_tgt_embed.weight")
    if "query_embed.weight" in state:
        out["query_embed.weight"], _ = fit("query_embed.weight")
    return out


def read_checkpoint(path) -> dict:
    """A reference-layout `.pth` on the CPU, read with `weights_only=True`;
    the reference's files pickle their `args` as an argparse Namespace,
    which is allowed. A detector's `model` entry is the input of the
    detector converters below."""
    import torch

    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_checkpoint(model, path) -> dict:
    """Load the `model` entry of a reference-layout `.pth` into the port's
    model, strictly, with the query embeddings that `fit_query_embeddings`
    knows fitted to the model's `num_queries`; any other tensor of another
    shape than the model's (a dense model's `query_embed` or
    `verb_query_embed` for another query count) raises ValueError. Into a model built with `tagger=True` a
    file without the tagger's parameters (`TAGGER_PREFIXES`: a detector's
    or relation model's checkpoint) loads too, and so does a file without
    the verb-curing or masked-entity heads (`HEAD_PREFIXES`: the
    pre-trained relation model every fine-tune script starts from) into a
    model that has them; those parameters keep their initial values. Any
    other missing key fails the strict load. The file is read by
    `read_checkpoint`. Returns the checkpoint's other entries, and under
    "initialised" the names of the parameters the file did not hold."""
    ckpt = read_checkpoint(path)
    state = fit_query_embeddings(ckpt["model"], model.cfg.num_queries)
    own_shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    wrong = {k: (tuple(v.shape), own_shapes[k]) for k, v in state.items()
             if k in own_shapes and tuple(v.shape) != own_shapes[k]}
    if wrong:
        raise ValueError(f"{path}: tensors whose shapes (file, model) differ: {wrong}")
    optional = tuple(getattr(model, "HEAD_PREFIXES", ()))
    if getattr(model, "tagger", False):
        optional += model.TAGGER_PREFIXES
    own = model.state_dict()
    initialised = [k for k in own if k not in state and k.startswith(optional)]
    state = {**state, **{k: own[k] for k in initialised}}
    model.load_state_dict(state, strict=True)
    return {**{k: v for k, v in ckpt.items() if k != "model"}, "initialised": initialised}


# ------------------------------------------------------------ detector warm starts
#
# The reference's way into HOI training (its convert_parameters/ scripts;
# rlipv2_tpu/engine/convert.py:489-814): a COCO-pretrained detector's state
# dict becomes a warm start of an HOI model. The port's names are the
# reference's, so each converter maps the detector's keys (a reference
# `.pth`'s `model` entry, torch tensors or numpy arrays) to a partial state
# dict in the HOI model's own key space, float32 numpy arrays, and
# `load_partial_state_dict` loads it over a built model; the text side (the
# text encoder, resizer, projection, fusion) keeps its init.

# COCO category ids used by HICO's 80-object remap; index 91 is the appended
# background row (reference convert_parameters/convert_parameters_DABDDETR.py
# obj_ids table; datasets/hico.py:46-55 documents the same remap)
COCO_OBJ_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90, 91,
]
_LINEAR = ("weight", "bias")
_MHA = ("in_proj_weight", "in_proj_bias", "out_proj.weight", "out_proj.bias")
_MSDA = tuple(f"{m}.{w}" for m in ("sampling_offsets", "attention_weights", "value_proj", "output_proj")
              for w in _LINEAR)
_FFN = tuple(f"{m}.{w}" for m in ("linear1", "linear2") for w in _LINEAR)


def coco_class_embed_to_hico(weight: np.ndarray, bias: np.ndarray, bg_weight=None, bg_bias=None,
                             dataset: str = "hico"):
    """Remap a COCO 91-way class head to HICO's 80 objects + the no-object
    slot (reference convert_parameters_DABDDETR.py:142-147 appends a fresh
    background row, then gathers obj_ids). dataset="vcoco" further inserts
    one fresh object row BEFORE the background slot (V-COCO's extra
    no-object pairing class, reference convert_parameters/convert_DABDETR.py:80-92).
    The fresh rows are drawn from RandomState(0), as the JAX function draws
    them."""
    rng = np.random.RandomState(0)
    if bg_weight is None:
        bg_weight = (rng.randn(1, weight.shape[1]) / np.sqrt(weight.shape[1])).astype(np.float32)
    if bg_bias is None:
        bg_bias = np.zeros((1,), np.float32)
    w = np.concatenate([weight, bg_weight], axis=0)
    b = np.concatenate([bias, bg_bias], axis=0)
    w, b = w[COCO_OBJ_IDS], b[COCO_OBJ_IDS]
    if dataset == "vcoco":
        extra_w = (rng.randn(1, w.shape[1]) / np.sqrt(w.shape[1])).astype(np.float32)
        extra_b = np.zeros((1,), np.float32)
        w = np.concatenate([w[:-1], extra_w, w[-1:]], axis=0)
        b = np.concatenate([b[:-1], extra_b, b[-1:]], axis=0)
    return w, b


def _arrays(sd: Mapping) -> dict[str, np.ndarray]:
    """A detector state dict of torch tensors or arrays -> float32 numpy."""
    return {k: (v.detach().cpu().float().numpy() if hasattr(v, "detach") else np.asarray(v, np.float32))
            for k, v in sd.items()}


def _copy(sd: dict, src: str, dst: str, fields) -> dict:
    """`{dst}.{f}` <- `{src}.{f}` for each field f (a KeyError names a
    missing one)."""
    return {f"{dst}.{f}": sd[f"{src}.{f}"].copy() for f in fields}


def _vision(sd: dict, cfg, levels: bool = True) -> dict:
    """The detector's ResNet under `backbone.0.body.` (its FrozenBN buffers
    as they are) and, with `levels`, its multi-level input projections
    (1x1/3x3 conv + GroupNorm) present in the state dict."""
    out = {k: v.copy() for k, v in sd.items() if k.startswith("backbone.0.body.")}
    for i in range(cfg.transformer.num_feature_levels if levels else 0):
        if f"input_proj.{i}.0.weight" in sd:
            out.update(_copy(sd, f"input_proj.{i}", f"input_proj.{i}", ("0.weight", "0.bias", "1.weight", "1.bias")))
    return out


def _deformable_encoder(sd: dict, cfg) -> dict:
    """The DDETR encoder's layers (the ALIF encoder's deformable layers,
    or RLIP-ParSeD v1's plain encoder), when the detector has all the
    model's `enc_layers`: else none (the JAX converters' rule)."""
    n = cfg.transformer.enc_layers
    have = [i for i in range(n) if f"transformer.encoder.layers.{i}.self_attn.value_proj.weight" in sd]
    if have != list(range(n)):
        return {}
    fields = tuple(f"self_attn.{f}" for f in _MSDA) + ("norm1.weight", "norm1.bias", "norm2.weight",
                                                        "norm2.bias") + _FFN
    return {k: v for i in range(n) for k, v in _copy(sd, f"transformer.encoder.layers.{i}",
                                                     f"transformer.encoder.layers.{i}", fields).items()}


def _deformable_decoder_layers(sd: dict, cfg, dst: str) -> dict:
    """The detector decoder's layers (MSDA cross-attention, self-attention,
    three norms, FFN) under `{dst}.layers.{i}`."""
    fields = (tuple(f"cross_attn.{f}" for f in _MSDA) + tuple(f"self_attn.{f}" for f in _MHA)
              + tuple(f"norm{j}.{w}" for j in (1, 2, 3) for w in _LINEAR) + _FFN)
    return {k: v for i in range(cfg.transformer.dec_layers)
            for k, v in _copy(sd, f"transformer.decoder.layers.{i}", f"{dst}.layers.{i}", fields).items()}


def _mlp_fields(n_layers: int) -> tuple:
    return tuple(f"layers.{j}.{w}" for j in range(n_layers) for w in _LINEAR)


def _box_head(sd: dict, layer: int, shared_fallback: bool = False):
    """The detector's box head of decoder layer `layer`: its per-layer
    clone under `transformer.decoder.bbox_embed.{l}` or `bbox_embed.{l}`,
    with `shared_fallback` the one shared `bbox_embed` of a checkpoint
    without box refinement; None where the state dict has none."""
    for src in (f"transformer.decoder.bbox_embed.{layer}", f"bbox_embed.{layer}") + (
            ("bbox_embed",) if shared_fallback else ()):
        if f"{src}.layers.0.weight" in sd:
            return src
    return None


def convert_dab_ddetr_detector(sd: Mapping, cfg) -> dict[str, np.ndarray]:
    """A COCO-pretrained DAB-Deformable-DETR's state dict -> a partial
    RLIP-ParSeDA state dict (reference convert_parameters_DABDDETR.py:91-160;
    JAX `convert_dab_ddetr_detector`): the backbone and input projections;
    `tgt_embed` and `refpoint_embed` fitted to `num_queries`
    (`filter_query_embeddings`), `tgt_embed` also as `verb_tgt_embed`;
    `level_embed`; the DDETR encoder's layers as the ALIF encoder's
    deformable layers; the decoder's layers, `ref_point_head` and
    `query_scale` into both the ho and the verb decoder; each decoder
    layer's box head into the subject and the object heads of both
    decoders. A layer whose box head the detector lacks keeps its heads'
    init, and the other layers take theirs; the JAX converter drops every
    layer's heads then (`group_dab_decoder_layers`, ROADMAP queue 3)."""
    sd = _arrays(sd)
    t = cfg.transformer
    out = _vision(sd, cfg)
    tgt, ref = filter_query_embeddings(sd["tgt_embed.weight"], sd["refpoint_embed.weight"], cfg.num_queries)
    out["tgt_embed.weight"], out["verb_tgt_embed.weight"] = tgt.copy(), tgt.copy()
    out["refpoint_embed.weight"] = ref.copy()
    out["transformer.level_embed"] = sd["transformer.level_embed"].copy()
    out.update(_deformable_encoder(sd, cfg))
    heads = ["ref_point_head"] + (["query_scale"] if "transformer.decoder.query_scale.layers.0.weight" in sd else [])
    for offset, dec in ((0, "transformer.ho_decoder"), (t.dec_layers, "transformer.verb_decoder")):
        out.update(_deformable_decoder_layers(sd, cfg, dec))
        for name in heads:
            out.update(_copy(sd, f"transformer.decoder.{name}", f"{dec}.{name}", _mlp_fields(2)))
        for layer in range(t.dec_layers):
            src = _box_head(sd, layer)
            if src is None:
                continue
            for side in ("sub", "obj"):  # the decoder's head and its top-level name
                for dst in (f"{dec}.{side}_bbox_embed.{layer}", f"{side}_bbox_embed.{offset + layer}"):
                    out.update(_copy(sd, src, dst, _mlp_fields(3)))
    return out


def convert_ddetr_detector(sd: Mapping, cfg) -> dict[str, np.ndarray]:
    """A COCO-pretrained (plain) Deformable-DETR's state dict -> a partial
    RLIP-ParSeD state dict (reference convert_parameters_DDETR.py:91-126;
    JAX `convert_ddetr_detector`): the backbone, input projections and
    `level_embed`; `query_embed` ([query_pos || tgt], nq x 2C), its first
    num_queries // 2 rows twice (the subject and object halves start equal),
    tiled to num_queries where the detector has fewer; the
    `transformer.reference_points` linear as both `reference_points_sub`
    and `reference_points_obj`; the encoder's layers; the decoder's layers
    into both plain decoders (`{ho,verb}_decoder_nd`); each decoder layer's
    box head (or a shared `bbox_embed`) into the top-level subject and
    object heads of that layer."""
    sd = _arrays(sd)
    t, nq = cfg.transformer, cfg.num_queries
    out = _vision(sd, cfg)
    if "transformer.level_embed" in sd:
        out["transformer.level_embed"] = sd["transformer.level_embed"].copy()
    qe = sd["query_embed.weight"]
    half = np.concatenate([qe[: nq // 2], qe[: nq // 2]], axis=0)
    if half.shape[0] < nq:
        half = np.tile(half, (-(-nq // half.shape[0]), 1))[:nq]
    out["query_embed.weight"] = half
    for side in ("sub", "obj"):
        out.update(_copy(sd, "transformer.reference_points", f"transformer.reference_points_{side}", _LINEAR))
    out.update(_deformable_encoder(sd, cfg))
    for dec in ("transformer.ho_decoder_nd", "transformer.verb_decoder_nd"):
        out.update(_deformable_decoder_layers(sd, cfg, dec))
    for layer in range(t.dec_layers):
        src = _box_head(sd, layer, shared_fallback=True)
        if src is not None:
            for side in ("sub", "obj"):
                out.update(_copy(sd, src, f"{side}_bbox_embed.{layer}", _mlp_fields(3)))
    return out


def convert_detr_detector(sd: Mapping, cfg) -> dict[str, np.ndarray]:
    """A COCO-pretrained vanilla DETR's (or MDETR's) state dict -> a partial
    RLIP-ParSe v1 (`RLIPParSeV1Joint`) state dict (reference
    convert_parameters.py:129-141 and convert_MDETR_to_RLIP.py:143-152; JAX
    `convert_detr_detector`): the backbone and `input_proj`; `query_embed`
    with its first num_queries // 2 rows twice; the dense encoder's layers
    present; the decoder's layers into both the ho and the verb decoder,
    the image cross-attention from DETR's `multihead_attn` or MDETR's
    `cross_attn_image`, and the norms after it and after the FFN from
    DETR's norm2 / norm3 or MDETR's norm3 / norm4; `transformer.decoder.norm`
    into both decoders' final norms; the box head into the subject and the
    object heads."""
    sd = _arrays(sd)
    t, nq = cfg.transformer, cfg.num_queries
    out = _vision(sd, cfg, levels=False)
    if "input_proj.weight" in sd:
        out.update(_copy(sd, "input_proj", "input_proj", _LINEAR))
    qe = sd["query_embed.weight"]
    out["query_embed.weight"] = np.concatenate([qe[: nq // 2], qe[: nq // 2]], axis=0)[:nq]
    for i in range(t.enc_layers):
        p = f"transformer.encoder.layers.{i}"
        if f"{p}.self_attn.in_proj_weight" not in sd:
            break
        out.update(_copy(sd, p, p, tuple(f"self_attn.{f}" for f in _MHA) + tuple(
            f"norm{j}.{w}" for j in (1, 2) for w in _LINEAR) + _FFN))
    for i in range(t.dec_layers):
        p = f"transformer.decoder.layers.{i}"
        mdetr = f"{p}.norm4.weight" in sd  # MDETR numbers its norms 1/3/4 (2 is the text slot)
        cross = "cross_attn_image" if f"{p}.cross_attn_image.in_proj_weight" in sd else "multihead_attn"
        for side in ("ho", "verb"):
            q = f"transformer.{side}_decoder.layers.{i}"
            out.update(_copy(sd, p, q, tuple(f"self_attn.{f}" for f in _MHA) + tuple(
                f"{m}.{w}" for m in ("norm1", "linear1", "linear2") for w in _LINEAR)))
            out.update(_copy(sd, f"{p}.{cross}", f"{q}.cross_attn_image", _MHA))
            out.update(_copy(sd, f"{p}.{'norm3' if mdetr else 'norm2'}", f"{q}.norm3", _LINEAR))
            out.update(_copy(sd, f"{p}.{'norm4' if mdetr else 'norm3'}", f"{q}.norm4", _LINEAR))
    if "transformer.decoder.norm.weight" in sd:
        for side in ("ho", "verb"):
            out.update(_copy(sd, "transformer.decoder.norm", f"transformer.{side}_decoder.norm", _LINEAR))
    if "bbox_embed.layers.0.weight" in sd:
        for side in ("sub", "obj"):
            out.update(_copy(sd, "bbox_embed", f"{side}_bbox_embed", _mlp_fields(3)))
    return out


# the HOI model each converter warm-starts: its variant -> the converter
DETECTOR_CONVERTERS = {"rlip_parseda_v2": convert_dab_ddetr_detector, "rlip_parsed_v2": convert_ddetr_detector,
                       "rlip_parse_v1_joint": convert_detr_detector}


def load_partial_state_dict(model, partial: Mapping) -> list[str]:
    """Copy `partial` (name -> array or tensor, in the model's key space:
    a converter's output) into `model`'s parameters and buffers. Every name
    must be a key of the model's state dict, with its shape: a ValueError
    names each one that is not, and nothing is copied (a misnamed or
    misshapen key is never dropped). Returns the model's keys that kept
    their init, a tensor that two names share (the RLIP-ParSeDA box heads)
    counting as set when either name is given."""
    import torch

    own = model.state_dict()
    unknown = sorted(k for k in partial if k not in own)
    wrong = {k: (tuple(np.shape(v)), tuple(own[k].shape)) for k, v in partial.items()
             if k in own and tuple(np.shape(v)) != tuple(own[k].shape)}
    if unknown or wrong:
        raise ValueError(f"the partial state dict does not fit {type(model).__name__}: unknown keys {unknown}, "
                         f"shapes (given, model) {wrong}")
    with torch.no_grad():
        for k, v in partial.items():
            own[k].copy_(torch.as_tensor(np.ascontiguousarray(v)))
    written = {own[k].data_ptr() for k in partial}
    return [k for k, t in own.items() if t.data_ptr() not in written]
