"""JAX -> torch weight conversion: the inverse of
rlipv2_tpu/engine/convert.py::convert_rlip_parseda.

`state_dict_from_jax(params, cfg)` turns a flax param tree of the model
`cfg.variant` names (RLIPParSeDA, RLIPParSeD with the ALIF or, as
RLIP-ParSeD v1, the plain encoder, RLIPParSe, RLIPParSeV2 or
RLIPParSeV1Joint) into a state dict in the reference key space (for the
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
    """Scanned DAB decoder tree -> reference keys. The box heads go under
    `{prefix}sub_bbox_embed.{i}` and, when `head_prefix` is given, also
    under `{head_prefix}sub_bbox_embed.{head_offset + i}`."""
    out = {}
    for i in range(dec_layers):
        step = _unstack(p["layers"], i)
        out.update(decoder_layer(step["layer"], f"{prefix}layers.{i}"))
        for name in ("sub_bbox_embed", "obj_bbox_embed"):
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
    """Flax RLIPParSe, RLIPParSeV2 or RLIPParSeV1Joint params -> state dict
    for the port's model of that class; the trees told apart by their
    content: V1Joint's by its decoders' final norms, RLIPParSeV2's by its
    one `encoder`, RLIPParSe's by `verb_query_embed`."""
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
    joint = "ho_decoder_norm" in p
    names = ("cross_attn_image", "norm3", "norm4") if joint else ("cross_attn", "norm2", "norm3")
    for side in ("ho", "verb"):
        for i in range(t.dec_layers):
            sd.update(dense_decoder_layer(p[f"{side}_dec_{i}"], f"transformer.{side}_decoder.layers.{i}", names))
        if joint:
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
            for i in range(2):
                sd.update(dense_encoder_layer(p[f"{side}_fusion"][f"layer_{i}"],
                                              f"transformer.{side}_fusion.layers.{i}"))
    if not joint:
        sd.update(roberta_model(p["text_encoder"], cfg.text_encoder.num_layers, "transformer.text_encoder."))
    sd.update(backbone(p["ResNet_0" if joint else "backbone"], cfg))
    return sd


def state_dict_from_jax(params, cfg) -> dict[str, np.ndarray]:
    """Full flax params of the model `cfg.variant` names (with or without
    the outer "params" key) -> state dict for the port's model of that
    class. The trees are told apart by their content: the deformable ones
    by `level_embed` (RLIP-ParSeD's by `query_embed`, its plain encoder by
    no ALIF `blocks`), the dense ones as `dense_state_dict` says."""
    p = params["params"] if "params" in params else params
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
    other missing key fails the strict load. The file is read with `weights_only=True`; the
    reference's files pickle their `args` as an argparse Namespace, which
    is allowed. Returns the checkpoint's other entries, and under
    "initialised" the names of the parameters the file did not hold."""
    import torch

    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
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
