"""JAX -> torch weight conversion: the inverse of
rlipv2_tpu/engine/convert.py::convert_rlip_parseda.

`state_dict_from_jax(params, cfg)` turns a flax RLIPParSeDA param tree into
a state dict in the reference key space, which loads into the port's
RLIPParSeDA with `load_state_dict(strict=True)`. It
  * un-stacks the scanned trees (`group_alif_blocks`,
    `group_dab_decoder_layers`, the scanned RoBERTa `layers`);
  * un-folds FrozenAffine into the four FrozenBN buffers:
    weight = scale * sqrt(1 + eps), bias, running_mean = 0, running_var = 1;
  * transposes Dense/Conv kernels and unpacks the flax MultiHeadDotProduct
    projections into `in_proj_weight` / `out_proj`;
  * un-permutes the Swin PatchMerging blocks (`swin`);
  * writes each per-layer box head under both of its reference names, the
    top-level `sub_bbox_embed.{i}` (ho heads first, then verb heads) and
    `transformer.{ho,verb}_decoder.sub_bbox_embed.{i}`.

The per-module functions take a flax subtree and a key prefix, so a single
module converts the same way as the whole model. Input arrays may be jax or
numpy; outputs are float32 numpy arrays.
"""

from __future__ import annotations

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


def state_dict_from_jax(params, cfg) -> dict[str, np.ndarray]:
    """Full flax RLIPParSeDA params (with or without the outer "params"
    key) -> reference-key state dict for rlipv2_tpu_torch RLIPParSeDA."""
    from rlipv2_tpu_torch.models.resnet import STAGE_BLOCKS
    from rlipv2_tpu_torch.models.swin import SWIN_SPECS

    p = params["params"] if "params" in params else params
    t = cfg.transformer
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
        sd.update(dab_decoder(p[name], t.dec_layers, f"transformer.{name}.", "", offset))
    if "verb_tgt_generator" in p:
        sd.update(multi_branch_fusion(p["verb_tgt_generator"], "transformer.verb_tgt_generator"))
    sd.update(alif_encoder(p["encoder"], t.enc_layers, t.fusion.fusion_interval, "transformer.encoder."))
    sd.update(roberta_model(p["text_encoder"], cfg.text_encoder.num_layers, "transformer.text_encoder."))
    sd.update(linear(p["resizer"]["fc"], "transformer.resizer.fc"))
    sd.update(layernorm(p["resizer"]["layer_norm"], "transformer.resizer.layer_norm"))
    for i in range(t.num_feature_levels):
        sd.update(conv(p[f"input_proj_{i}"], f"input_proj.{i}.0"))
        sd.update(layernorm(p[f"input_norm_{i}"], f"input_proj.{i}.1"))
    name = cfg.backbone.name
    if name.startswith("resnet"):
        sd.update(resnet(p["backbone"], STAGE_BLOCKS[name], "backbone.0.body."))
    else:
        sd.update(swin(p["backbone"], SWIN_SPECS[name], "backbone.0.body."))
    return sd
