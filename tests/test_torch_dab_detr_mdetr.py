"""The port's last two factory variants against the JAX package's, float32
on the CPU, from numpy seeds:
  * the forwards of ParSe-DAB-DETR (`parse_dab_detr`), RLIP-MDETR
    (`rlip_mdetr`) and RLIPParSeV1Joint with `features=` (image tokens in
    place of the backbone's, with padded tokens) within 2e-3 from the JAX
    params `state_dict_from_jax` carries (routed by the variant), loaded
    strictly, every JAX leaf counted into one port tensor; batch 2 in the
    61 x 83 bucket with a padded image and padded text slots;
  * ConditionalDecoderLayer within 1e-3 in its first-layer form (with
    `ca_qpos_proj`) and its later form, on the layers of the model's
    seeded tree, with padded memory keys;
  * the detach of the refined anchors: the gradient of `refpoint_embed`
    (which reaches it only through the first layer) within 1e-3 of JAX's;
  * the factory builds both variants as the JAX factory's classes.
One jit at XLA's cheapest level computes every JAX output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlipv2_tpu.models import dab_detr as jax_dab_detr
from rlipv2_tpu.models.factory import build_model as jax_build_model
from rlipv2_tpu_torch.engine import convert
from rlipv2_tpu_torch.engine.convert import state_dict_from_jax
from rlipv2_tpu_torch.models import dab_detr
from rlipv2_tpu_torch.models.factory import build_model
from test_parseda_forward import tiny_config
from test_torch_parse import BATCH, N_OBJ, OUT_KEYS, close, jax_params, model_inputs, to_torch
from test_torch_parsed import FAST_COMPILE, _leaf_count, _port_count
from test_torch_parseda import random_params

torch.set_num_threads(2)

MODULE_ATOL, MODEL_ATOL, GRAD_ATOL = 1e-3, 2e-3, 1e-3
VARIANTS = ("parse_dab_detr", "rlip_mdetr", "rlip_parse_v1_joint")
S_FEATURES = 20  # V1Joint's image tokens given through features=


def features(seed=2, d=64):
    """(src, pos, valid) image tokens; the first image's last 7 padded."""
    rng = np.random.RandomState(seed)
    valid = np.ones((BATCH, S_FEATURES), bool)
    valid[0, -7:] = False
    return (rng.randn(BATCH, S_FEATURES, d).astype(np.float32), rng.randn(BATCH, S_FEATURES, d).astype(np.float32),
            valid)


def layer_inputs(seed=4, nq=16, S=12, d=64):
    """tgt, query_pos, query_sine_embed (B, nq, d), memory, pos (B, S, d),
    mem_valid (B, S) with the second image's last 5 keys padded."""
    rng = np.random.RandomState(seed)
    valid = np.ones((BATCH, S), bool)
    valid[1, -5:] = False
    return (*(rng.randn(BATCH, nq, d).astype(np.float32) for _ in range(3)),
            *(rng.randn(BATCH, S, d).astype(np.float32) for _ in range(2)), valid)


def box_weights(cfg, seed=6):
    """Fixed weights of the boxes in the anchor-gradient loss: (layers, B, nq / 2, 4) each side."""
    rng = np.random.RandomState(seed)
    shape = (cfg.transformer.dec_layers, BATCH, cfg.num_queries // 2, 4)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


def box_loss(out, w_sub, w_obj, backend):
    """sum over every layer of boxes x weights."""
    layers = [*out["aux_outputs"], out]
    return sum((lay["pred_sub_boxes"] * w_sub[i]).sum() + (lay["pred_obj_boxes"] * w_obj[i]).sum()
               for i, lay in enumerate(layers)) if backend == "torch" else sum(
        jnp.sum(lay["pred_sub_boxes"] * w_sub[i]) + jnp.sum(lay["pred_obj_boxes"] * w_obj[i])
        for i, lay in enumerate(layers))


@pytest.fixture(scope="module")
def pairs():
    """{variant: (cfg, JAX model, seeded JAX params, port model)}."""
    out = {}
    for i, v in enumerate(VARIANTS):
        cfg = tiny_config(variant=v)
        if v == "parse_dab_detr":  # no text
            jm = jax_build_model(cfg)
            params = random_params(lambda jm=jm: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                                         jnp.ones((1, 64, 64), bool)), seed=40 + i)
        else:
            jm, params = jax_params(cfg, seed=40 + i)
        out[v] = (cfg, jm, params, to_torch(build_model(cfg), state_dict_from_jax(params, cfg)))
    return out


@pytest.fixture(scope="module")
def jax_outputs(pairs):
    """In one jit: the three forwards, the two decoder-layer forms, and the
    gradient of `box_loss` with respect to ParSe-DAB-DETR's params."""
    cfg, dab, dab_params, _ = pairs["parse_dab_detr"]
    x = [jnp.asarray(a) for a in model_inputs(cfg)]
    feats = tuple(jnp.asarray(a) for a in features())
    lay = [jnp.asarray(a) for a in layer_inputs()]
    layer = jax_dab_detr.ConditionalDecoderLayer(cfg)
    w_sub, w_obj = box_weights(cfg)

    def run(params):
        fwd = {"parse_dab_detr": dab.apply(params["parse_dab_detr"], *x[:2]),
               "rlip_mdetr": pairs["rlip_mdetr"][1].apply(params["rlip_mdetr"], *x, N_OBJ),
               "rlip_parse_v1_joint": pairs["rlip_parse_v1_joint"][1].apply(params["rlip_parse_v1_joint"], *x, N_OBJ,
                                                                            features=feats)}
        layers = {first: layer.apply({"params": params["parse_dab_detr"]["params"][f"dec_{0 if first else 1}"]},
                                     *lay, first) for first in (True, False)}
        grads = jax.grad(lambda p: box_loss(dab.apply(p, *x[:2]), w_sub, w_obj, "jax"))(params["parse_dab_detr"])
        return fwd, layers, grads["params"]["refpoint_embed"]

    params = {v: pairs[v][2] for v in VARIANTS}
    return jax.jit(run).lower(params).compile(compiler_options=FAST_COMPILE)(params)


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_matches_jax(pairs, jax_outputs, variant):
    cfg, _, params, model = pairs[variant]
    assert _leaf_count(params) == _port_count(model)
    want = jax_outputs[0][variant]
    x = model_inputs(cfg)
    assert not x[1].all() and not x[3].all()  # padded pixels and text slots
    with torch.no_grad():
        if variant == "parse_dab_detr":
            got = model(*(torch.from_numpy(a) for a in x[:2]))
        else:
            kw = {"features": tuple(torch.from_numpy(a) for a in features())} if variant == "rlip_parse_v1_joint" \
                else {}
            got = model(*(torch.from_numpy(a) for a in x), N_OBJ, **kw)
    assert set(got) == set(OUT_KEYS) | {"aux_outputs"}
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == cfg.transformer.dec_layers - 1
    for g, w in [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"])):
        for k in OUT_KEYS:
            close(g[k], w[k], MODEL_ATOL, k)


@pytest.mark.parametrize("first", [True, False])
def test_conditional_decoder_layer_matches_jax(pairs, jax_outputs, first):
    p = pairs["parse_dab_detr"][2]["params"][f"dec_{0 if first else 1}"]
    assert ("ca_qpos_proj" in p) == first
    layer = to_torch(dab_detr.ConditionalDecoderLayer(tiny_config().transformer, first),
                     convert.named_leaves(p, "m"), "m.")
    with torch.no_grad():
        got = layer(*(torch.from_numpy(a) for a in layer_inputs()))
    close(got, jax_outputs[1][first], MODULE_ATOL)


def test_anchor_gradient_matches_jax(pairs, jax_outputs):
    """The refined anchors are detached between layers in both: the
    gradient reaching `refpoint_embed` agrees."""
    cfg, _, _, model = pairs["parse_dab_detr"]
    x = model_inputs(cfg)
    model.zero_grad(set_to_none=True)
    w_sub, w_obj = (torch.from_numpy(w) for w in box_weights(cfg))
    box_loss(model(*(torch.from_numpy(a) for a in x[:2])), w_sub, w_obj, "torch").backward()
    got = model.refpoint_embed.weight.grad
    assert got.abs().max() > 0
    close(got, jax_outputs[2], GRAD_ATOL, "refpoint_embed grad")
    model.zero_grad(set_to_none=True)


def test_factory_builds_both_variants_as_jax():
    for v in ("parse_dab_detr", "rlip_mdetr"):
        cfg = tiny_config(variant=v)
        assert type(build_model(cfg)).__name__ == type(jax_build_model(cfg)).__name__
    with pytest.raises(ValueError, match="verb_curing"):
        build_model(tiny_config(variant="rlip_mdetr", verb_curing=True))
