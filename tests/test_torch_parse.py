"""The port's RLIPv1 model family against the JAX package's, float32 on the
CPU, from numpy seeds:
  * modules within 1e-3: the dense EncoderLayer, DecoderLayer, FusionEncoder with padded text slots, VanillaALIFEncoder
    in its three `multi_lang` branches, and the plain DeformableEncoder
    (RLIP-ParSeD v1's), each on seeded params of its JAX init converted by
    `engine/convert.py`, with padded keys;
  * whole models within 2e-3 through `state_dict_from_jax`: `rlip_parse`
    (`parse` builds the same class in both factories), `rlip_parse_v2`,
    `rlip_parsed` and `rlip_parse_v1_joint` (its `return_states` text
    states too) at batch 2 in the 61 x 83 bucket,
    whose valid widths 57 and 70 are not multiples of 32, with a padded text
    slot; every JAX leaf counted into one port tensor;
  * one train step of `rlip_parse_v2` with online pseudo verbs, which read
    the dense ALIF encoder's `lang_states`, against `jax.value_and_grad`;
  * the trained set and optimizer groups of `rlip_parse` and
    `rlip_parse_v2` in each freeze regime, and of `rlip_parsed` in those
    that name its encoder or decoders, against the labels the JAX
    `build_optimizer` gives; the factory's map against the JAX factory's;
    the guards of the ParSe variants (no tagger, no online pseudo verbs, no
    loading of another query count).
One jit at XLA's cheapest optimisation level computes the JAX forwards and
the value_and_grad, so each model compiles once; another the module
outputs, the layers of the models' trees among their params."""

import dataclasses
import random
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlipv2_tpu.config import FusionConfig, LossConfig as JaxLossConfig, TrainConfig as JaxTrainConfig
from rlipv2_tpu.engine.optim import build_optimizer as jax_build_optimizer
from rlipv2_tpu.losses.criterion import SetCriterionHOI as JaxCriterion
from rlipv2_tpu.losses.pseudo_verb import pseudo_verb_similarity as jax_pseudo_verb_similarity
from rlipv2_tpu.models import deformable as jax_deformable
from rlipv2_tpu.models import parse as jax_parse
from rlipv2_tpu.models.factory import build_model as jax_build_model
from rlipv2_tpu.models.parseda import init_model_params
from rlipv2_tpu.structures import HOITargets as JaxTargets
from rlipv2_tpu_torch.config import LossConfig, TrainConfig
from rlipv2_tpu_torch.data.pipeline import build_train_batch
from rlipv2_tpu_torch.engine import convert
from rlipv2_tpu_torch.engine.convert import load_reference_checkpoint, state_dict_from_jax
from rlipv2_tpu_torch.engine.optim import FREEZE_REGIMES, build_optimizer
from rlipv2_tpu_torch.engine.train import make_train_step
from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
from rlipv2_tpu_torch.models import deformable, parse
from rlipv2_tpu_torch.models.factory import MODEL_CLASSES, PORTED_VARIANTS, build_model
from test_parseda_forward import tiny_config
from test_torch_parsed import FAST_COMPILE, _leaf_count, _port_count
from test_torch_parseda import random_params
from test_torch_swin_train import JAX_ONLY_FROZEN, LRS
from test_torch_train import BATCH as TRAIN_BATCH, M, SEED, torch_batch, train_dataset

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

MODULE_ATOL, MODEL_ATOL = 1e-3, 2e-3
OUT_KEYS = ("pred_obj_logits", "pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes")
BATCH, BUCKET = 2, (61, 83)
N_OBJ = 5  # tiny_config: 5 object and 7 verb slots
VARIANTS = ("rlip_parse", "rlip_parse_v2", "rlip_parsed", "rlip_parse_v1_joint")
REGIMES = (None,) + FREEZE_REGIMES
# the regimes each CLI variant's freeze rules are checked in: frozen_vision
# and unfrozen_params name only the backbone and the text encoder, whose
# names the ParSe models share with RLIP-ParSeD
FREEZE_CASES = [(v, r) for v in ("rlip_parse", "rlip_parse_v2") for r in REGIMES] + [
    ("rlip_parsed", None), ("rlip_parsed", "frozen_detection")]


def config(variant: str, **kw):
    return dataclasses.replace(tiny_config(variant=variant), **kw)


def to_torch(module, sd: dict, prefix: str = ""):
    """`module` with the converted state dict `sd` (its keys under `prefix`)
    loaded strictly, in eval mode."""
    state = {k[len(prefix):]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    module.load_state_dict(state, strict=True)
    return module.eval()


def close(got, want, atol, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0, err_msg=what)


# ---------------------------------------------------------------- modules


def tokens(seed, B=2, S=12, T=6, d=64, l_dim=32):
    """Seeded tokens, positions and text with padded keys and text slots."""
    rng = np.random.RandomState(seed)
    valid = np.ones((B, S), bool)
    valid[0, 7:] = False
    text_valid = np.ones((B, T), bool)
    text_valid[:, 2] = False
    text_valid[1, 4:] = False
    return {"x": rng.randn(B, S, d).astype(np.float32), "pos": rng.randn(B, S, d).astype(np.float32),
            "valid": valid, "queries": rng.randn(B, 5, d).astype(np.float32),
            "text": rng.randn(B, T, d).astype(np.float32), "text_valid": text_valid,
            "lang": rng.randn(B, T, l_dim).astype(np.float32)}


def alif_config(lang_aux_loss: bool, interval: int):
    """enc_layers 3: fusions before layers 0 and 2 (interval 2; 3 with
    interval 1, of which every other state is stacked)."""
    base = tiny_config()
    fusion = dataclasses.replace(base.transformer.fusion, lang_aux_loss=lang_aux_loss, fusion_interval=interval)
    return dataclasses.replace(base, transformer=dataclasses.replace(base.transformer, enc_layers=3, fusion=fusion))


ALIF_CASES = {"stacked": (True, 2), "every_other": (True, 1), "last": (False, 2)}
LEVELS = ((6, 8), (3, 4), (2, 2), (1, 1))


def level_masks():
    """Per-level validity of a padded image and a full one."""
    masks = []
    for h, w in LEVELS:
        m = np.ones((2, h, w), bool)
        m[0, (h + 1) // 2 + 1:, :] = False
        if w > 1:
            m[0, :, w - 1:] = False
        masks.append(m)
    return masks


def module_cases():
    """{case: (JAX module, its inputs as numpy arrays, static inputs
    appended after them)}, each case with its own seed of inputs."""
    cfg = tiny_config()
    a = [tokens(i) for i in range(5)]
    rng = np.random.RandomState(8)
    S = sum(h * w for h, w in LEVELS)
    masks = level_masks()
    ratios = np.asarray(jax_deformable.compute_valid_ratios([jnp.asarray(m) for m in masks]))
    deform = (rng.randn(2, S, 64).astype(np.float32), ratios, rng.randn(2, S, 64).astype(np.float32),
              np.concatenate([m.reshape(2, -1) for m in masks], 1))
    cases = {
        "encoder": (jax_parse.EncoderLayer(cfg), (a[0]["x"], a[0]["pos"], a[0]["valid"])),
        "decoder": (jax_parse.DecoderLayer(cfg), (a[2]["queries"], a[2]["queries"][::-1].copy(), a[2]["x"],
                                                  a[2]["pos"], a[2]["valid"])),
        "fusion": (jax_parse.FusionEncoder(cfg, 2), (a[3]["queries"], a[3]["text"], a[3]["text_valid"])),
        "deformable": (jax_deformable.DeformableEncoder(cfg.transformer), deform),
    }
    for name, (aux, interval) in ALIF_CASES.items():
        cases[name] = (jax_parse.VanillaALIFEncoder(alif_config(aux, interval)),
                       (a[4]["x"], a[4]["pos"], a[4]["valid"], a[4]["lang"], a[4]["text_valid"]))
    return cases


def _apply_args(name, args):
    """The deformable encoder's call order: src, spatial shapes (static),
    valid ratios, pos, valid mask."""
    return (args[0], LEVELS, *args[1:]) if name == "deformable" else args


# the module cases whose params are a layer of a model's seeded tree:
# case: (variant, the layer's key)
FROM_MODELS = {"encoder": ("rlip_parse", "enc_0"), "decoder": ("rlip_parse", "ho_dec_0"),
               "fusion": ("rlip_parse", "obj_fusion"), "deformable": ("rlip_parsed", "encoder")}


@pytest.fixture(scope="module")
def jax_modules(pairs):
    """{case: (seeded params, inputs, JAX output)}: each module's params a
    layer of a model's (FROM_MODELS) or drawn for its init's shapes, every
    output in one jit at XLA's cheapest level."""
    cases = module_cases()
    params = {}
    for i, (n, (m, a)) in enumerate(cases.items()):
        if n in FROM_MODELS:
            v, key = FROM_MODELS[n]
            params[n] = {"params": pairs[v][2]["params"][key]}
        else:
            params[n] = random_params(lambda m=m, a=a, n=n: m.init(jax.random.PRNGKey(0), *_apply_args(n, a)), seed=i)

    def run(ps):
        return {n: m.apply(ps[n], *_apply_args(n, a)) for n, (m, a) in cases.items()}

    outs = jax.jit(run).lower(params).compile(compiler_options=FAST_COMPILE)(params)
    return {n: (params[n]["params"], cases[n][1], outs[n]) for n in cases}


def run_port(module, sd, args, prefix=""):
    with torch.no_grad():
        return to_torch(module, sd, prefix)(*(torch.from_numpy(np.ascontiguousarray(x))
                                              if isinstance(x, np.ndarray) else x for x in args))


def test_encoder_layer_matches_jax(jax_modules):
    p, args, want = jax_modules["encoder"]
    got = run_port(parse.EncoderLayer(tiny_config().transformer), convert.dense_encoder_layer(p, "m"), args, "m.")
    close(got, want, MODULE_ATOL)


def test_decoder_layer_matches_jax(jax_modules):
    p, args, want = jax_modules["decoder"]
    got = run_port(parse.DecoderLayer(tiny_config().transformer), convert.dense_decoder_layer(p, "m"), args, "m.")
    close(got, want, MODULE_ATOL)


def test_fusion_encoder_matches_jax_with_padded_text(jax_modules):
    p, args, want = jax_modules["fusion"]
    sd = {}
    for i in range(2):
        sd.update(convert.dense_encoder_layer(p[f"layer_{i}"], f"layers.{i}"))
    got = run_port(parse.FusionEncoder(tiny_config().transformer, 2), sd, args)
    for g, w, half in zip(got, want, ("queries", "text")):
        close(g, w, MODULE_ATOL, half)


@pytest.mark.parametrize("case", sorted(ALIF_CASES))
def test_vanilla_alif_encoder_matches_jax(jax_modules, case):
    aux, interval = ALIF_CASES[case]
    cfg = alif_config(aux, interval)
    p, args, (want_x, want_lang) = jax_modules[case]
    got_x, got_lang = run_port(parse.VanillaALIFEncoder(cfg.transformer, cfg.text_encoder),
                               convert.vanilla_alif_encoder(p, 3, interval), args)
    assert got_lang.shape == want_lang.shape == ((2,) if aux else ()) + args[3].shape
    close(got_x, want_x, MODULE_ATOL, "visual")
    close(got_lang, want_lang, MODULE_ATOL, "language")


def test_plain_deformable_encoder_matches_jax(jax_modules):
    """RLIP-ParSeD v1's encoder over four levels of a padded image's masks
    (valid ratios equal in both packages)."""
    t = tiny_config().transformer
    p, args, want = jax_modules["deformable"]
    np.testing.assert_array_equal(
        deformable.compute_valid_ratios([torch.from_numpy(m) for m in level_masks()]).numpy(), args[1])
    sd = {}
    for i in range(t.enc_layers):
        sd.update(convert.encoder_layer(convert._unstack(p["layers"], i), f"layers.{i}"))
    got = run_port(deformable.DeformableEncoder(t), sd, _apply_args("deformable", args))
    close(got, want, MODULE_ATOL)


# ---------------------------------------------------------------- whole models


def jax_params(cfg, seed: int):
    """(JAX model of `cfg.variant`, seeded params of its init), the text
    encoder's too where the model has one."""
    jm = jax_build_model(cfg)
    T = cfg.max_obj_texts + cfg.max_verb_texts
    args = (jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 64, 64), bool),
            jnp.zeros((1, T, cfg.text_encoder.hidden_size)), jnp.ones((1, T), bool), cfg.max_obj_texts)
    if hasattr(jm, "encode_text"):
        init = lambda: init_model_params(jm, jax.random.PRNGKey(0), *args, jnp.ones((2, 6), jnp.int32),  # noqa: E731
                                         jnp.ones((2, 6), jnp.int32))
    else:
        init = lambda: jm.init(jax.random.PRNGKey(0), *args)  # noqa: E731
    return jm, random_params(init, seed)


def port_model(cfg, params):
    return to_torch(build_model(cfg), state_dict_from_jax(params, cfg))


def model_inputs(cfg, seed=1):
    rng = np.random.RandomState(seed)
    B, (H, W) = BATCH, BUCKET
    pixels = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    valid = np.ones((B, H, W), bool)
    valid[0, 40:, :] = False
    valid[0, :, 57:] = False
    valid[1, :, 70:] = False
    T = cfg.max_obj_texts + cfg.max_verb_texts
    text = rng.randn(B, T, cfg.text_encoder.hidden_size).astype(np.float32)
    text_valid = np.ones((B, T), bool)
    text_valid[:, 3] = False
    text_valid[1, T - 2:] = False
    return pixels, valid, text, text_valid


def train_arrays(cfg):
    """A train batch of the synthetic HICO split (61 x 83 bucket) with text
    features, as the port's and JAX's steps take it."""
    rng = np.random.RandomState(SEED)
    T = cfg.max_obj_texts + cfg.max_verb_texts
    ds = train_dataset()
    arrays, _, _ = build_train_batch([ds[i] for i in range(TRAIN_BATCH)], cfg.max_obj_texts, cfg.max_verb_texts,
                                     M, rng=random.Random(SEED))
    arrays["text_emb"] = rng.randn(TRAIN_BATCH, T, cfg.text_encoder.hidden_size).astype(np.float32)
    arrays["text_valid"] = np.concatenate([arrays["obj_text_valid"], arrays["verb_text_valid"]], 1)
    # pad the second image's last verb slot that no GT pair holds
    unused = np.flatnonzero(~arrays["verb_labels"].any(axis=(0, 1)))
    arrays["text_valid"][1, cfg.max_obj_texts + unused[-1]] = False
    return arrays


def train_config():
    return config("rlip_parse_v2", pseudo_verb=True, pseudo_verb_mode="online")


def inputs(variant, arrays):
    """A forward's (pixels, valid, text, text_valid): `model_inputs`, or for
    `rlip_parse_v2` those of its train batch (`arrays`: images of 40-61 x
    50-83 padded into the 61 x 83 bucket, the slots its labels leave empty
    padded), whose forward the train step's value_and_grad gives."""
    if variant == "rlip_parse_v2":
        return tuple(arrays[k] for k in ("pixels", "pixel_valid", "text_emb", "text_valid"))
    return model_inputs(config(variant))


@pytest.fixture(scope="module")
def pairs():
    """{variant: (cfg, JAX model, JAX params, port model)} for VARIANTS."""
    out = {}
    for i, v in enumerate(VARIANTS):
        cfg = config(v)
        jm, params = jax_params(cfg, seed=10 + i)
        out[v] = (cfg, jm, params, port_model(cfg, params))
    return out


@pytest.fixture(scope="module")
def jax_outputs(pairs):
    """In one jit at XLA's cheapest level: each variant's forward on
    `model_inputs` (V1Joint with its states), and value_and_grad of the
    JAX step's loss (engine/train.py hoi_loss_fn: online pseudo verbs from
    the forward's stop-gradient lang_states) for `rlip_parse_v2` on
    `train_arrays`, dropout off."""
    cfg = train_config()
    arrays = train_arrays(cfg)
    n = cfg.max_obj_texts
    jm_train = pairs["rlip_parse_v2"][1]
    crit = JaxCriterion(JaxLossConfig(), pseudo_verb=True)
    tgt = JaxTargets(*(jnp.asarray(arrays[k]) for k in (
        "obj_labels", "sub_labels", "verb_labels", "sub_boxes", "obj_boxes", "triplet_valid")))
    tv = jnp.asarray(arrays["text_valid"])

    def loss_fn(p):
        out = jm_train.apply(p, *(jnp.asarray(a) for a in inputs("rlip_parse_v2", arrays)), n, deterministic=True)
        sim = jax_pseudo_verb_similarity(jax.lax.stop_gradient(out["lang_states"][0, n:]), tgt.verb_labels,
                                         tv[:, n:], metric="euclidean")
        losses = crit(out, tgt, tv[:, :n], tv[:, n:], target_verb_sim=sim)
        return crit.weighted_total(losses), (losses, out)

    # the train step's forward serves as rlip_parse_v2's
    forwards = [v for v in VARIANTS if v != "rlip_parse_v2"]

    def run(params):
        fwd = {}
        for v in forwards:
            kw = {"return_states": True} if v == "rlip_parse_v1_joint" else {}
            fwd[v] = pairs[v][1].apply(params[v], *(jnp.asarray(a) for a in inputs(v, arrays)), N_OBJ, **kw)
        return fwd, jax.value_and_grad(loss_fn, has_aux=True)(params["rlip_parse_v2"])

    params = {v: pairs[v][2] for v in forwards + ["rlip_parse_v2"]}
    fwd, ((total, (losses, fwd_v2)), grads) = jax.jit(run).lower(params).compile(compiler_options=FAST_COMPILE)(params)
    fwd["rlip_parse_v2"] = fwd_v2
    return fwd, (float(total), losses, grads), arrays


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_matches_jax(pairs, jax_outputs, variant):
    cfg, _, _, model = pairs[variant]
    want = jax_outputs[0][variant]
    x = inputs(variant, jax_outputs[2])
    assert not x[1].all() and not x[3].all()  # padded pixels and text slots
    kw = {"return_states": True} if variant == "rlip_parse_v1_joint" else {}
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in x), N_OBJ, **kw)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == cfg.transformer.dec_layers - 1
    for g, w in [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"])):
        for k in OUT_KEYS:
            close(g[k], w[k], MODEL_ATOL, k)
    # the JAX RLIPParSeD returns no lang_states; the port's returns its
    # encoder's language states, here the text features
    extra = {"rlip_parse_v2": ("verb_decoder_out", "lang_states"), "rlip_parsed": ("verb_decoder_out",)}
    port_only = ("lang_states",) if variant == "rlip_parsed" else ()
    assert set(got) - {"aux_outputs", "states"} == set(OUT_KEYS + extra.get(variant, ()) + port_only)
    for k in extra.get(variant, ()):
        close(got[k], want[k], MODEL_ATOL, k)
    if variant == "rlip_parse_v1_joint":
        assert got["states"]["text_states"].shape == (cfg.transformer.enc_layers, BATCH, x[2].shape[1], 64)
        for k in ("hs_ho", "hs_verb", "text_states"):
            close(got["states"][k], want["states"][k], MODEL_ATOL, k)
    if variant == "rlip_parsed":
        np.testing.assert_array_equal(got["lang_states"].numpy(), x[2])


@pytest.mark.parametrize("variant", VARIANTS)
def test_every_jax_leaf_lands_in_one_port_tensor(pairs, variant):
    cfg, _, params, model = pairs[variant]
    assert _leaf_count(params) == _port_count(model)
    names = set(model.state_dict())
    assert any(k.startswith("transformer.text_encoder.") for k in names) == (variant != "rlip_parse_v1_joint")
    if variant == "rlip_parsed":
        assert {k for k in names if k.startswith("transformer.encoder.") and ".layers." not in k} == set()
    if variant == "rlip_parse_v1_joint":
        assert "transformer.ho_decoder.layers.0.cross_attn_image.in_proj_weight" in names
        assert "transformer.verb_decoder.norm.weight" in names


def test_train_step_with_online_pseudo_verbs_matches_jax(pairs, jax_outputs):
    """`rlip_parse_v2`'s step through `make_train_step` (clip and learning
    rates off, dropout off): the loss terms within 1e-4 relative and every
    trainable parameter's gradient within 1e-3 * max|g| + 1e-6 of the JAX
    gradient mapped by `state_dict_from_jax`; the cached-text path gives the
    text encoder none (zeros in JAX)."""
    cfg = train_config()
    total, losses, jax_grads = jax_outputs[1]
    arrays = jax_outputs[2]
    model = port_model(cfg, pairs["rlip_parse_v2"][2])
    tcfg = TrainConfig(clip_max_norm=1e9, lr=0.0, lr_backbone=0.0, lr_text_encoder=0.0)
    opt, sched = build_optimizer(model, tcfg)
    step = make_train_step(model, SetCriterionHOI(LossConfig(), pseudo_verb=True), opt, sched, tcfg)
    metrics = step(torch_batch(arrays))
    np.testing.assert_allclose(float(metrics["loss"]), total, rtol=1e-4)
    for k in losses:
        np.testing.assert_allclose(float(metrics[k]), float(losses[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    want = state_dict_from_jax(jax_grads, cfg)
    checked = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        w = want[name]
        if p.grad is None:
            assert not np.any(w), name
            continue
        tol = 1e-3 * float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(p.grad.numpy(), w, atol=tol, rtol=0, err_msg=name)
        checked += 1
    assert checked > 100
    assert model.transformer.encoder.roberta_layers[0].output.dense.weight.grad is not None


# ------------------------------------------------- optimizer groups and guards


@pytest.fixture(scope="module")
def jax_labels(pairs):
    """{(variant, regime): the learning rate (0 where frozen) the JAX
    `build_optimizer` gives each leaf, as a reference-key state dict} for
    FREEZE_CASES. The labels are read where `build_optimizer`
    hands them to `optax.multi_transform`, without running an update (an
    eager one takes ~20 s a tree); `test_torch_swin_train.py` holds one
    jitted update to these labels."""
    out = {}
    for v, regime in FREEZE_CASES:
        cfg, _, params, _ = pairs[v]
        p = params["params"]
        seen = []

        def capture(transforms, labels, _real=optax.multi_transform, _seen=seen):
            _seen.append(labels)
            return _real(transforms, labels)

        with mock.patch.object(optax, "multi_transform", capture):
            jax_build_optimizer(JaxTrainConfig(freeze_regime=regime), p)
        lrs = jax.tree_util.tree_map(lambda lab, x: np.full(np.shape(x), LRS.get(lab, 0.0), np.float32), seen[0], p)
        out[v, regime] = state_dict_from_jax(lrs, cfg)
    return out


# The JAX frozen_detection regime freezes the top-level "encoder" and
# "ho_decoder" trees; the ParSe models name theirs enc_{i} and ho_dec_{i},
# so it trains them, where the reference's rule (transformer.encoder.,
# transformer.ho_decoder.) and the port freeze them (ROADMAP queue 3)
JAX_TRAINS_UNDER_FROZEN_DETECTION = {
    "rlip_parse": ("transformer.encoder.", "transformer.ho_decoder."),
    "rlip_parse_v2": ("transformer.ho_decoder.",),
    "rlip_parsed": (),
}


@pytest.mark.parametrize("variant,regime", FREEZE_CASES)
def test_trainable_parameters_and_groups_match_jax(pairs, jax_labels, variant, regime):
    cfg = pairs[variant][0]
    lrs = jax_labels[variant, regime]
    by_lr = {np.float32(lr): group for group, lr in LRS.items()}

    def jax_label(name):
        u = lrs[name]
        if not np.any(u):
            return "frozen"
        assert np.all(u == u.flat[0]), name
        return by_lr[u.flat[0]]

    model = build_model(cfg)
    opt, _ = build_optimizer(model, TrainConfig(freeze_regime=regime))
    group_of = {id(q): g["name"] for g in opt.param_groups for q in g["params"]}
    got = {k: group_of.get(id(q), "frozen") for k, q in model.named_parameters()}
    want = {k: jax_label(k) for k in got}
    differ = {k for k in got if got[k] != want[k]}
    known = {k for k in got if JAX_ONLY_FROZEN.fullmatch(k) and got[k] == "backbone"}
    assert all(want[k] == "frozen" for k in known)
    if regime == "frozen_detection":
        trained = {k for k in got if k.startswith(JAX_TRAINS_UNDER_FROZEN_DETECTION[variant])}
        assert all(got[k] == "frozen" and want[k] == "model" for k in trained)
        known |= trained
    assert differ == known, {k: (got[k], want[k]) for k in differ - known}
    trains = {"unfrozen_params": {"text_encoder"}, "frozen_detection": {"model", "text_encoder"}}
    assert set(got.values()) - {"frozen"} == trains.get(regime, {"backbone", "model", "text_encoder"})


def test_factory_maps_variants_as_jax():
    """Each ported variant builds the class of the JAX factory's name, so
    `parse` and `rlip_parse` one class in both; `rlip_parsed` is
    RLIP-ParSeD with the plain encoder in both; the others raise naming
    their ROADMAP item, and only the deformable variants build a tagger."""
    assert MODEL_CLASSES["parse"] is MODEL_CLASSES["rlip_parse"]
    assert type(jax_build_model(config("parse"))) is type(jax_build_model(config("rlip_parse")))
    for v in PORTED_VARIANTS:
        cfg = config(v)
        jm, model = jax_build_model(cfg), build_model(cfg)
        assert type(model).__name__ == type(jm).__name__, v
        assert model.cfg.transformer.fusion.fusion_type == jm.cfg.transformer.fusion.fusion_type, v
    assert isinstance(build_model(config("rlip_parsed")).transformer.encoder, deformable.DeformableEncoder)
    for v in ("qpic", "rlip_mdetr", "parse_dab_detr"):
        with pytest.raises(NotImplementedError, match="item 20"):
            build_model(config(v))
    for v in ("parse", "rlip_parse", "rlip_parse_v2", "rlip_parse_v1_joint"):
        with pytest.raises(ValueError, match="no R-Tagger"):
            build_model(config(v), tagger=True)
    assert build_model(config("rlip_parsed"), tagger=True).tagger


def test_mdetr_fusion_still_raises():
    """The JAX RLIPParSeDA quietly builds the plain encoder for MDETR_attn;
    the port raises, naming the ROADMAP item."""
    cfg = tiny_config()
    bad = dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, fusion=FusionConfig(embed_dim=64, num_heads=4, fusion_type="MDETR_attn")))
    with pytest.raises(NotImplementedError, match="MDETR_attn.*item 7"):
        build_model(bad)


@pytest.mark.parametrize("variant", ["rlip_parse", "rlip_parse_v1_joint"])
def test_online_pseudo_verbs_need_lang_states(variant):
    cfg = config(variant, pseudo_verb=True, pseudo_verb_mode="online")
    model = build_model(cfg)
    opt, sched = build_optimizer(model, TrainConfig())
    with pytest.raises(ValueError, match=f"variant {variant}.*lang_states"):
        make_train_step(model, SetCriterionHOI(LossConfig(), pseudo_verb=True), opt, sched, TrainConfig())
    offline = build_model(dataclasses.replace(cfg, pseudo_verb_mode="offline"))
    opt, sched = build_optimizer(offline, TrainConfig())
    make_train_step(offline, SetCriterionHOI(LossConfig(), pseudo_verb=True), opt, sched, TrainConfig())


def test_dense_query_embeddings_load_only_at_their_shape(tmp_path):
    """A RLIP-ParSe `.pth` loads strictly at the model's query count; at
    another its `query_embed` and `verb_query_embed` raise ValueError (the
    JAX query filter knows the DAB and RLIP-ParSeD embeddings only)."""
    cfg = config("rlip_parse")
    sd = build_model(cfg).state_dict()
    torch.save({"model": sd}, tmp_path / "parse.pth")
    model = build_model(cfg)
    load_reference_checkpoint(model, tmp_path / "parse.pth")
    assert torch.equal(model.verb_query_embed.weight, sd["verb_query_embed.weight"])
    half = {k: v[: v.shape[0] // 2] if k.endswith("query_embed.weight") else v for k, v in sd.items()}
    torch.save({"model": half}, tmp_path / "half.pth")
    with pytest.raises(ValueError, match="query_embed"):
        load_reference_checkpoint(build_model(cfg), tmp_path / "half.pth")
