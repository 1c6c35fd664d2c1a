"""The port's closed-vocabulary HOI zoo (`models/closed_vocab.py`) against
the JAX package's, float32 on the CPU, from numpy seeds:
  * each of the 13 variants' forward within 2e-3 from the JAX params
    carried by `state_dict_from_jax` (strict load, every JAX leaf in one
    port tensor), at batch 2 in a 200 x 168 bucket with a padded image
    whose stride-32 map has fewer real locations than queries, so
    DETRHOIhm's top-k takes padded locations that tie at -1 (the port
    breaks ties by index, as `lax.top_k`), and QAHOI two-stage's
    proposals on the padding are dropped; every output the JAX model gives
    (`verb_kl_divergence`, `ref_points`, `verb_hm`, `enc_outputs` too);
  * the stochastic variant on shared draws: the same numpy normals go to
    the port's `eps=` and, patched in for `jax.random.normal`, to the JAX
    model; apart from that, the draws' generator moves the verb logits and
    nothing of the deterministic part;
  * the new modules within 1e-3 on params of the models' trees: the DAB
    decoder without box refinement (ParSe-DAB-DDETR's verb decoder, MSDA
    inside), the plain decoder on 4-d proposal boxes (QAHOI two-stage's),
    OCN's semantic graph, cross-modal and bilinear layers, the two-stage
    proposals and the deformable conv's bilinear taps;
  * `build_model` for every variant against the JAX factory's class, the
    OCN and Coupled priors as buffers that take no gradient, and the CLI's
    refusal of the zoo.
The JAX side runs flax's GroupNorm with its two-pass variance
(`use_fast_variance=False`), as `tests/test_torch_train.py::jax_loss_and_grads`
does: the port's `models/layers.py::GroupNorm` centres first, and flax's
default one-pass float32 moments drift on the deformable models' mostly
padded maps. One jit at XLA's cheapest level computes the 13 JAX
forwards, another the module outputs."""

import dataclasses
import functools
from unittest import mock

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlipv2_tpu.models import closed_vocab as jax_cv
from rlipv2_tpu.models.dab_decoder import DABHOIDecoder as JaxDABHOIDecoder
from rlipv2_tpu.models.factory import build_model as jax_build_model
from rlipv2_tpu_torch import cli
from rlipv2_tpu_torch.engine import convert
from rlipv2_tpu_torch.engine.convert import state_dict_from_jax
from rlipv2_tpu_torch.models import closed_vocab
from rlipv2_tpu_torch.models.dab_decoder import DABHOIDecoder
from rlipv2_tpu_torch.models.factory import CLOSED_VOCAB_VARIANTS, build_model
from test_parseda_forward import tiny_config
from test_torch_parse import close, to_torch
from test_torch_parsed import FAST_COMPILE, _leaf_count, _port_count
from test_torch_parseda import random_params

torch.set_num_threads(2)

MODULE_ATOL, MODEL_ATOL = 1e-3, 2e-3
BATCH, BUCKET = 2, (200, 168)  # a stride-32 map of 7 x 6
# image 0 real on [0, 64) x [0, 96): 2 x 3 = 6 real map locations against
# tiny_config's 16 queries; image 1 on [0, 180) x [0, 150)
REAL = ((64, 96), (180, 150))
SAMPLING = jax_cv.StochasticDETRHOIModel.sampling_num
PRIORS = ("verb_word_embedding", "obj_verb_co")


def config(variant: str):
    extra = dict(two_stage=True, two_stage_num_proposals=12) if variant == "qahoi_two_stage" else {}
    return dataclasses.replace(tiny_config(variant=variant), **extra)


def model_inputs(seed=1):
    rng = np.random.RandomState(seed)
    pixels = rng.randint(0, 256, (BATCH, *BUCKET, 3)).astype(np.uint8)
    valid = np.zeros((BATCH, *BUCKET), bool)
    for b, (h, w) in enumerate(REAL):
        valid[b, :h, :w] = True
    return pixels, valid


def draws(cfg, seed=7):
    """The stochastic variant's normals: (SAMPLING, layers, B, nq, C)."""
    t = cfg.transformer
    shape = (SAMPLING, t.dec_layers, BATCH, cfg.num_queries, t.hidden_dim)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def two_pass_group_norm():
    return mock.patch.object(flax.linen, "GroupNorm", functools.partial(flax.linen.GroupNorm,
                                                                       use_fast_variance=False))


def port_forward(model, variant, **kw):
    x = [torch.from_numpy(a) for a in model_inputs()]
    if variant == "stochastic_detr_hoi":
        kw.setdefault("eps", torch.from_numpy(draws(model.cfg)))
    with torch.no_grad():
        return model(*x, **kw)


@pytest.fixture(scope="module")
def zoo():
    """{variant: (cfg, JAX model, seeded JAX params, port model)}."""
    out = {}
    for i, v in enumerate(CLOSED_VOCAB_VARIANTS):
        cfg = config(v)
        jm = jax_build_model(cfg)
        rngs = {"params": jax.random.PRNGKey(0), "stochastic": jax.random.PRNGKey(1)}
        params = random_params(lambda jm=jm: jm.init(rngs, jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 64, 64), bool)),
                               seed=20 + i)
        out[v] = (cfg, jm, params, to_torch(build_model(cfg), state_dict_from_jax(params, cfg)))
    return out


@pytest.fixture(scope="module")
def jax_outputs(zoo):
    """Every variant's JAX forward on `model_inputs`, in one jit; the
    stochastic one's normals are `draws`."""
    pixels, valid = (jnp.asarray(a) for a in model_inputs())
    eps = jnp.asarray(draws(zoo["stochastic_detr_hoi"][0]))

    def run(params):
        return {v: zoo[v][1].apply(params[v], pixels, valid) for v in CLOSED_VOCAB_VARIANTS}

    params = {v: zoo[v][2] for v in CLOSED_VOCAB_VARIANTS}
    with two_pass_group_norm(), mock.patch.object(jax.random, "normal", lambda key, shape, dtype: eps):
        return jax.jit(run).lower(params).compile(compiler_options=FAST_COMPILE)(params)


def assert_tree_close(got, want, atol, path=""):
    """Every array of the JAX output tree against the port's, keys and
    list lengths equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_tree_close(got[k], want[k], atol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, atol, f"{path}/{i}")
    elif np.asarray(want).dtype == bool:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)
    else:
        close(got, want, atol, path)


@pytest.mark.parametrize("variant", CLOSED_VOCAB_VARIANTS)
def test_model_matches_jax(zoo, jax_outputs, variant):
    cfg, _, params, model = zoo[variant]
    assert _leaf_count(params) == _port_count(model)
    got, want = port_forward(model, variant), jax_outputs[variant]
    nq = min(cfg.num_queries, cfg.two_stage_num_proposals) if cfg.two_stage else cfg.num_queries
    nq //= 2 if variant in ("sep_detr_hoi", "sep_ddetr_hoi_v3", "parse_dab_ddetr") else 1
    assert got["pred_obj_logits"].shape == (BATCH, nq, cfg.max_obj_texts)
    assert got["pred_verb_logits"].shape == (BATCH, nq, cfg.max_verb_texts)
    assert len(got["aux_outputs"]) == cfg.transformer.dec_layers - 1
    assert_tree_close(got, want, MODEL_ATOL)


def test_heatmap_top_k_takes_tied_padded_locations(zoo, jax_outputs):
    """DETRHOIhm on the padded image: 6 real locations of 42 for 16
    queries, so 10 queries sit at padded locations whose scores tie at -1;
    the heatmap and padding equal JAX's, and the decoder states they seed
    (the outputs, held in `test_model_matches_jax`) follow from the same
    ties broken by index."""
    got = port_forward(zoo["detr_hoi_hm"][3], "detr_hoi_hm")
    hm, pad = got["verb_hm"]
    assert hm.shape == (BATCH, 1, 7, 6) and int((~pad[0]).sum()) == 6
    want_hm, want_pad = jax_outputs["detr_hoi_hm"]["verb_hm"]
    close(hm, want_hm, MODULE_ATOL, "verb_hm")
    np.testing.assert_array_equal(pad.numpy(), np.asarray(want_pad))
    scores = torch.where(~pad.reshape(BATCH, -1), hm.amax(1).reshape(BATCH, -1), -1.0)
    first = closed_vocab.top_k_lower_index_first(scores, 16)[0]
    padded = first[scores[0, first] == -1.0]
    assert len(padded) == 10 and torch.equal(padded, torch.sort(padded).values)
    assert torch.equal(padded, torch.nonzero(pad[0].reshape(-1))[:10, 0])


def test_stochastic_generator_moves_only_the_verb_draws(zoo):
    """Without `eps` the draws come from the generator: two generators of
    one seed give the same outputs, another seed other verb logits and the
    same deterministic part (object logits, boxes, KL)."""
    model = zoo["stochastic_detr_hoi"][3]
    a, b, c = (port_forward(model, "stochastic_detr_hoi", eps=None, generator=torch.Generator().manual_seed(s))
               for s in (3, 3, 4))
    assert torch.equal(a["pred_verb_logits"], b["pred_verb_logits"])
    assert not torch.allclose(a["pred_verb_logits"], c["pred_verb_logits"])
    for k in ("pred_obj_logits", "pred_sub_boxes", "pred_obj_boxes", "verb_kl_divergence"):
        assert torch.equal(a[k], c[k]), k
    # no generator: the generator seeded 0, never the global state
    torch.manual_seed(123)
    d = port_forward(model, "stochastic_detr_hoi", eps=None)
    e = port_forward(model, "stochastic_detr_hoi", eps=None, generator=torch.Generator().manual_seed(0))
    assert torch.equal(d["pred_verb_logits"], e["pred_verb_logits"])


# ---------------------------------------------------------------- modules


LEVELS = ((13, 11), (7, 6), (4, 3), (2, 2))


def module_inputs(cfg, seed=3):
    rng = np.random.RandomState(seed)
    t = cfg.transformer
    S = sum(h * w for h, w in LEVELS)
    np_ = cfg.num_queries // 2
    valid = np.ones((BATCH, S), bool)
    valid[0, 100:] = False
    return {
        "tgt": rng.randn(BATCH, np_, t.hidden_dim).astype(np.float32),
        "qpos": rng.randn(BATCH, np_, t.hidden_dim).astype(np.float32),
        "sub": rng.uniform(0.2, 0.8, (BATCH, np_, 4)).astype(np.float32),
        "obj": rng.uniform(0.2, 0.8, (BATCH, np_, 4)).astype(np.float32),
        "memory": rng.randn(BATCH, S, t.hidden_dim).astype(np.float32),
        "ratios": rng.uniform(0.5, 1.0, (BATCH, len(LEVELS), 2)).astype(np.float32),
        "valid": valid,
        "words": rng.randn(cfg.max_verb_texts, 300).astype(np.float32),
        "states": rng.randn(2, BATCH, cfg.num_queries, t.hidden_dim).astype(np.float32),
        "x": rng.randn(BATCH, 5, 4, t.hidden_dim).astype(np.float32),
        "py": rng.uniform(-2, 6, (BATCH, 5, 4)).astype(np.float32),
        "px": rng.uniform(-2, 5, (BATCH, 5, 4)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_modules(zoo):
    """Each case's (params, JAX output), the params a module of a model's
    seeded tree, all outputs in one jit at XLA's cheapest level."""
    cfg = zoo["parse_dab_ddetr"][0]
    t = cfg.transformer
    x = {k: jnp.asarray(v) for k, v in module_inputs(cfg).items()}
    dab = zoo["parse_dab_ddetr"][2]["params"]["verb_decoder_dab"]
    plain = zoo["qahoi_two_stage"][2]["params"]["decoder"]
    ocn = zoo["ocn"][2]["params"]
    params = {"dab": dab, "plain": plain, "graph": ocn["semantic_graph"], "cross": ocn["cross_att"],
              "intra": ocn["vision_intra"]}

    def run(p):
        dec = dict(src=x["memory"], spatial_shapes=LEVELS, valid_ratios=x["ratios"], src_valid_mask=x["valid"])
        return {
            "dab": JaxDABHOIDecoder(t, parse=False, use_dab=True, refine_boxes=False).apply(
                {"params": p["dab"]}, x["tgt"], x["sub"], x["obj"], **dec),
            "plain": JaxDABHOIDecoder(t, parse=False, use_dab=False, refine_boxes=False).apply(
                {"params": p["plain"]}, x["tgt"], x["sub"], x["sub"], **dec, query_pos_in=x["qpos"]),
            "graph": jax_cv.SemanticGraph(t.hidden_dim, 1).apply({"params": p["graph"]}, x["words"]),
            "cross": jax_cv._MHCrossAttLayer(t.hidden_dim, 2).apply({"params": p["cross"]}, x["states"],
                                                                    x["states"][::-1]),
            "intra": jax_cv._BilinearTransformerLayer(t.hidden_dim, 2).apply({"params": p["intra"]}, x["states"]),
            "proposals": jax_cv.gen_encoder_output_proposals(x["memory"], x["valid"], LEVELS),
            "taps": jax_cv._bilinear_sample_2d(x["x"], x["py"], x["px"]),
        }

    outs = jax.jit(run).lower(params).compile(compiler_options=FAST_COMPILE)(params)
    return cfg, params, outs


def port_args(cfg):
    x = {k: torch.from_numpy(v) for k, v in module_inputs(cfg).items()}
    return x, (x["memory"], LEVELS, x["ratios"], x["valid"])


def test_dab_decoder_without_refinement_matches_jax(jax_modules):
    cfg, params, outs = jax_modules
    x, mem = port_args(cfg)
    dec = to_torch(DABHOIDecoder(cfg.transformer, parse=False, use_dab=True, refine_boxes=False),
                   convert.dab_decoder(params["dab"], cfg.transformer.dec_layers))
    with torch.no_grad():
        got = dec(x["tgt"], x["sub"], x["obj"], *mem)
    assert not hasattr(dec, "sub_bbox_embed") and set(got) == {"hs", "sub_refs", "obj_refs"}
    for k in got:
        close(got[k], outs["dab"][k], MODULE_ATOL, k)
    assert torch.equal(got["sub_refs"][-1], x["sub"])  # the anchors stay as they came


def test_plain_decoder_on_4d_boxes_matches_jax(jax_modules):
    cfg, params, outs = jax_modules
    x, mem = port_args(cfg)
    sd = {}
    for i in range(cfg.transformer.dec_layers):
        sd.update(convert.decoder_layer(convert._unstack(params["plain"]["layers"], i)["layer"], f"layers.{i}"))
    dec = to_torch(DABHOIDecoder(cfg.transformer, parse=False, use_dab=False), sd)
    with torch.no_grad():
        got = dec(x["tgt"], x["sub"], x["sub"], *mem, query_pos=x["qpos"])
    close(got["hs"], outs["plain"]["hs"], MODULE_ATOL)


def test_ocn_modules_match_jax(jax_modules):
    cfg, params, outs = jax_modules
    x, _ = port_args(cfg)
    d = cfg.transformer.hidden_dim
    cases = {"graph": (closed_vocab.SemanticGraph(300, d, 1), (x["words"],)),
             "cross": (closed_vocab._MHCrossAttLayer(d, 2), (x["states"], x["states"].flip(0))),
             "intra": (closed_vocab._BilinearTransformerLayer(d, 2), (x["states"],))}
    for name, (module, args) in cases.items():
        with torch.no_grad():
            got = to_torch(module, convert.named_leaves(params[name], "m"), "m.")(*args)
        for i, (g, w) in enumerate(zip(*(o if isinstance(o, tuple) else (o,) for o in (got, outs[name])))):
            close(g, w, MODULE_ATOL, f"{name}/{i}")


def test_two_stage_proposals_and_taps_match_jax(jax_modules):
    cfg, _, outs = jax_modules
    x, _ = port_args(cfg)
    mem, prop, keep = closed_vocab.gen_encoder_output_proposals(x["memory"], x["valid"], LEVELS)
    want_mem, want_prop, want_keep = (np.asarray(a) for a in outs["proposals"])
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert 0 < keep.sum() < keep.numel()
    np.testing.assert_array_equal(np.isinf(prop.numpy()), np.isinf(want_prop))
    close(prop[keep], want_prop[want_keep], 1e-5, "proposals")
    close(mem, want_mem, 0.0, "memory")
    got = closed_vocab.bilinear_taps(x["x"], x["py"][:, None], x["px"][:, None])[:, 0]
    close(got, outs["taps"], 1e-5, "taps")


# ---------------------------------------------------------------- factory, buffers, CLI


@pytest.mark.parametrize("variant", CLOSED_VOCAB_VARIANTS)
def test_build_model_builds_the_jax_class(variant):
    cfg = config(variant)
    assert type(build_model(cfg)).__name__ == type(jax_build_model(cfg)).__name__
    with pytest.raises(ValueError, match="no R-Tagger"):
        build_model(cfg, tagger=True)
    with pytest.raises(NotImplementedError, match="subject_class"):
        build_model(dataclasses.replace(cfg, subject_class=True))


@pytest.mark.parametrize("variant", ["ocn", "coupled_detr_hoi"])
def test_priors_are_buffers_without_gradient(zoo, variant):
    """The word table and co-occurrence prior load as buffers, never
    parameters; a backward through every output leaves them without
    gradient while the heads take one."""
    model = zoo[variant][3]
    owner = model if variant == "ocn" else model.transformer
    names = dict(model.named_parameters())
    assert not any(k.endswith(PRIORS) for k in names)
    for k in PRIORS:
        assert k in dict(owner.named_buffers(recurse=False)) and not getattr(owner, k).requires_grad
    x = [torch.from_numpy(a) for a in model_inputs()]
    model.zero_grad(set_to_none=True)
    out = model(*x)
    (out["pred_verb_logits"].square().sum() + out["pred_obj_boxes"].sum()).backward()
    assert all(getattr(owner, k).grad is None for k in PRIORS)
    assert float(model.verb_class_embed.weight.grad.abs().sum()) > 0


def test_cli_refuses_the_zoo():
    args = cli.get_parser().parse_args([])
    args.variant = "cdn"
    with pytest.raises(NotImplementedError, match="closed-vocabulary zoo takes no text.*item 20"):
        cli.check_ported(args)


def test_evaluation_columns_keep_the_split_and_no_object():
    """A 96-column object head and 160 verb columns read by a split of 81
    object slots (80 classes + no-object) and 117 verbs: the post-process
    of the kept columns equals the JAX one's with slot masks over them."""
    rng = np.random.RandomState(0)
    out = {"pred_obj_logits": torch.from_numpy(rng.randn(2, 4, 96).astype(np.float32)),
           "pred_verb_logits": torch.from_numpy(rng.randn(2, 4, 160).astype(np.float32)),
           "pred_sub_boxes": torch.full((2, 4, 4), 0.5), "pred_obj_boxes": torch.full((2, 4, 4), 0.5)}
    out["aux_outputs"] = [dict(out)]
    cut = closed_vocab.evaluation_columns(out, 81, 117)
    assert cut["pred_obj_logits"].shape == (2, 4, 81) and cut["aux_outputs"][0]["pred_verb_logits"].shape == (2, 4, 117)
    masked = out["pred_obj_logits"].clone()
    masked[..., 80:95] = -1e9
    want = torch.softmax(masked, -1)[..., :80]
    torch.testing.assert_close(torch.softmax(cut["pred_obj_logits"], -1)[..., :80], want, rtol=0, atol=1e-7)
    assert torch.equal(cut["pred_obj_logits"][..., -1], out["pred_obj_logits"][..., -1])
