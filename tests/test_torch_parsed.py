"""The port's RLIP-ParSeD against the JAX package's, in float32 on the CPU:
the tiny model's forward (the plain-deformable decoders with 2-d reference
points, the top-level box heads, the subject head, the aux layers) within
2e-3 through `state_dict_from_jax`, with every JAX leaf carried into one
port tensor, with and without the tagger's leaves; its R-Tagger's forward,
loss and gradients against `jax.value_and_grad` of the JAX
`tagger_loss_fn`'s body with both noise scales at 0, the port's side
through `make_train_step(tagger=True)`; the pseudo-relations of
`generate_pseudo_annotations` against the JAX function's (one jit computes
the JAX forward, the tagger step and the generation's tagger forwards, so
the tiny model compiles once); the model factory; and the warm start's
`query_embed` rule against the JAX `filter_query_embeddings`."""

import dataclasses
import functools
import random
from unittest import mock

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from PIL import Image

from rlipv2_tpu.config import LossConfig as JaxLossConfig
from rlipv2_tpu.engine.convert import filter_query_embeddings as jax_filter_query_embeddings
from rlipv2_tpu.losses.criterion import SetCriterionHOI as JaxCriterion
from rlipv2_tpu.models.parsed import RLIPParSeD as JaxRLIPParSeD
from rlipv2_tpu.models.parseda import RLIPParSeDA as JaxRLIPParSeDA
from rlipv2_tpu.models.parseda import init_model_params
from rlipv2_tpu.structures import HOITargets as JaxTargets
from rlipv2_tpu.tools import generate_relations as jax_gen
from rlipv2_tpu_torch.config import LossConfig, TrainConfig
from rlipv2_tpu_torch.data import vg
from rlipv2_tpu_torch.data.pipeline import build_train_batch
from rlipv2_tpu_torch.data.transforms import HOITransform
from rlipv2_tpu_torch.engine.convert import fit_query_embeddings, load_reference_checkpoint, state_dict_from_jax
from rlipv2_tpu_torch.engine.optim import build_optimizer
from rlipv2_tpu_torch.engine.train import TrainBatch, make_train_step
from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
from rlipv2_tpu_torch.models.factory import build_model
from rlipv2_tpu_torch.models.parsed import RLIPParSeD
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
from rlipv2_tpu_torch.structures import HOITargets
from rlipv2_tpu_torch.tools import generate_relations as gen
from rlipv2_tpu_torch.tools.vg_tree import write_vg_tree
from test_parseda_forward import tiny_config
from test_torch_generate_relations import (JaxView, assert_generated_match, datasets, fake_text_encoder, generate_config,
                                          write_generate_tree)
from test_torch_hico_data import smooth_image
from test_torch_parseda import random_params

torch.set_num_threads(2)

ATOL = 2e-3
OUT_KEYS = ("pred_obj_logits", "pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes", "pred_sub_logits")
BATCH, BUCKET = 2, (61, 83)
FORWARD_OBJ_TEXTS, FORWARD_VERB_TEXTS = 5, 7  # the forward test's text slots
FIELDS = ("obj_labels", "sub_labels", "verb_labels", "sub_boxes", "obj_boxes", "valid")
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def parsed_config(**kw):
    return dataclasses.replace(tiny_config(variant="rlip_parsed_v2", subject_class=True), **kw)


def jax_tree(cfg, include_tagger: bool, seed: int = 0):
    jm = JaxRLIPParSeD(cfg)
    T = cfg.max_obj_texts + cfg.max_verb_texts
    return jm, random_params(lambda: init_model_params(
        jm, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 64, 64), bool),
        jnp.zeros((1, T, cfg.text_encoder.hidden_size)), jnp.ones((1, T), bool),
        cfg.max_obj_texts, jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32),
        include_tagger=include_tagger), seed=seed)


def port_model(cfg, params, tagger: bool):
    model = RLIPParSeD(cfg, tagger=tagger)
    sd = state_dict_from_jax(params, cfg)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, strict=True)
    return model.eval()


def torch_targets(t):
    return HOITargets(*(torch.from_numpy(np.asarray(t[k])) for k in FIELDS))


def jax_targets(t):
    return JaxTargets(*(jnp.asarray(t[k]) for k in FIELDS))


def write_tagger_tree(root):
    """A VG file of six images over three PNGs, 40 object names and 20
    predicates: the tagger's data."""
    src = []
    for i, (h, w) in enumerate(((60, 80), (80, 60), (45, 70))):
        path = root / f"src_{i}.png"
        Image.fromarray(smooth_image(30 + i, h, w)).save(path)
        src.append((path, h, w))
    return write_vg_tree(root / "tree", src, n_images=(6, 0, 0), n_object_names=40, n_predicates=20, seed=5)


@pytest.fixture(scope="module")
def pair():
    """The tiny RLIP-ParSeD with text slots for the tagger batch's label
    spaces (the parameters do not depend on them), its JAX tree with the
    tagger's leaves, and the port model in eval mode."""
    cfg = parsed_config(max_obj_texts=48, max_verb_texts=24)
    jm, params = jax_tree(cfg, include_tagger=True, seed=4)
    return cfg, jm, params, port_model(cfg, params, tagger=True)


def inputs(cfg, seed=1):
    """The forward test's inputs, with FORWARD_OBJ_TEXTS + FORWARD_VERB_TEXTS text slots."""
    rng = np.random.RandomState(seed)
    B, (H, W) = BATCH, BUCKET
    pixels = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    valid = np.ones((B, H, W), bool)
    valid[0, 40:, :] = False
    valid[0, :, 57:] = False
    valid[1, :, 70:] = False
    T = FORWARD_OBJ_TEXTS + FORWARD_VERB_TEXTS
    text = rng.randn(B, T, cfg.text_encoder.hidden_size).astype(np.float32)
    text_valid = np.ones((B, T), bool)
    text_valid[:, 3] = False
    return pixels, valid, text, text_valid


def test_forward_matches_jax(pair, both):
    cfg, jm, params, model = pair
    x = inputs(cfg)
    want = both[0]
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in x), FORWARD_OBJ_TEXTS)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == cfg.transformer.dec_layers - 1
    for g, w in [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"])):
        for k in OUT_KEYS:
            assert np.isfinite(g[k].numpy()).all(), k
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), atol=ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["verb_decoder_out"].numpy(), np.asarray(want["verb_decoder_out"]), atol=ATOL,
                               rtol=0)
    # the 2-d reference points move the boxes: not all at the sigmoid of the heads alone
    assert float(got["pred_sub_boxes"].std()) > 0.01


# ------------------------------------------------ the R-Tagger's forward and step


def tagger_batch(cfg, tree):
    """One tagger batch as numpy arrays: two items of the tree, their
    targets padded to num_queries // 2 pair slots."""
    ds = vg.VGRelTaggerDataset(tree["vg_anno"], {"vg": tree["vg_folder"]}, num_queries=cfg.num_queries, seed=0,
                               device="cpu", transforms=HOITransform(True, scales=[48, 64], max_size=80,
                                                                     rng=random.Random(0)))
    arrays, _, _ = build_train_batch([ds[0], ds[1]], cfg.max_obj_texts, cfg.max_verb_texts,
                                     cfg.num_queries // 2, rng=random.Random(0), bucket=(64, 80))
    rng = np.random.RandomState(4)
    T = cfg.max_obj_texts + cfg.max_verb_texts
    arrays["text_emb"] = rng.randn(2, T, cfg.text_encoder.hidden_size).astype(np.float32)
    arrays["text_valid"] = np.concatenate([arrays["obj_text_valid"], arrays["verb_text_valid"]], 1)
    # the tree's images fill every slot: pad the second image's last three,
    # as `build_train_batch` pads an image with fewer pairs
    arrays["triplet_valid"][1, 5:] = False
    for k in ("obj_labels", "sub_labels", "verb_labels", "sub_boxes", "obj_boxes"):
        arrays[k][1, 5:] = 0
    arrays["valid"] = arrays["triplet_valid"]
    return arrays


class _NoJit:
    """The JAX generation module's `jax` with `jit` the identity, so that
    its model call sees the concrete batches it builds."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn):
        return fn


class _TaggerCalls:
    """Stands in for the JAX model in the JAX `generate_pseudo_annotations`:
    records each batch the function builds (pixels, mask, text features,
    text mask, targets, key, object slots) and answers the i-th with
    `verb_logits[i]`, zeros while they are not known yet."""

    def __init__(self, verb_logits=None):
        self.verb_logits, self.calls = verb_logits, []

    def apply(self, params, *args, training, method):
        assert training is False and method is JaxRLIPParSeDA.forward_tagger
        self.calls.append(args)
        px, _, te, _, tg, _, n_obj = args
        if self.verb_logits is None:
            return {"pred_verb_logits": jnp.zeros((px.shape[0], tg.valid.shape[1], te.shape[1] - n_obj))}
        return {"pred_verb_logits": jnp.asarray(self.verb_logits[len(self.calls) - 1])}


def jax_generation(cfg, ds, enc, verb_logits=None):
    """The JAX `generate_pseudo_annotations` over `ds` at threshold 0 in
    batches of three rows, its tagger's verb logits `verb_logits`; returns
    the annotations and the batches its tagger was given."""
    stub = _TaggerCalls(verb_logits)
    with mock.patch.object(jax_gen, "jax", _NoJit()):
        annos = jax_gen.generate_pseudo_annotations(stub, None, JaxView(ds), enc, cfg, relation_threshold=0.0,
                                                    dataset_name="coco2017", batch_size=3)
    return annos, stub.calls


def jax_outputs(cfg, jm, params, x, arrays, gen_cfg, gen_calls):
    """In one jit, so that the tiny model compiles once: the plain forward
    on `x`; value_and_grad of the body of the JAX `tagger_loss_fn`
    (engine/train.py:125-150) on the tagger batch `arrays` with both noise
    scales at 0 and no dropout, the tagger's forward beside its losses; and
    the verb logits of the JAX generation's tagger forward (`gen_cfg`'s
    model, as `generate_pseudo_annotations` calls it) on each of its
    batches `gen_calls`. The GroupNorms take flax's two-pass variance, as
    in `test_torch_train.jax_loss_and_grads`."""
    crit = JaxCriterion(JaxLossConfig(verb_loss_type="bce"), subject_class=True)
    n = cfg.max_obj_texts
    tv = jnp.asarray(arrays["text_valid"])
    gen_model, (key, n_gen) = JaxRLIPParSeD(gen_cfg), gen_calls[0][5:]
    gen_batches = jax.tree_util.tree_map(lambda *a: np.stack(a), *(c[:5] for c in gen_calls))

    def loss_fn(p):
        out = jm.apply(p, jnp.asarray(arrays["pixels"]), jnp.asarray(arrays["pixel_valid"]),
                       jnp.asarray(arrays["text_emb"]), tv, jax_targets(arrays), jax.random.PRNGKey(0), n,
                       deterministic=True, box_noise_scale=0.0, label_noise_scale=0.0, training=True,
                       method=JaxRLIPParSeDA.forward_tagger)
        losses = crit.tagger_losses(out, jax_targets(arrays), tv[:, :n], tv[:, n:])
        return crit.weighted_total(losses), (losses, out)

    def gen_logits(p):
        return jax.lax.map(lambda b: gen_model.apply(p, *b, key, n_gen, training=False,
                                                     method=JaxRLIPParSeDA.forward_tagger)["pred_verb_logits"],
                           gen_batches)

    def both(p):
        return (jm.apply(p, *(jnp.asarray(a) for a in x), FORWARD_OBJ_TEXTS),
                jax.value_and_grad(loss_fn, has_aux=True)(p), gen_logits(p))

    two_pass = functools.partial(flax.linen.GroupNorm, use_fast_variance=False)
    with mock.patch.object(flax.linen, "GroupNorm", two_pass):
        # XLA's cheapest CPU code generation: the programme runs once
        return jax.jit(both).lower(params).compile(compiler_options=FAST_COMPILE)(params)


@pytest.fixture(scope="module")
def both(pair, tmp_path_factory):
    """The JAX outputs (`jax_outputs`), the port's tagger step on the same
    batch (clip and learning rates off, so the gradients stay as computed),
    that batch, and the pseudo-relations of the port's and the JAX
    generation on a COCO tree (`test_torch_generate_relations`) with these
    weights at COCO's 81 object slots (no parameter depends on the slots):
    (dataset, port's, JAX's)."""
    cfg, jm, params, _ = pair
    model = port_model(cfg, params, tagger=True)
    arrays = tagger_batch(cfg, write_tagger_tree(tmp_path_factory.mktemp("vgtag")))
    gen_cfg = generate_config()
    ds, _ = datasets(write_generate_tree(tmp_path_factory.mktemp("coco")))
    enc = fake_text_encoder(gen_cfg.text_encoder.hidden_size)
    _, gen_calls = jax_generation(gen_cfg, ds, enc)
    forward, ((total, (losses, out)), grads), gen_logits = jax_outputs(cfg, jm, params, inputs(cfg), arrays,
                                                                      gen_cfg, gen_calls)
    tcfg = TrainConfig(clip_max_norm=1e9, lr=0.0, lr_backbone=0.0, lr_text_encoder=0.0)
    opt, sched = build_optimizer(model, tcfg)
    step = make_train_step(model, SetCriterionHOI(LossConfig(verb_loss_type="bce"), subject_class=True,
                                                  tagger=True), opt, sched, tcfg, tagger=True,
                           box_noise_scale=0.0, label_noise_scale=0.0)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    metrics = step(TrainBatch(t["pixels"], t["pixel_valid"], t["text_emb"], t["text_valid"], torch_targets(arrays)))
    port_grads = {k: None if p.grad is None else p.grad.clone() for k, p in model.named_parameters()}
    want, replayed = jax_generation(gen_cfg, ds, enc, np.asarray(gen_logits))
    assert len(replayed) == len(gen_calls) > 1
    got = gen.generate_pseudo_annotations(gen.tagger_apply_fn(port_model(gen_cfg, params, tagger=True), gen_cfg), ds,
                                          enc, gen_cfg, relation_threshold=0.0, dataset_name="coco2017", batch_size=3)
    return forward, (float(total), losses, out, grads), (metrics, port_grads, model), arrays, (ds, got, want)


def test_forward_tagger_matches_jax(pair, both):
    """The port's forward_tagger at noise 0 against the JAX one
    (the same function at noise 0): every output, aux layers and the slot
    mask included, within 2e-3."""
    cfg, _, _, model = pair
    arrays = both[3]
    want = both[1][2]
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    with torch.no_grad():
        got = model.forward_tagger(t["pixels"], t["pixel_valid"], t["text_emb"], t["text_valid"],
                                   torch_targets(arrays), cfg.max_obj_texts, 0.0, 0.0)
    np.testing.assert_array_equal(got["tagger_slot_valid"].numpy(), np.asarray(want["tagger_slot_valid"]))
    for g, w in [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"])):
        for k in ("pred_obj_logits", "pred_sub_logits", "pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), atol=2e-3, rtol=0, err_msg=k)


def test_tagger_step_loss_and_grads_match_jax(pair, both):
    """The step's loss terms within 1e-4 relative, and every trainable
    parameter's gradient within 1e-3 * max|g| + 1e-6 of the JAX gradient
    mapped by `state_dict_from_jax`; the parameters the tagger does not
    reach (the plain-deformable decoders, the top-level box heads, the
    query embeddings) have none in the port and zeros in JAX."""
    cfg = pair[0]
    (total, losses, _, jax_grads), (metrics, grads, model), _ = both[1:4]
    np.testing.assert_allclose(float(metrics["loss"]), total, rtol=1e-4)
    for k in losses:
        np.testing.assert_allclose(float(metrics[k]), float(losses[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    want = state_dict_from_jax(jax_grads, cfg)
    checked = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        w = want[name]
        if grads[name] is None:
            assert not np.any(w), name
            continue
        tol = 1e-3 * float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(grads[name].numpy(), w, atol=tol, rtol=0, err_msg=name)
        checked += 1
    assert checked > 100
    assert grads["transformer.coord_proj.weight"] is not None
    assert grads["transformer.ho_decoder_nd.layers.0.linear1.weight"] is None
    assert grads["query_embed.weight"] is None


def _leaf_count(params) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))


def _port_count(model) -> int:
    """Elements of the model's distinct tensors, a frozen BatchNorm counted
    as the two JAX leaves (scale, bias) it comes from."""
    seen, n = set(), 0
    for name, t in model.state_dict(keep_vars=True).items():
        if t.data_ptr() in seen or name.endswith(("running_mean", "running_var")):
            continue
        seen.add(t.data_ptr())
        n += t.numel()
    return n


@pytest.mark.parametrize("tagger", [False, True])
def test_every_jax_leaf_lands_in_one_port_tensor(pair, tagger):
    """A tree without the tagger's leaves loads into RLIPParSeD(cfg), one
    with them into RLIPParSeD(cfg, tagger=True), both strictly, and the
    element counts agree: no leaf is dropped or written twice."""
    cfg = pair[0]
    params = pair[2] if tagger else jax_tree(cfg, include_tagger=False)[1]
    p = params["params"]
    assert ("coord_proj" in p) == ("ho_decoder" in p) == tagger
    model = port_model(cfg, params, tagger)
    assert _leaf_count(params) == _port_count(model)
    assert any(k.startswith("transformer.ho_decoder.") for k in model.state_dict()) == tagger


def test_factory_maps_variants():
    assert type(build_model(parsed_config())) is RLIPParSeD
    assert type(build_model(tiny_config())) is RLIPParSeDA
    assert build_model(parsed_config(), tagger=True).tagger
    for variant in ("qpic", "rlip_mdetr", "cdn"):
        with pytest.raises(NotImplementedError, match="item 20"):
            build_model(tiny_config(variant=variant))


def test_parseda_state_dict_is_unchanged_by_the_tagger_option():
    """RLIPParSeDA's names stay the reference's; tagger=True adds only
    `transformer.coord_proj`."""
    cfg = tiny_config()
    plain, tagged = list(RLIPParSeDA(cfg).state_dict()), list(RLIPParSeDA(cfg, tagger=True).state_dict())
    assert set(tagged) - set(plain) == {"transformer.coord_proj.weight", "transformer.coord_proj.bias"}
    assert [k for k in tagged if k in plain] == plain


@pytest.mark.parametrize("n_ckpt", [4, 16, 40])
def test_query_embed_fits_as_the_jax_filter(n_ckpt, tmp_path):
    """A RLIP-ParSeD `.pth` with n_ckpt queries warm-starts the 16-query
    model: `query_embed` truncated or tiled as the JAX
    `filter_query_embeddings` does, and the load is strict."""
    cfg = parsed_config()
    model = RLIPParSeD(cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(n_ckpt)
    for k in ("query_embed.weight", "tgt_embed.weight", "verb_tgt_embed.weight", "refpoint_embed.weight"):
        sd[k] = torch.from_numpy(rng.randn(n_ckpt, sd[k].shape[1]).astype(np.float32))
    fitted = fit_query_embeddings(sd, cfg.num_queries)
    want, _ = jax_filter_query_embeddings(sd["query_embed.weight"].numpy(), sd["refpoint_embed.weight"].numpy(),
                                          cfg.num_queries)
    np.testing.assert_array_equal(fitted["query_embed.weight"].numpy(), want)
    torch.save({"model": sd}, tmp_path / "parsed.pth")
    load_reference_checkpoint(model, tmp_path / "parsed.pth")
    np.testing.assert_array_equal(model.query_embed.weight.detach().numpy(), want)


def test_a_parsed_checkpoint_warm_starts_the_tagger(tmp_path):
    """A RLIP-ParSeD `.pth` has no tagger parameters: it loads into the
    tagger model, which keeps its own (`coord_proj` and the DAB decoders)
    as initialised; any other key missing still raises."""
    cfg = parsed_config()
    sd = RLIPParSeD(cfg).state_dict()
    torch.save({"model": sd}, tmp_path / "parsed.pth")
    tagger = RLIPParSeD(cfg, tagger=True)
    before = tagger.transformer.coord_proj.weight.detach().clone()
    info = load_reference_checkpoint(tagger, tmp_path / "parsed.pth")
    assert torch.equal(tagger.transformer.coord_proj.weight, before)
    assert torch.equal(tagger.query_embed.weight, sd["query_embed.weight"])
    assert any(k.startswith("transformer.ho_decoder.") for k in info["initialised"])
    del sd["query_embed.weight"]
    torch.save({"model": sd}, tmp_path / "short.pth")
    with pytest.raises(RuntimeError, match="query_embed"):
        load_reference_checkpoint(tagger, tmp_path / "short.pth")


def test_parsed_config_checks():
    """RLIP-ParSeD ignores use_dab and with_box_refine (as the JAX class
    does); its verb queries are vanilla_MBF."""
    cfg = parsed_config(use_dab=False, with_box_refine=False)
    RLIPParSeD(cfg)
    bad = dataclasses.replace(cfg, transformer=dataclasses.replace(cfg.transformer, verb_query_tgt_type="MBF"))
    with pytest.raises(NotImplementedError, match="vanilla_MBF"):
        RLIPParSeD(bad)


def test_generate_pseudo_annotations_matches_jax(both):
    """The port's generation against the JAX function's on the same
    pixels, text features and weights, rows in batches of three, the last
    wrap-padded; the JAX function's tagger forward runs in `jax_outputs`'
    jit on the batches the function builds."""
    assert_generated_match(*both[4])
