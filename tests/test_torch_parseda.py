"""The whole torch RLIP-ParSeDA against its two oracles, in float32 on CPU:
  * the golden pack: the reference torch model's weights (regenerated from
    the committed manifest) load with strict=True and reproduce its frozen
    outputs, aux layers included, within 2e-3;
  * the JAX model: seeded params in the tree of `init_model_params` on the
    tiny config, with the ResNet and with the Swin backbone, converted with
    `state_dict_from_jax`, give the same outputs within 2e-3 (odd image
    size, a padded and an all-padded image), and the port's `evaluate_hoi`
    gives the same post-processed scores and boxes as the JAX one on the
    same synthetic dataset. mAP values are not compared: with random
    weights they are noise-bound;
  * the verb-curing and masked-entity heads (on the ResNet model) against
    the JAX model's, and the uniformity analysis against the JAX loop's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlipv2_tpu.config import BackboneConfig
from rlipv2_tpu.engine import loops as jax_loops
from rlipv2_tpu.models.parseda import RLIPParSeDA as JaxRLIPParSeDA
from rlipv2_tpu.models.parseda import downsample_mask as jax_downsample_mask
from rlipv2_tpu.models.parseda import init_model_params
from rlipv2_tpu_torch.data.synthetic import SyntheticHICODataset, hash_tokenize
from rlipv2_tpu_torch.engine import loops
from rlipv2_tpu_torch.engine.convert import state_dict_from_jax
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA, downsample_mask
from rlipv2_tpu_torch.tools.golden_pack import check_pack, load_pack, torch_pack_config
from test_parseda_forward import tiny_config

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 2e-3
OUT_KEYS = ("pred_obj_logits", "pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes")
N_OBJ_CLASSES, N_VERBS = 4, 7  # tiny_config: max_obj_texts 5 (4 + no-object), max_verb_texts 7


def test_golden_pack_strict_load_and_outputs():
    report = check_pack(atol=ATOL, device="cpu")
    assert any(k.startswith("aux0.") for k in report)
    assert max(report.values()) <= ATOL, report


def test_state_dict_keys_are_the_reference_manifest():
    _, manifest = load_pack()
    sd = RLIPParSeDA(torch_pack_config()).state_dict()
    assert list(sd) == manifest["names"]
    assert [list(v.shape) for v in sd.values()] == [list(s) for s in manifest["shapes"]]


@pytest.mark.parametrize("h,w", [(7, 9), (13, 21), (4, 6)])
def test_downsample_mask_matches_jax_nearest(h, w):
    rng = np.random.RandomState(h * w)
    valid = rng.rand(2, 53, 81) > 0.3  # odd sizes: half-pixel centres matter
    want = np.asarray(jax_downsample_mask(jnp.asarray(valid), h, w))
    np.testing.assert_array_equal(downsample_mask(torch.from_numpy(valid), h, w).numpy(), want)


BATCH, BUCKET = 2, (61, 83)  # odd size; one jitted JAX forward serves both tests


def random_params(init, seed: int):
    """A param tree shaped as `init()` returns it, filled from numpy with
    `seed`: norm scales 1 + 0.1 randn; kernels randn / sqrt(n), n the
    product of all axes but the last, or the middle axis of a 3-D (scanned
    or per-head) kernel; every other leaf 0.02 randn. `jax.eval_shape`
    traces the init and compiles nothing, where a jitted init of the tiny
    model compiles for ~20 s."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if name == "kernel":
            fan_in = np.prod(s.shape[:-1]) if len(s.shape) != 3 else s.shape[-2]
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.02 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init))


def _tiny_pair(backbone: str, heads: bool = False):
    """(cfg, jax model, jax params, jitted jax apply, torch model with the
    converted params) for the tiny config with `backbone`; `heads` turns
    on the verb-curing and masked-entity heads."""
    cfg = dataclasses.replace(tiny_config(), backbone=BackboneConfig(name=backbone, num_outputs=3),
                              verb_curing=heads, masked_entity_modeling=heads)
    jm = JaxRLIPParSeDA(cfg)
    T = cfg.max_obj_texts + cfg.max_verb_texts
    params = random_params(lambda: init_model_params(
        jm, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 64, 64), bool),
        jnp.zeros((1, T, cfg.text_encoder.hidden_size)), jnp.ones((1, T), bool),
        cfg.max_obj_texts, jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32),
    ), seed=0)
    model = RLIPParSeDA(cfg)
    sd = state_dict_from_jax(params, cfg)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, strict=True)
    jax_apply = jax.jit(lambda p, px, v, te, tv, n: jm.apply(p, px, v, te, tv, n), static_argnums=(5,))
    return cfg, jm, params, jax_apply, model.eval()


@pytest.fixture(scope="module")
def tiny_pair():
    """The ResNet model with the verb-curing and masked-entity heads: its
    other outputs are those of the model without them, so one jitted JAX
    forward serves both."""
    return _tiny_pair("resnet_test", heads=True)


@pytest.fixture(scope="module")
def tiny_swin_pair():
    """The same with the `swin_test` backbone: at BUCKET the 4x4 patch
    embedding pads (61 and 83 are not multiples of 4) and every stage pads
    to its window."""
    return _tiny_pair("swin_test")


def test_full_model_matches_jax(tiny_pair):
    _check_full_model(tiny_pair)


def test_full_model_with_swin_matches_jax(tiny_swin_pair):
    _check_full_model(tiny_swin_pair)


def _check_full_model(pair):
    cfg, jm, params, jax_apply, model = pair
    got, want = _forwards(pair)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == cfg.transformer.dec_layers - 1
    for g, w in [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"])):
        for k in OUT_KEYS:
            assert np.isfinite(g[k].numpy()).all(), k
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), atol=ATOL, rtol=0, err_msg=k)
    for k in ("verb_decoder_out", "lang_states"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0, err_msg=k)


def test_curing_and_recon_heads_match_jax(tiny_pair):
    """The verb-curing score (the last layer's, in every aux layer too) and
    every decoder layer's masked-entity `recon_stat` within 1e-3 of JAX;
    the recon boxes start from that layer's anchor, so an anchor of another
    layer shows. The converted tree holds the JAX heads' leaves."""
    cfg, jm, params, jax_apply, model = tiny_pair
    got, want = _forwards(tiny_pair)
    layers = [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"]))
    assert len(layers) == cfg.transformer.dec_layers
    for lvl, (g, w) in enumerate(layers):
        assert g["curing_score"] is got["curing_score"] and g["curing_score"].shape == (BATCH, cfg.num_queries // 2, 1)
        np.testing.assert_allclose(g["curing_score"].numpy(), np.asarray(w["curing_score"]), atol=1e-3, rtol=0)
        for k in ("pred_sub_logits", "pred_obj_logits", "pred_sub_boxes", "pred_obj_boxes"):
            np.testing.assert_allclose(g["recon_stat"][k].numpy(), np.asarray(w["recon_stat"][k]), atol=1e-3,
                                       rtol=0, err_msg=f"layer {lvl} {k}")
    heads = [k for k in model.state_dict() if k.startswith(RLIPParSeDA.HEAD_PREFIXES)]
    assert len(heads) == 18 and {k.split(".")[0] for k in heads} == {
        "sub_curing", "obj_curing", "recon_linear", "recon_sub_bbox", "recon_obj_bbox"}


def test_heads_train_in_the_model_group_as_in_jax(tiny_pair):
    """The curing and recon heads take the "model" group and learning rate
    and follow every freeze regime as the JAX `_param_group` and
    `_regime_frozen` label their leaves."""
    from rlipv2_tpu.engine.optim import _param_group, _regime_frozen
    from rlipv2_tpu_torch.engine.optim import FREEZE_REGIMES, frozen, param_group_name

    _, _, params, _, model = tiny_pair
    names = ("sub_curing", "obj_curing", "recon_linear", "recon_sub_bbox", "recon_obj_bbox")
    leaves = [path for path, _ in jax.tree_util.tree_flatten_with_path(params["params"])[0]
              if path[0].key in names]
    assert len(leaves) == 18 and {_param_group(path) for path in leaves} == {"model"}
    heads = [k for k, _ in model.named_parameters() if k.startswith(RLIPParSeDA.HEAD_PREFIXES)]
    assert len(heads) == 18 and {param_group_name(k) for k in heads} == {"model"}
    for regime in FREEZE_REGIMES:
        assert {_regime_frozen(path, regime) for path in leaves} == {frozen(k, regime) for k in heads}, regime


def _forwards(pair):
    """(port outputs, JAX outputs) of one batch: odd size, a padded and an
    all-padded image, a padded text slot."""
    cfg, jm, params, jax_apply, model = pair
    rng = np.random.RandomState(1)
    B, (H, W) = BATCH, BUCKET
    pixels = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    valid = np.ones((B, H, W), bool)
    valid[0, 40:, :] = False
    valid[0, :, 57:] = False
    valid[1] = False  # an all-padded image
    T = cfg.max_obj_texts + cfg.max_verb_texts
    text = rng.randn(B, T, cfg.text_encoder.hidden_size).astype(np.float32)
    text_valid = np.ones((B, T), bool)
    text_valid[:, 3] = False
    want = jax_apply(params, jnp.asarray(pixels), jnp.asarray(valid), jnp.asarray(text),
                    jnp.asarray(text_valid), cfg.max_obj_texts)
    with torch.no_grad():
        got = model(torch.from_numpy(pixels), torch.from_numpy(valid), torch.from_numpy(text),
                    torch.from_numpy(text_valid), cfg.max_obj_texts)
    return got, want


def test_evaluate_hoi_matches_jax(tiny_pair, monkeypatch):
    _check_evaluate_hoi(tiny_pair, monkeypatch)


def test_evaluate_hoi_with_swin_matches_jax(tiny_swin_pair, monkeypatch):
    _check_evaluate_hoi(tiny_swin_pair, monkeypatch)


def _eval_setup(pair, monkeypatch):
    """The synthetic val set and the two text encoders of the pair; the
    JAX loops' post-process cures the verb scores of a model with the
    curing heads, as the reference's does and the port's evaluation does
    (the JAX loops never pass verb_curing: ROADMAP queue 3)."""
    cfg, jm, params, jax_apply, model = pair
    dataset = SyntheticHICODataset(
        2 * BATCH, min_size=(40, 50), max_size=BUCKET, n_obj_classes=N_OBJ_CLASSES,
        n_verb_classes=N_VERBS, seed=3,
    )

    def tokens(texts):
        return hash_tokenize(texts, cfg.text_encoder.vocab_size, maxlen=8)

    jax_encode = jax.jit(lambda p, i, m: jm.apply(p, i, m, method=JaxRLIPParSeDA.encode_text))

    def jax_text(texts):
        ids, mask = tokens(texts)
        return np.asarray(jax_encode(params, jnp.asarray(ids), jnp.asarray(mask)))

    def torch_text(texts):
        ids, mask = tokens(texts)
        with torch.no_grad():
            return model.encode_text(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()

    jax_postprocess = jax_loops.postprocess_hoi
    monkeypatch.setattr(jax_loops, "postprocess_hoi",
                        lambda out, orig, **kw: jax_postprocess(out, orig, verb_curing=True, **kw))
    return dataset, jax_loops.CachedTextEncoder(jax_text), loops.CachedTextEncoder(torch_text)


def _check_evaluate_hoi(pair, monkeypatch):
    cfg, jm, params, jax_apply, model = pair
    dataset, jax_text, torch_text = _eval_setup(pair, monkeypatch)
    captured = {}
    for name, mod in (("jax", jax_loops), ("torch", loops)):
        original = mod._run_hico_evaluator

        def capture(ds, preds, *rest, _name=name, _orig=original):
            captured[_name] = preds
            return _orig(ds, preds, *rest)

        monkeypatch.setattr(mod, "_run_hico_evaluator", capture)

    want_stats = jax_loops.evaluate_hoi(jax_apply, params, dataset, cfg, jax_text, batch_size=BATCH, bucket=BUCKET)
    got_stats = loops.evaluate_hoi(lambda m, *a: m(*a), model, dataset, cfg, torch_text, batch_size=BATCH,
                                   bucket=BUCKET)
    assert set(got_stats) == set(want_stats)
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in got_stats.values())
    assert len(captured["torch"]) == len(captured["jax"]) == len(dataset)
    for g, w in zip(captured["torch"], captured["jax"]):
        np.testing.assert_array_equal(g["sub_ids"], w["sub_ids"])
        np.testing.assert_allclose(g["verb_scores"], np.asarray(w["verb_scores"]), atol=ATOL, rtol=0)
        # boxes are in original pixels: 2e-3 of the normalised box
        np.testing.assert_allclose(g["boxes"], np.asarray(w["boxes"]), atol=ATOL * max(BUCKET), rtol=0)


def test_evaluate_hoi_matching_uniformity_matches_jax(tiny_pair, monkeypatch, tmp_path):
    """The uniformity analysis on the model with the curing heads against
    the JAX loop (pair slots capped at the model's 8 pair queries, which
    the JAX matcher needs): the same features under each verb class, in
    the same order, within 2e-3; the same counts and analysis; the same
    stats; the npz files with the same key and layout."""
    cfg, jm, params, jax_apply, model = tiny_pair
    dataset, jax_text, torch_text = _eval_setup(tiny_pair, monkeypatch)
    n_pairs = cfg.num_queries // 2
    want_stats, want_analysis, want = jax_loops.evaluate_hoi_matching_uniformity(
        jax_apply, params, dataset, cfg, jax_text, batch_size=BATCH, bucket=BUCKET, max_gt=n_pairs,
        save_path=str(tmp_path / "jax.npz"))
    got_stats, got_analysis, got = loops.evaluate_hoi_matching_uniformity(
        lambda m, *a: m(*a), model, dataset, cfg, torch_text, batch_size=BATCH, bucket=BUCKET,
        save_path=str(tmp_path / "torch.npz"))
    assert set(got) == set(want) == set(range(N_VERBS))
    assert [len(got[v]) for v in got] == [len(want[v]) for v in got] and got_analysis["n_features"] > 1
    for v in want:
        for g, w in zip(got[v], want[v]):
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0, err_msg=f"verb {v}")
    assert {k: got_analysis[k] for k in ("n_classes", "n_features")} == {
        k: want_analysis[k] for k in ("n_classes", "n_features")}
    for k in ("uniformity", "alignment"):
        np.testing.assert_allclose(got_analysis[k], want_analysis[k], rtol=1e-2, err_msg=k)
    assert set(got_stats) == set(want_stats)
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], atol=1e-6, err_msg=k)
    files = [np.load(tmp_path / f"{name}.npz", allow_pickle=True) for name in ("torch", "jax")]
    assert [f.files for f in files] == [["verb_class_dict"]] * 2
    got_file, want_file = (f["verb_class_dict"] for f in files)
    assert got_file.dtype == want_file.dtype == object and got_file.shape == want_file.shape == ()
    got_file, want_file = got_file.item(), want_file.item()
    assert list(got_file) == list(want_file)
    assert all(got_file[v].shape == want_file[v].shape and got_file[v].dtype == want_file[v].dtype
               for v in want_file)


def test_uniformity_blocks_match_the_full_matrix():
    """`tools/uniformity.py` over blocks of rows (3 or 5 rows at a time
    here) against the JAX functions' full n x n matrices, within 1e-9."""
    from rlipv2_tpu.tools import uniformity as jax_uniformity
    from rlipv2_tpu_torch.tools import uniformity

    rng = np.random.RandomState(4)
    classes = {v: rng.randn(n, 16).astype(np.float32) + rng.randn(16) for v, n in enumerate((9, 1, 14, 0, 5))}
    feats = np.concatenate([f for f in classes.values() if len(f)])
    for block in (3 * len(feats), 5 * len(feats), 1 << 22):
        np.testing.assert_allclose(uniformity.uniformity(feats, block_elements=block),
                                   jax_uniformity.uniformity(feats), rtol=1e-9)
        np.testing.assert_allclose(uniformity.alignment(classes, block_elements=block),
                                   jax_uniformity.alignment(classes), rtol=1e-9)
    got, want = uniformity.analyze(classes), jax_uniformity.analyze(classes)
    assert got.keys() == want.keys() and all(np.isclose(got[k], want[k], rtol=1e-9) for k in want)


def test_reference_checkpoint_without_the_heads_loads(tmp_path):
    """A `.pth` without the curing and recon heads (the pre-trained model a
    fine-tune starts from) loads into a model that has them: they keep
    their seeded values and are listed under "initialised"; a file missing
    any other tensor still fails the strict load."""
    from rlipv2_tpu_torch.engine.convert import load_reference_checkpoint
    from rlipv2_tpu_torch.tools.main_path import random_state_dict

    cfg = tiny_config()
    plain = random_state_dict(RLIPParSeDA(cfg))
    torch.save({"model": plain}, tmp_path / "plain.pth")
    torch.manual_seed(0)
    model = RLIPParSeDA(dataclasses.replace(cfg, verb_curing=True, masked_entity_modeling=True))
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = load_reference_checkpoint(model, tmp_path / "plain.pth")
    heads = [k for k in seeded if k not in plain]
    assert sorted(loaded["initialised"]) == sorted(heads) and len(heads) == 18
    got = model.state_dict()
    assert all(torch.equal(got[k], seeded[k]) for k in heads)
    reference = RLIPParSeDA(cfg)  # each shared box head holds the value loaded last
    load_reference_checkpoint(reference, tmp_path / "plain.pth")
    assert all(torch.equal(got[k], v) for k, v in reference.state_dict().items())
    torch.save({"model": {k: v for k, v in plain.items() if k != "projection_text.weight"}}, tmp_path / "cut.pth")
    with pytest.raises(RuntimeError, match="projection_text.weight"):
        load_reference_checkpoint(model, tmp_path / "cut.pth")


def test_unported_options_raise():
    cfg = tiny_config()
    with pytest.raises(NotImplementedError, match="two_stage"):
        RLIPParSeDA(dataclasses.replace(cfg, two_stage=True))


@pytest.mark.parametrize("variant,jax_class", [("rlip_parsed_v2", "RLIPParSeD"), ("rlip_parse", "RLIPParSe"),
                                               ("rlip_parse_v2", "RLIPParSeV2")])
def test_curing_and_recon_raise_where_the_jax_class_ignores_them(variant, jax_class):
    """RLIP-ParSeD and the ParSe models build or call no curing or recon
    heads in their JAX classes: both options raise ValueError naming it."""
    from rlipv2_tpu_torch.models.factory import build_model

    for option in ("verb_curing", "masked_entity_modeling"):
        cfg = dataclasses.replace(tiny_config(), variant=variant, **{option: True})
        with pytest.raises(ValueError, match=f"{option} would do nothing.*JAX {jax_class} "):
            build_model(cfg)


def test_synthetic_dataset_and_tokenizer_are_seeded():
    a = SyntheticHICODataset(3, min_size=(40, 50), max_size=(64, 96), seed=5)
    b = SyntheticHICODataset(3, min_size=(40, 50), max_size=(64, 96), seed=5)
    for i in range(3):
        (ia, ta), (ib, tb) = a[i], b[i]
        np.testing.assert_array_equal(ia, ib)
        h, w = ta["orig_size"]
        assert ia.shape == (h, w, 3) and ia.dtype == np.uint8 and 40 <= h <= 64 and 50 <= w <= 96
        assert (ta["boxes"][:, 2:] <= [w, h]).all() and (ta["boxes"][:, :2] < ta["boxes"][:, 2:]).all()
        assert ta["labels"][0] == 0 and (ta["hois"][:, 0] == 0).all()
    assert set(map(tuple, a.rare_triplets)).isdisjoint(map(tuple, a.non_rare_triplets))
    ids, mask = hash_tokenize(["ride bicycle", "no objects"], vocab_size=100, maxlen=6)
    assert ids[:, 0].tolist() == [0, 0] and mask.sum(1).tolist() == [4, 4]
    assert (ids[mask == 0] == 1).all() and (ids < 100).all()
    np.testing.assert_array_equal(ids, hash_tokenize(["ride bicycle", "no objects"], 100, 6)[0])


def test_cached_text_encoder_encodes_each_text_once():
    calls = []

    def encode(texts):
        calls.append(list(texts))
        return np.asarray([[len(t)] for t in texts], np.float32)

    enc = loops.CachedTextEncoder(encode)
    np.testing.assert_array_equal(enc(["a", "bb"]), [[1], [2]])
    np.testing.assert_array_equal(enc(["bb", "ccc", "a"]), [[2], [3], [1]])
    assert calls == [["a", "bb"], ["ccc"]]


def test_random_state_dict_is_seeded_and_loads_strictly():
    from rlipv2_tpu_torch.tools.main_path import random_state_dict

    model = RLIPParSeDA(tiny_config())
    a, b = random_state_dict(model), random_state_dict(model)
    assert list(a) == list(model.state_dict())
    for k in a:
        assert torch.equal(a[k], b[k]), k
    model.load_state_dict(a, strict=True)
