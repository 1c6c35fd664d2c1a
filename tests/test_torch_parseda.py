"""The whole torch RLIP-ParSeDA against its two oracles, in float32 on CPU:
  * the golden pack: the reference torch model's weights (regenerated from
    the committed manifest) load with strict=True and reproduce its frozen
    outputs, aux layers included, within 2e-3;
  * the JAX model: `init_model_params` on the tiny config, converted with
    `state_dict_from_jax`, gives the same outputs within 2e-3 (odd image
    size, a padded and an all-padded image), and the port's `evaluate_hoi`
    gives the same post-processed scores and boxes as the JAX one on the
    same synthetic dataset. mAP values are not compared: with random
    weights they are noise-bound."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.fixture(scope="module")
def tiny_pair():
    """(cfg, jax model, jax params, jitted jax apply, torch model with the
    converted params)."""
    cfg = tiny_config()
    jm = JaxRLIPParSeDA(cfg)
    T = cfg.max_obj_texts + cfg.max_verb_texts
    params = jax.jit(lambda rng: init_model_params(
        jm, rng, jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 64, 64), bool),
        jnp.zeros((1, T, cfg.text_encoder.hidden_size)), jnp.ones((1, T), bool),
        cfg.max_obj_texts, jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32),
    ))(jax.random.PRNGKey(0))
    # perturb so zero-initialised heads (sampling offsets, attention weights) act
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.randn(*np.shape(x)).astype(np.float32), params
    )
    model = RLIPParSeDA(cfg)
    sd = state_dict_from_jax(params, cfg)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, strict=True)
    jax_apply = jax.jit(lambda p, px, v, te, tv, n: jm.apply(p, px, v, te, tv, n), static_argnums=(5,))
    return cfg, jm, params, jax_apply, model.eval()


def test_full_model_matches_jax(tiny_pair):
    cfg, jm, params, jax_apply, model = tiny_pair
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
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == cfg.transformer.dec_layers - 1
    for g, w in [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"])):
        for k in OUT_KEYS:
            assert np.isfinite(g[k].numpy()).all(), k
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), atol=ATOL, rtol=0, err_msg=k)
    for k in ("verb_decoder_out", "lang_states"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0, err_msg=k)


def test_evaluate_hoi_matches_jax(tiny_pair, monkeypatch):
    cfg, jm, params, jax_apply, model = tiny_pair
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

    captured = {}
    for name, mod in (("jax", jax_loops), ("torch", loops)):
        original = mod._run_hico_evaluator

        def capture(ds, preds, *rest, _name=name, _orig=original):
            captured[_name] = preds
            return _orig(ds, preds, *rest)

        monkeypatch.setattr(mod, "_run_hico_evaluator", capture)

    want_stats = jax_loops.evaluate_hoi(
        jax_apply, params, dataset, cfg, jax_loops.CachedTextEncoder(jax_text),
        batch_size=BATCH, bucket=BUCKET,
    )
    got_stats = loops.evaluate_hoi(
        lambda m, *a: m(*a), model, dataset, cfg, loops.CachedTextEncoder(torch_text),
        batch_size=BATCH, bucket=BUCKET,
    )
    assert set(got_stats) == set(want_stats)
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in got_stats.values())
    assert len(captured["torch"]) == len(captured["jax"]) == len(dataset)
    for g, w in zip(captured["torch"], captured["jax"]):
        np.testing.assert_array_equal(g["sub_ids"], w["sub_ids"])
        np.testing.assert_allclose(g["verb_scores"], np.asarray(w["verb_scores"]), atol=ATOL, rtol=0)
        # boxes are in original pixels: 2e-3 of the normalised box
        np.testing.assert_allclose(g["boxes"], np.asarray(w["boxes"]), atol=ATOL * max(BUCKET), rtol=0)


def test_unported_options_raise():
    cfg = tiny_config()
    with pytest.raises(NotImplementedError, match="verb_curing"):
        RLIPParSeDA(dataclasses.replace(cfg, verb_curing=True))


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
