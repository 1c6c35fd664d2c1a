"""The port's detector path against the JAX package's, float32 on the CPU,
from numpy seeds:
  * `DETRDetector` within 2e-3 of the JAX model from the params
    `detector_state_dict_from_jax` carries (strict load, every JAX leaf in
    one port tensor), at batch 2 in the 61 x 83 bucket with a padded image;
  * `detection_matching_costs` and `detection_losses` on the same numpy
    outputs (one aux layer) and targets with padded slots within 1e-5
    relative; the JAX side's `hungarian_match` is patched to scipy on its
    own costs, so it traces no solver;
  * `postprocess_detection` on outputs with tied scores: the same queries
    in the same order (a stable sort, as the JAX argsort);
  * the numpy COCO evaluator: the summaries of `tests/test_coco_eval.py`'s
    scenarios (recorded from its own calls) and of one seeded random set,
    and the accumulated curves, equal to the JAX evaluator's;
  * the three detector converters on detector state dicts built as
    `tests/test_convert_detector.py` builds them: the port's partial state
    dict equals, key by key and bit for bit, `state_dict_from_jax` of the
    JAX converter's tree merged over an init, on every key the port's sets
    (the ResNet's FrozenBN buffers, which the JAX converter folds into an
    affine, through their fold); `load_partial_state_dict` refuses an
    unknown key and a wrong shape; with one decoder layer's box head
    missing, the port keeps the other layers' heads where the JAX
    converter drops them all; `coco_class_embed_to_hico` as JAX's for
    hico and vcoco.
One jit at XLA's cheapest level computes the JAX detector's forward."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import test_coco_eval
from rlipv2_tpu.engine import convert as jax_convert
from rlipv2_tpu.eval import coco_eval as jax_coco_eval
from rlipv2_tpu.models import detection as jax_detection
from rlipv2_tpu_torch.engine import convert
from rlipv2_tpu_torch.engine.convert import detector_state_dict_from_jax, load_partial_state_dict, \
    state_dict_from_jax
from rlipv2_tpu_torch.eval import coco_eval
from rlipv2_tpu_torch.models import detection
from rlipv2_tpu_torch.models.factory import build_model
from test_convert_detector import synth_detector_sd, synth_detr_sd
from test_parseda_forward import tiny_config
from test_torch_parse import BATCH, close, jax_params, model_inputs, to_torch
from test_torch_parsed import FAST_COMPILE, _leaf_count, _port_count
from test_torch_parseda import random_params

torch.set_num_threads(2)

MODEL_ATOL, LOSS_RTOL = 2e-3, 1e-5
NUM_CLASSES = 12
OUT_KEYS = ("pred_logits", "pred_boxes")


# ---------------------------------------------------------------- DETRDetector


@pytest.fixture(scope="module")
def detector():
    """(cfg, JAX model, seeded JAX params, port model, JAX outputs on
    `model_inputs`)."""
    cfg = tiny_config()
    jm = jax_detection.DETRDetector(cfg, num_classes=NUM_CLASSES)
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                           jnp.ones((1, 64, 64), bool)), seed=3)
    model = to_torch(detection.DETRDetector(cfg, NUM_CLASSES), detector_state_dict_from_jax(params))
    pixels, valid = model_inputs(cfg)[:2]
    run = jax.jit(lambda p: jm.apply(p, jnp.asarray(pixels), jnp.asarray(valid)))
    return cfg, jm, params, model, run.lower(params).compile(compiler_options=FAST_COMPILE)(params)


def test_detector_matches_jax(detector):
    cfg, _, params, model, want = detector
    assert _leaf_count(params) == _port_count(model)
    assert "transformer.decoder.layers.0.multihead_attn.in_proj_weight" in model.state_dict()
    assert not any(k.startswith("transformer.decoder.norm") for k in model.state_dict())  # as the JAX class
    pixels, valid = model_inputs(cfg)[:2]
    assert not valid.all()
    with torch.no_grad():
        got = model(torch.from_numpy(pixels), torch.from_numpy(valid))
    assert got["pred_logits"].shape == (BATCH, cfg.num_queries, NUM_CLASSES + 1)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == cfg.transformer.dec_layers - 1
    for g, w in [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"])):
        for k in OUT_KEYS:
            close(g[k], w[k], MODEL_ATOL, k)


# ---------------------------------------------------------------- losses and post-process


def loss_case(seed=5, B=2, Q=16, M=4):
    """Seeded outputs of two layers (the last and one aux) and targets whose
    second image pads its last two slots."""
    rng = np.random.RandomState(seed)

    def layer():
        return {"pred_logits": rng.randn(B, Q, NUM_CLASSES + 1).astype(np.float32),
                "pred_boxes": (1 / (1 + np.exp(-rng.randn(B, Q, 4)))).astype(np.float32)}

    outputs = {**layer(), "aux_outputs": [layer()]}
    labels = rng.randint(0, NUM_CLASSES, (B, M))
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (B, M, 2)), rng.uniform(0.05, 0.3, (B, M, 2))], -1)
    valid = np.ones((B, M), bool)
    valid[1, 2:] = False
    boxes[~valid] = 0.0
    return outputs, labels, boxes.astype(np.float32), valid


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def scipy_hungarian(cost):
    """The JAX `hungarian_match` contract, (B, Q, M) -> (B, M) query per
    target slot with every slot (padded ones at cost 0) assigned, by scipy
    on the host."""
    def solve(c):
        match = np.zeros(c.shape[::2], np.int32)
        for b in range(c.shape[0]):
            rows, cols = linear_sum_assignment(c[b].T)
            match[b, rows] = cols
        return match

    return jax.pure_callback(solve, jax.ShapeDtypeStruct(cost.shape[::2], jnp.int32), cost)


def test_detection_costs_and_losses_match_jax():
    outputs, labels, boxes, valid = loss_case()
    t_out = _tree(torch.from_numpy, outputs)
    t_args = (torch.from_numpy(labels), torch.from_numpy(boxes), torch.from_numpy(valid))
    j_in = (_tree(jnp.asarray, outputs), *(jnp.asarray(a) for a in (labels, boxes, valid)))

    def run(out, *args):
        return (jax_detection.detection_matching_costs(out, *args),
                jax_detection.detection_losses(out, *args, num_classes=NUM_CLASSES))

    with mock.patch.object(jax_detection, "hungarian_match", scipy_hungarian):
        costs, want = jax.jit(run).lower(*j_in).compile(compiler_options=FAST_COMPILE)(*j_in)
    close(detection.detection_matching_costs(t_out, *t_args), costs, 1e-6, "costs")
    got = detection.detection_losses(t_out, *t_args, num_classes=NUM_CLASSES)
    assert set(got) == set(want) and "loss_giou_0" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)


def test_detection_loss_gradients_are_finite():
    """The losses' gradient reaches the logits and boxes of every layer."""
    outputs, labels, boxes, valid = loss_case(seed=6)
    t_out = _tree(lambda a: torch.from_numpy(a).requires_grad_(), outputs)
    losses = detection.detection_losses(t_out, torch.from_numpy(labels), torch.from_numpy(boxes),
                                        torch.from_numpy(valid), num_classes=NUM_CLASSES)
    sum(v for k, v in losses.items() if k.startswith("loss_")).backward()
    for layer in (t_out, t_out["aux_outputs"][0]):
        for k in OUT_KEYS:
            g = layer[k].grad
            assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0, k


def test_postprocess_breaks_ties_as_jax():
    """Queries in pairs of equal logits: the top k keeps each pair in query
    order; the distinct boxes say which query each row holds."""
    rng = np.random.RandomState(7)
    B, Q = 2, 16
    logits = np.repeat(rng.randn(B, Q // 2, NUM_CLASSES + 1), 2, axis=1).astype(np.float32)
    logits[1, :, :] = logits[1, :1, :]  # image 1: every query tied
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, Q, 2)), rng.uniform(0.05, 0.3, (B, Q, 2))], -1)
    sizes = np.array([[480, 640], [333, 500]], np.float32)
    out = {"pred_logits": logits, "pred_boxes": boxes.astype(np.float32)}
    got = detection.postprocess_detection(_tree(torch.from_numpy, out), torch.from_numpy(sizes), top_k=9)
    want = jax_detection.postprocess_detection(_tree(jnp.asarray, out), jnp.asarray(sizes), top_k=9)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    close(got["scores"], want["scores"], 1e-7, "scores")
    close(got["boxes"], want["boxes"], 1e-4, "boxes")


# ---------------------------------------------------------------- COCO evaluator


def coco_scenarios() -> list:
    """(predictions, gt json) of each `tests/test_coco_eval.py` call of the
    evaluator, recorded as its tests run against the JAX evaluator."""
    calls = []

    def record(preds, gts, *a, **kw):
        calls.append((preds, gts))
        return jax_coco_eval.coco_evaluate_bbox(preds, gts, *a, **kw)

    with mock.patch.object(test_coco_eval, "coco_evaluate_bbox", record):
        for name in sorted(dir(test_coco_eval)):
            fn = getattr(test_coco_eval, name)
            if name.startswith("test_") and callable(fn) and fn.__code__.co_argcount == 0:
                fn()
    return calls


def random_scenario(seed=11, n_imgs=6, cats=(1, 2, 3)):
    """Seeded GTs (some crowd, every area bucket) and jittered, duplicated
    and spurious detections with tied scores."""
    rng = np.random.RandomState(seed)
    annos, preds = [], []
    for img in range(n_imgs):
        for _ in range(rng.randint(1, 6)):
            w, h = rng.choice([6, 20, 60, 150]), rng.choice([8, 25, 70, 120])
            box = [float(rng.randint(0, 300)), float(rng.randint(0, 300)), float(w), float(h)]
            cat = int(rng.choice(cats))
            annos.append({"image_id": img, "category_id": cat, "bbox": box, "iscrowd": int(rng.rand() < 0.1)})
            for _ in range(rng.randint(0, 3)):
                jit = (np.array(box) + rng.randn(4) * [3, 3, 4, 4]).clip(min=1).tolist()
                preds.append(test_coco_eval.det(img, cat, jit, float(np.round(rng.rand(), 1))))
        for _ in range(rng.randint(0, 4)):
            preds.append(test_coco_eval.det(img, int(rng.choice(cats)), [float(x) for x in rng.randint(1, 200, 4)],
                                            float(rng.rand())))
    return preds, test_coco_eval.gt_json(annos, n_imgs=n_imgs, cats=cats)


def test_coco_evaluator_matches_jax():
    cases = coco_scenarios() + [random_scenario()]
    assert len(cases) >= 7
    for i, (preds, gts) in enumerate(cases):
        got, want = coco_eval.coco_evaluate_bbox(preds, gts), jax_coco_eval.coco_evaluate_bbox(preds, gts)
        assert set(got) == set(want), i
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"case {i} {k}")
    preds, gts = cases[-1]
    ev, jev = coco_eval.CocoBboxEvaluator(gts), jax_coco_eval.CocoBboxEvaluator(gts)
    ev.evaluate(preds)
    jev.evaluate(preds)
    for k in jev.eval:
        np.testing.assert_array_equal(ev.eval[k], jev.eval[k], err_msg=k)


def test_coco_evaluate_reads_the_gt_json(tmp_path):
    """`coco_evaluate` without pycocotools: the numpy evaluator on the file."""
    import json

    preds, gts = random_scenario(seed=12)
    (tmp_path / "gt.json").write_text(json.dumps(gts))
    assert detection.coco_evaluate(preds, tmp_path / "gt.json") == coco_eval.coco_evaluate_bbox(preds, gts)


# ---------------------------------------------------------------- detector converters


def ddetr_sd(cfg):
    """`synth_detector_sd` in the plain Deformable-DETR key space, as
    tests/test_convert_detector.py makes it."""
    d = cfg.transformer.hidden_dim
    sd = synth_detector_sd(d=d, nheads=cfg.transformer.nheads, enc=cfg.transformer.enc_layers,
                           dec=cfg.transformer.dec_layers)
    for k in list(sd):
        if "ref_point_head" in k or "query_scale" in k:
            del sd[k]
    del sd["tgt_embed.weight"], sd["refpoint_embed.weight"]
    rng = np.random.RandomState(1)
    sd["query_embed.weight"] = (rng.randn(32, 2 * d) * 0.05).astype(np.float32)
    sd["transformer.reference_points.weight"] = (rng.randn(2, d) * 0.05).astype(np.float32)
    sd["transformer.reference_points.bias"] = (rng.randn(2) * 0.05).astype(np.float32)
    return sd


# variant: (the detector's state dict, the port's converter, the JAX converter)
CONVERTERS = {
    "rlip_parseda_v2": (lambda cfg: synth_detector_sd(d=cfg.transformer.hidden_dim, nheads=cfg.transformer.nheads,
                                                      enc=cfg.transformer.enc_layers, dec=cfg.transformer.dec_layers),
                        convert.convert_dab_ddetr_detector, jax_convert.convert_dab_ddetr_detector),
    "rlip_parsed_v2": (ddetr_sd, convert.convert_ddetr_detector, jax_convert.convert_ddetr_detector),
    "rlip_parse_v1_joint": (lambda cfg: synth_detr_sd(d=cfg.transformer.hidden_dim, nheads=cfg.transformer.nheads,
                                                      enc=cfg.transformer.enc_layers, dec=cfg.transformer.dec_layers),
                            convert.convert_detr_detector, jax_convert.convert_detr_detector),
}
def _folded(sd: dict, name: str):
    """The JAX converter's fold of the FrozenBN `name` (float64, then float32)."""
    g, b, m, v = (sd[f"{name}.{k}"].astype(np.float64) for k in ("weight", "bias", "running_mean", "running_var"))
    scale = g / np.sqrt(v + 1e-5)
    return scale.astype(np.float32), (b - m * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_init(variant):
    """Seeded params of the JAX init of `variant`'s tiny model."""
    return jax_params(tiny_config(variant=variant), seed=30)[1]


def converted(variant, detector_sd, head_missing=None):
    """(cfg, the port's partial state dict, state_dict_from_jax of the JAX
    converter's tree merged over a seeded init, that of the init alone)."""
    cfg = tiny_config(variant=variant)
    make_sd, port_fn, jax_fn = CONVERTERS[variant]
    sd = make_sd(cfg) if detector_sd is None else detector_sd
    if head_missing is not None:
        sd = {k: v for k, v in sd.items() if not k.startswith(f"transformer.decoder.bbox_embed.{head_missing}.")}
    init = jax_init(variant)
    merged = jax_convert.merge_param_trees(dict(init["params"]), jax_fn(sd, cfg))
    return cfg, sd, port_fn({k: torch.from_numpy(v) for k, v in sd.items()}, cfg), \
        state_dict_from_jax({"params": merged}, cfg), state_dict_from_jax(init, cfg)


@pytest.mark.parametrize("variant", sorted(CONVERTERS))
def test_converter_matches_jax_bit_for_bit(variant):
    cfg, sd, partial, want, init = converted(variant, None)
    model = build_model(cfg)
    left = load_partial_state_dict(model, partial)
    own = model.state_dict()
    frozen_bn = {k[: -len(".running_var")] for k in partial if k.endswith(".running_var")}
    assert bool(frozen_bn) == any(k.startswith("backbone.") for k in sd)  # synth_detr_sd has no ResNet
    assert all(k.startswith("backbone.0.body.") for k in frozen_bn)
    for k, v in partial.items():
        assert v.dtype == np.float32 and torch.equal(own[k], torch.from_numpy(v)), k
        if k.rsplit(".", 1)[0] not in frozen_bn:
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    for name in frozen_bn:  # the JAX fold, unfolded by state_dict_from_jax
        scale, bias = _folded(partial, name)
        np.testing.assert_array_equal(want[f"{name}.bias"], bias, err_msg=name)
        np.testing.assert_array_equal(want[f"{name}.weight"],
                                      (scale.astype(np.float64) * np.sqrt(1 + 1e-5)).astype(np.float32))
    # the keys the converter leaves are the JAX tree's init: the text side
    for k in left:
        np.testing.assert_array_equal(init[k], want[k], err_msg=k)
    assert any(k.startswith("backbone.") for k in left) == (not frozen_bn)
    assert any(k.startswith("projection_text.") for k in left)
    if variant == "rlip_parseda_v2":  # the fusion layers stay at init, the deformable ones take the detector's
        assert any(".VLFuse_layers." in k for k in left)
        assert not any(k.startswith("transformer.encoder.layers.") for k in left)
        np.testing.assert_array_equal(partial["verb_tgt_embed.weight"], partial["tgt_embed.weight"])
    if variant == "rlip_parse_v1_joint":
        np.testing.assert_array_equal(partial["transformer.ho_decoder.norm.weight"],
                                      sd["transformer.decoder.norm.weight"])
        np.testing.assert_array_equal(partial["transformer.verb_decoder.layers.1.norm3.weight"],
                                      sd["transformer.decoder.layers.1.norm2.weight"])


def test_partial_load_refuses_unknown_keys_and_shapes():
    cfg = tiny_config(variant="rlip_parse_v1_joint")
    partial = convert.convert_detr_detector(CONVERTERS["rlip_parse_v1_joint"][0](cfg), cfg)
    model = build_model(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for bad in ({"transformer.decoder.layers.0.multihead_attn.in_proj_weight": np.zeros((192, 64), np.float32)},
                {"query_embed.weight": np.zeros((cfg.num_queries + 1, 64), np.float32)}):
        with pytest.raises(ValueError, match=next(iter(bad)).replace(".", r"\.")):
            load_partial_state_dict(model, {**partial, **bad})
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())  # nothing copied


def test_dab_ddetr_converter_keeps_the_box_heads_present():
    """Without layer 1's box head the JAX converter drops every layer's
    heads (rlipv2_tpu/engine/convert.py:76, ROADMAP queue 3): its merged
    tree keeps the init heads. The port sets the heads of layer 0 in both
    decoders and leaves layer 1's at init."""
    variant = "rlip_parseda_v2"
    full_sd = CONVERTERS[variant][0](tiny_config(variant=variant))
    cfg, sd, partial, want, init = converted(variant, full_sd, head_missing=1)
    n = cfg.transformer.dec_layers
    heads = [k for k in init if "bbox_embed." in k]
    for k in heads:  # the JAX converter dropped them all
        np.testing.assert_array_equal(want[k], init[k], err_msg=k)
    for side in ("sub", "obj"):
        for dec, offset in (("ho", 0), ("verb", n)):
            for layer in range(n):
                keys = (f"transformer.{dec}_decoder.{side}_bbox_embed.{layer}.layers.2.weight",
                        f"{side}_bbox_embed.{offset + layer}.layers.2.weight")
                for k in keys:
                    assert (k in partial) == (layer != 1), k
                if layer != 1:
                    np.testing.assert_array_equal(partial[keys[0]],
                                                  sd[f"transformer.decoder.bbox_embed.{layer}.layers.2.weight"])
                    assert not np.array_equal(partial[keys[0]], want[keys[0]])
    left = load_partial_state_dict(build_model(cfg), partial)
    assert "transformer.ho_decoder.sub_bbox_embed.1.layers.0.weight" in left
    assert "transformer.ho_decoder.sub_bbox_embed.0.layers.0.weight" not in left


@pytest.mark.parametrize("dataset", ["hico", "vcoco"])
def test_coco_class_embed_to_hico_matches_jax(dataset):
    rng = np.random.RandomState(3)
    w, b = rng.randn(91, 16).astype(np.float32), rng.randn(91).astype(np.float32)
    assert convert.COCO_OBJ_IDS == jax_convert.COCO_OBJ_IDS
    for got, want in zip(convert.coco_class_embed_to_hico(w, b, dataset=dataset),
                         jax_convert.coco_class_embed_to_hico(w, b, dataset=dataset)):
        np.testing.assert_array_equal(got, want)


def test_converted_model_runs():
    """The warm-started RLIP-ParSe v1 runs a forward with finite outputs."""
    cfg = tiny_config(variant="rlip_parse_v1_joint")
    model = build_model(cfg).eval()
    load_partial_state_dict(model, convert.convert_detr_detector(CONVERTERS["rlip_parse_v1_joint"][0](cfg), cfg))
    x = model_inputs(cfg)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in x), 5)
    assert all(torch.isfinite(out[k]).all() for k in ("pred_obj_logits", "pred_sub_boxes"))
