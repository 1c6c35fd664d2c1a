"""Each module of the torch port that the inference path runs, against its
JAX counterpart: the JAX module is initialised, its parameters are
perturbed (so zero-initialised heads are exercised), converted with the
port's `engine.convert` functions and loaded with strict=True; both run on
the same numpy inputs in float32 and must agree within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlipv2_tpu.config import FusionConfig, TextEncoderConfig, TransformerConfig
from rlipv2_tpu.eval.postprocess import postprocess_hoi as jax_postprocess
from rlipv2_tpu.models import dab_decoder as jdab
from rlipv2_tpu.models import deformable as jdef
from rlipv2_tpu.models import fusion as jfus
from rlipv2_tpu.models import layers as jlay
from rlipv2_tpu.models import resnet as jres
from rlipv2_tpu.models import roberta as jrob
from rlipv2_tpu.ops import positional as jpos
from rlipv2_tpu_torch.engine import convert
from rlipv2_tpu_torch.eval.postprocess import postprocess_hoi, to_image_results
from rlipv2_tpu_torch.models import dab_decoder, deformable, fusion, layers, resnet, roberta
from rlipv2_tpu_torch.ops import positional

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4
TEXT = TextEncoderConfig(
    vocab_size=64, hidden_size=24, num_layers=2, num_heads=4, intermediate_size=48,
    max_position_embeddings=32,
)
FUSION = FusionConfig(embed_dim=32, num_heads=4)
TCFG = TransformerConfig(
    hidden_dim=32, nheads=4, enc_layers=4, dec_layers=2, dim_feedforward=48,
    num_feature_levels=3, enc_n_points=2, dec_n_points=3, fusion=FUSION,
)
SHAPES = ((6, 7), (3, 4), (2, 2))
S = sum(h * w for h, w in SHAPES)


def jitter(params, seed, scale=0.05):
    """Perturb every parameter so zero/one initialisations are exercised."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.randn(*np.shape(x)).astype(np.float32), params
    )


def init_and_apply(jm, args, seed, scale=0.05):
    """Jitted init of the JAX module, perturbed params, jitted apply
    (jitting keeps the test from compiling op by op)."""
    params = jax.jit(lambda k: jm.init(k, *args))(jax.random.PRNGKey(0))["params"]
    params = jitter(params, seed, scale)
    return params, jax.jit(lambda p: jm.apply({"params": p}, *args))(params)


def load(module, sd, prefix=""):
    module.load_state_dict(
        {k[len(prefix):]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
        strict=True,
    )
    return module.eval()


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=atol, rtol=0)


def test_positional_ops():
    rng = np.random.RandomState(0)
    valid = np.ones((2, 5, 7), bool)
    valid[1, 3:, :] = False
    valid[1, :, 5:] = False
    close(positional.sine_position_embedding(t(valid), 16),
          jpos.sine_position_embedding(jnp.asarray(valid), 16), 1e-5)
    for d in (2, 4):
        pos = rng.rand(3, 5, d).astype(np.float32)
        close(positional.gen_sineembed_for_position(t(pos), 16),
              jpos.gen_sineembed_for_position(jnp.asarray(pos), 16), 1e-5)
    x = rng.uniform(-0.1, 1.1, (50,)).astype(np.float32)
    close(positional.inverse_sigmoid(t(x)), jpos.inverse_sigmoid(jnp.asarray(x)), 1e-5)


def test_resnet():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 45, 61, 3).astype(np.float32)  # odd sizes: padding and strides
    params, want = init_and_apply(jres.ResNet("resnet_test", num_outputs=3), (jnp.asarray(x),), 1, 0.02)
    sd = convert.resnet(params, resnet.STAGE_BLOCKS["resnet_test"], "")
    m = load(resnet.ResNet("resnet_test", num_outputs=3), sd)
    got = m(t(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        close(g.permute(0, 2, 3, 1), w)


def test_roberta_model():
    rng = np.random.RandomState(2)
    ids = rng.randint(3, TEXT.vocab_size, (3, 9))
    mask = np.ones((3, 9), np.int64)
    mask[1, 6:] = 0
    ids[mask == 0] = TEXT.pad_token_id
    params, (want_h, want_pool) = init_and_apply(
        jrob.RobertaModel(TEXT), (jnp.asarray(ids), jnp.asarray(mask)), 2)
    m = load(roberta.RobertaModel(TEXT), convert.roberta_model(params, TEXT.num_layers))
    got_h, got_pool = m(t(ids), t(mask))
    close(got_h, want_h)
    close(got_pool, want_pool)


def test_roberta_layer_with_alif_mask():
    rng = np.random.RandomState(3)
    h = rng.randn(2, 7, TEXT.hidden_size).astype(np.float32)
    valid = np.ones((2, 7), bool)
    valid[0, 4:] = False
    jmask = jrob.alif_additive_bool_mask(jnp.asarray(valid))
    params, want = init_and_apply(jrob.RobertaLayer(TEXT), (jnp.asarray(h), jmask), 3)
    m = load(roberta.RobertaLayer(TEXT), convert.roberta_layer(params, "x"), "x.")
    close(m(t(h), roberta.alif_additive_bool_mask(t(valid))), want)


def test_bi_attention_block_vxac():
    rng = np.random.RandomState(4)
    v = rng.randn(2, 11, 32).astype(np.float32)
    l = rng.randn(2, 5, 24).astype(np.float32)
    pos = rng.randn(2, 11, 32).astype(np.float32)
    lv = np.ones((2, 5), bool)
    lv[1, 3:] = False
    jm = jfus.BiAttentionBlock(FUSION, v_dim=32, l_dim=24, num_feature_levels=3)
    args = (jnp.asarray(v), jnp.asarray(l), jnp.asarray(pos), jnp.asarray(lv), None)
    params, (want_v, want_l) = init_and_apply(jm, args, 4)
    m = load(fusion.BiAttentionBlock(FUSION, 32, 24, 3), convert.bi_attention_block(params, "b"), "b.")
    got_v, got_l = m(t(v), t(l), t(pos), t(lv), None)
    close(got_v, want_v)
    close(got_l, want_l)


def test_bi_attention_block_other_gatings_not_ported():
    with pytest.raises(NotImplementedError, match="gating"):
        fusion.BiAttentionBlock(FusionConfig(gating_mechanism="SDFXAcLN"))


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_ms_deform_attention_layer(ref_dim):
    rng = np.random.RandomState(5 + ref_dim)
    q = rng.randn(2, 9, 32).astype(np.float32)
    value = rng.randn(2, S, 32).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (2, 9, 3, ref_dim)).astype(np.float32)
    valid = np.ones((2, S), bool)
    valid[1, 30:] = False
    jm = jlay.MSDeformAttention(d_model=32, n_levels=3, n_heads=4, n_points=3)
    args = (jnp.asarray(q), jnp.asarray(ref), jnp.asarray(value), SHAPES, jnp.asarray(valid))
    params, want = init_and_apply(jm, args, 5)
    m = load(layers.MSDeformAttention(32, 3, 4, 3), convert.msda(params, "a"), "a.")
    close(m(t(q), t(ref), t(value), SHAPES, t(valid)), want)


def test_group_norm_on_a_padded_channels_last_map():
    """The input projections' GroupNorm on a channels-last map that is 98 %
    padding (constant features, as a 61 x 83 image's in a 512 x 512
    bucket): within 1e-6 of the float64 group norm's max, where PyTorch's
    CPU group_norm on a channels-last map loses digits
    (`padded_bucket_witness.py` prints both on the tiny model's batch)."""
    rng = np.random.RandomState(0)
    x = np.broadcast_to(rng.randn(1, 64, 1, 1) * 0.2 + 1.0, (2, 64, 128, 128)).copy()
    x[:, :, :8, :11] = 0.3 * rng.randn(2, 64, 8, 11)
    gn = layers.GroupNorm(32, 64, eps=1e-5)
    scale, bias = 1.0 + 0.1 * rng.randn(64), 0.02 * rng.randn(64)
    gn.load_state_dict({"weight": torch.tensor(scale, dtype=torch.float32),
                        "bias": torch.tensor(bias, dtype=torch.float32)})
    xt = torch.from_numpy(x.astype(np.float32)).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = gn(xt).double()
        want = torch.nn.functional.group_norm(xt.double(), 32, gn.weight.double(), gn.bias.double(), 1e-5)
    tol = 1e-6 * float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)


def test_sampling_offset_bias_init():
    want = jlay.sampling_offset_bias_init(8, 4, 4)(jax.random.PRNGKey(0), (256,))
    close(layers.sampling_offset_bias_init(8, 4, 4), want, 1e-6)


def _memory(seed):
    rng = np.random.RandomState(seed)
    src = rng.randn(2, S, 32).astype(np.float32)
    pos = rng.randn(2, S, 32).astype(np.float32)
    masks = []
    for h, w in SHAPES:
        m = np.ones((2, h, w), bool)
        m[1, (h + 1) // 2:, :] = False
        masks.append(m)
    valid = np.concatenate([m.reshape(2, -1) for m in masks], 1)
    ratios = np.asarray(jdef.compute_valid_ratios([jnp.asarray(m) for m in masks]))
    close(deformable.compute_valid_ratios([t(m) for m in masks]), ratios, 1e-6)
    return src, pos, valid, ratios


def test_alif_encoder():
    rng = np.random.RandomState(6)
    src, pos, valid, ratios = _memory(6)
    lang = rng.randn(2, 5, TEXT.hidden_size).astype(np.float32)
    lang_valid = np.ones((2, 5), bool)
    lang_valid[0, 3:] = False
    jm = jdef.ALIFEncoder(TCFG, TEXT)
    args = (jnp.asarray(src), SHAPES, jnp.asarray(ratios), jnp.asarray(pos), jnp.asarray(valid),
            jnp.asarray(lang), jnp.asarray(lang_valid))
    params, (want_out, want_lang) = init_and_apply(jm, args, 6)
    sd = convert.alif_encoder(params, TCFG.enc_layers, FUSION.fusion_interval)
    m = load(deformable.ALIFEncoder(TCFG, TEXT), sd)
    got_out, got_lang = m(t(src), SHAPES, t(ratios), t(pos), t(valid), t(lang), t(lang_valid))
    close(got_out, want_out)
    close(got_lang, want_lang)
    close(deformable.encoder_reference_points(SHAPES, t(ratios)),
          jdef.encoder_reference_points(SHAPES, jnp.asarray(ratios)), 1e-6)


@pytest.mark.parametrize("parse", [True, False])
def test_dab_hoi_decoder(parse):
    rng = np.random.RandomState(7)
    src, _, valid, ratios = _memory(7)
    n_pairs = 4
    tgt = rng.randn(2, 2 * n_pairs if parse else n_pairs, 32).astype(np.float32)
    sub_ref = rng.uniform(0.2, 0.8, (2, n_pairs, 4)).astype(np.float32)
    obj_ref = rng.uniform(0.2, 0.8, (2, n_pairs, 4)).astype(np.float32)
    jm = jdab.DABHOIDecoder(TCFG, parse=parse)
    args = (jnp.asarray(tgt), jnp.asarray(sub_ref), jnp.asarray(obj_ref), jnp.asarray(src),
            SHAPES, jnp.asarray(ratios), jnp.asarray(valid))
    params, want = init_and_apply(jm, args, 7)
    m = load(dab_decoder.DABHOIDecoder(TCFG, parse=parse), convert.dab_decoder(params, TCFG.dec_layers))
    got = m(t(tgt), t(sub_ref), t(obj_ref), t(src), SHAPES, t(ratios), t(valid))
    for k in ("hs", "sub_refs", "obj_refs", "sub_boxes", "obj_boxes"):
        close(got[k], want[k])


POSTPROCESS_CASES = {
    # (logit scale, dtype of the model outputs, subject category id, verb curing)
    "float32": (1.0, np.float32, 0, False),
    "bfloat16_outputs": (1.0, "bfloat16", 0, False),  # the main path runs under bf16 autocast
    "saturated_logits": (30.0, np.float32, 1, False),
    "verb_curing": (1.0, np.float32, 0, True),  # a model with the curing heads
}


@pytest.mark.parametrize("case", sorted(POSTPROCESS_CASES))
def test_postprocess_hoi_and_image_results(case):
    from rlipv2_tpu.eval.postprocess import to_image_results as jax_to_image_results

    scale, dtype, subject_id, curing = POSTPROCESS_CASES[case]
    rng = np.random.RandomState(8)
    B, nq, T_obj, V = 3, 6, 5, 7
    outputs = {
        "pred_obj_logits": scale * rng.randn(B, nq, T_obj),
        "pred_verb_logits": scale * rng.randn(B, nq, V),
        "pred_sub_boxes": rng.uniform(0.1, 0.9, (B, nq, 4)),
        "pred_obj_boxes": rng.uniform(0.1, 0.9, (B, nq, 4)),
    }
    if curing:  # the outputs of a model with the curing heads
        outputs["curing_score"] = rng.uniform(0.05, 0.95, (B, nq, 1))
    if dtype == "bfloat16":  # both sides get the same bf16-rounded values
        jax_in = {k: jnp.asarray(v, jnp.bfloat16) for k, v in outputs.items()}
        torch_in = {k: t(v.astype(np.float32)).bfloat16() for k, v in outputs.items()}
    else:
        jax_in = {k: jnp.asarray(v.astype(dtype)) for k, v in outputs.items()}
        torch_in = {k: t(v.astype(dtype)) for k, v in outputs.items()}
    sizes = np.asarray([[480, 640], [333, 500], [800, 1333]], np.float32)
    want = jax_postprocess(jax_in, jnp.asarray(sizes), verb_curing=curing)
    got = postprocess_hoi(torch_in, t(sizes))
    uncured = postprocess_hoi({k: v for k, v in torch_in.items() if k != "curing_score"}, t(sizes))["verb_scores"]
    assert torch.equal(got["verb_scores"], uncured) != curing
    assert set(got) == set(want)
    for k in want:
        close(got[k].float(), np.asarray(want[k], np.float32), 1e-4 if "boxes" not in k else 1e-3)
    got_images = to_image_results(got, subject_id)
    want_images = jax_to_image_results(want, subject_id)
    assert len(got_images) == len(want_images) == B
    for g, w in zip(got_images, want_images):
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["sub_ids"], w["sub_ids"])
        np.testing.assert_array_equal(g["obj_ids"], w["obj_ids"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g["verb_scores"], w["verb_scores"], atol=1e-6, rtol=0)


def test_box_ops():
    from rlipv2_tpu.ops import boxes as jbox
    from rlipv2_tpu_torch.ops import boxes

    rng = np.random.RandomState(11)
    cxcywh = np.concatenate([rng.uniform(0.2, 0.8, (2, 5, 2)), rng.uniform(0.05, 0.4, (2, 5, 2))], -1)
    cxcywh = cxcywh.astype(np.float32)
    a = np.asarray(jbox.box_cxcywh_to_xyxy(jnp.asarray(cxcywh)))
    close(boxes.box_cxcywh_to_xyxy(t(cxcywh)), a, 1e-6)
    close(boxes.box_xyxy_to_cxcywh(t(a)), jbox.box_xyxy_to_cxcywh(jnp.asarray(a)), 1e-6)
    b = a[:, ::-1].copy()
    close(boxes.box_area(t(a)), jbox.box_area(jnp.asarray(a)), 1e-6)
    for got, want in zip(boxes.box_iou(t(a), t(b)), jbox.box_iou(jnp.asarray(a), jnp.asarray(b))):
        close(got, want, 1e-6)
    close(boxes.generalized_box_iou(t(a), t(b)), jbox.generalized_box_iou(jnp.asarray(a), jnp.asarray(b)), 1e-6)


def test_multi_branch_fusion_and_mlp():
    rng = np.random.RandomState(9)
    a = rng.randn(2, 5, 32).astype(np.float32)
    b = rng.randn(2, 5, 32).astype(np.float32)
    params, want = init_and_apply(jlay.MultiBranchFusion(32, 16), (jnp.asarray(a), jnp.asarray(b)), 9)
    m = load(layers.MultiBranchFusion(32, 32, 32, 16), convert.multi_branch_fusion(params, "g"), "g.")
    close(m(t(a), t(b)), want)
    p2, want2 = init_and_apply(jlay.MLP(32, 4, 3), (jnp.asarray(a),), 10)
    m2 = load(layers.MLP(32, 32, 4, 3), convert.mlp(p2, "h"), "h.")
    close(m2(t(a)), want2)
