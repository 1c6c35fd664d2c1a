"""Stochastic depth and rematerialization in the port, float32 on the CPU.

  * Swin DropPath against the JAX `DropPath`: the per-block rates equal the
    ones the JAX Swin gives its blocks, one keep mask gives x / keep * mask
    (the JAX module's output on the mask it drew) within 1e-6, eval mode
    drops nothing, and the masks follow the explicit generator (the same
    seed the same masks, another seed others, the global RNG untouched).
  * Swin `use_checkpoint`: the output and every parameter gradient equal
    those without it, with DropPath on and one generator seed, within 1e-6
    (a mask drawn again in a block's recompute would break this).
  * `remat_encoder` with each of the JAX save names, and
    `use_checkpoint_fusion`: the loss and every gradient of the tiny model
    in train mode (dropout on) equal those without, from one seed, within
    1e-6; the regions are checkpointed (counted), and a kept projection
    ("enc_ffn_out", "msda_value") runs its forward once (counted).
  * The kernels' autograd.Functions under non-reentrant checkpointing, with
    their launchers replaced by the plain versions (there is no kernel on
    the CPU): window attention's backward, which takes autograd inside
    autograd, gives the plain gradients, its forward runs again in the
    recompute and its backward once (counted); the MSDA Function with
    `keep` runs its forward once and its backward once, and without `keep`
    its forward twice. The kept linear's own VJP against autograd through
    `nn.Linear`, float32 and bf16 autocast; `backbone.use_checkpoint` on a
    ResNet raises.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rlipv2_tpu.models import swin as jax_swin
from rlipv2_tpu_torch.models import deformable, swin
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
from rlipv2_tpu_torch.ops import ms_deform_attn as msda
from rlipv2_tpu_torch.ops import window_attention as wa
from rlipv2_tpu_torch.ops.remat import kept_linear
from rlipv2_tpu_torch.tools.main_path import random_state_dict
from test_parseda_forward import tiny_config

torch.set_num_threads(2)

NARROW = swin.SwinSpec(16, (2, 2, 2, 2), (1, 2, 2, 4), 12)  # both shift branches at 118 x 166


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


# ---------------------------------------------------------------- DropPath


def test_drop_path_rates_match_the_jax_blocks():
    """Swin-L's 24 blocks: each port block's rate is the one the JAX Swin
    hands the block of the same stage and index (traced, not compiled)."""
    spec = swin.SWIN_SPECS["swin_large_384"]
    rates = {}

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, jax_swin.SwinBlock):
            rates[context.module.name] = context.module.drop_path
        return next_fun(*args, **kwargs)

    jm = jax_swin.SwinTransformer(jax_swin.SWIN_SPECS["swin_large_384"], drop_path_rate=0.2)
    with fnn.intercept_methods(interceptor):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    want = [rates[f"stage{s}_block{d}"] for s, depth in enumerate(spec.depths) for d in range(depth)]
    with torch.device("meta"):
        model = swin.SwinTransformer(spec, drop_path_rate=0.2)
    got = [blk.drop_path for layer in model.layers for blk in layer.blocks]
    assert len(got) == 24 and got == want == list(np.linspace(0, 0.2, 24))


def test_drop_path_matches_jax_on_its_mask():
    """The JAX module's output in train mode shows the mask it drew (a
    dropped sample is all zeros); the port's drop_path on that mask gives
    the same output, x / keep * mask, within 1e-6."""
    rate = 0.4
    x = np.random.RandomState(0).randn(16, 3, 5, 8).astype(np.float32) + 3.0  # no zero entries
    want = np.asarray(jax_swin.DropPath(rate).apply({}, jnp.asarray(x), deterministic=False,
                                                    rngs={"dropout": jax.random.PRNGKey(3)}))
    keep = np.any(want != 0, axis=(1, 2, 3)).astype(np.float32).reshape(16, 1, 1, 1)
    assert 0 < keep.sum() < 16  # some samples kept, some dropped
    got = swin.drop_path(torch.from_numpy(x), rate, torch.from_numpy(keep)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, x / (1 - rate) * keep, rtol=0, atol=1e-6)
    t = torch.from_numpy(x)
    assert swin.drop_path(t, rate, None) is t


def test_drop_path_is_the_identity_in_eval_mode():
    torch.manual_seed(0)
    dropping = swin.SwinTransformer.from_name("swin_test", drop_path_rate=0.5).eval()
    plain = swin.SwinTransformer.from_name("swin_test")
    plain.load_state_dict(dropping.state_dict())
    x = torch.randn(2, 40, 56, 3)
    with torch.no_grad():
        for a, b in zip(dropping(x, torch.Generator().manual_seed(0)), plain.eval()(x)):
            assert torch.equal(a, b)


def test_a_block_scales_what_it_keeps_and_skips_what_it_drops():
    """A sample whose two masks are 0 leaves the block as it came in; one
    whose masks are 1 gets both branches scaled by 1 / keep, which equals a
    rate-0 block whose branch-closing projections are scaled so."""
    torch.manual_seed(0)
    rate = 0.25
    blk = swin.SwinBlock(16, 2, 4, shift=0, drop_path=rate)
    scaled = swin.SwinBlock(16, 2, 4, shift=0)
    scaled.load_state_dict(blk.state_dict())
    with torch.no_grad():
        for lin in (scaled.attn.proj, scaled.mlp.fc2):
            lin.weight /= 1 - rate
            lin.bias /= 1 - rate
        x = torch.randn(2, 8, 8, 16)
        keep = torch.tensor([0.0, 1.0]).view(1, 2, 1, 1, 1).expand(2, 2, 1, 1, 1)
        out = blk(x, None, keep)
        assert torch.equal(out[0], x[0])
        np.testing.assert_allclose(out[1].numpy(), scaled(x[1:], None)[0].numpy(), rtol=0, atol=1e-6)


def test_drop_path_masks_follow_the_generator():
    model = swin.SwinTransformer.from_name("swin_test", drop_path_rate=0.5).train()
    state = torch.get_rng_state()
    a, b, c = (model.drop_path_masks(8, torch.Generator().manual_seed(s), "cpu") for s in (1, 1, 2))
    assert torch.equal(torch.get_rng_state(), state)
    assert a[0] is None and len(a) == 4  # the first block's rate is 0
    assert all(m.shape == (2, 8, 1, 1, 1) and set(m.unique().tolist()) <= {0.0, 1.0} for m in a[1:])
    assert all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
    assert not all(torch.equal(x, z) for x, z in zip(a[1:], c[1:]))
    assert model.eval().drop_path_masks(8, torch.Generator(), "cpu") == [None] * 4


# ---------------------------------------------------------------- Swin use_checkpoint


def test_swin_use_checkpoint_matches_plain(monkeypatch):
    torch.manual_seed(0)
    plain = swin.SwinTransformer(NARROW, drop_path_rate=0.3).train()
    remat = swin.SwinTransformer(NARROW, drop_path_rate=0.3, use_checkpoint=True).train()
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(2, 118, 166, 3)
    masks = remat.drop_path_masks(2, torch.Generator().manual_seed(5), "cpu")
    assert any(m is not None and not bool(m.all()) for m in masks)  # the seed drops some branches
    calls = _count_calls(monkeypatch, swin, "checkpoint")

    def run(model):
        outs = model(x, torch.Generator().manual_seed(5))
        cots = torch.Generator().manual_seed(9)
        loss = sum((o * torch.randn(o.shape, generator=cots)).sum() for o in outs)
        loss.backward()
        return outs, {k: p.grad for k, p in model.named_parameters()}

    (want, want_g), (got, got_g) = run(plain), run(remat)
    assert len(calls) == sum(NARROW.depths)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), rtol=0, atol=1e-6)
    for k, w in want_g.items():
        np.testing.assert_allclose(got_g[k].numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------- the encoder


def _tiny(**transformer):
    cfg = tiny_config()
    t = cfg.transformer
    cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(t, **transformer))
    model = RLIPParSeDA(cfg)
    model.load_state_dict(random_state_dict(model), strict=True)
    return model.train()


def _loss_and_grads(model):
    rng = np.random.RandomState(0)
    cfg = model.cfg
    T = cfg.max_obj_texts + cfg.max_verb_texts
    pixels = torch.from_numpy(rng.randint(0, 256, (2, 64, 80, 3)).astype(np.uint8))
    valid = torch.ones(2, 64, 80, dtype=torch.bool)
    valid[1, 50:] = False
    text = torch.from_numpy(rng.randn(2, T, cfg.text_encoder.hidden_size).astype(np.float32))
    torch.manual_seed(7)  # the dropout masks
    out = model(pixels, valid, text, torch.ones(2, T, dtype=torch.bool), cfg.max_obj_texts)
    keys = ("pred_obj_logits", "pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes", "lang_states")
    loss = sum((out[k] * torch.from_numpy(rng.randn(*out[k].shape).astype(np.float32))).sum() for k in keys)
    model.zero_grad(set_to_none=True)
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("option", [
    {"remat_encoder": True},  # the default save name, "msda_out"
    {"remat_encoder": True, "remat_save_names": ("enc_ffn_out",)},
    {"remat_encoder": True, "remat_save_names": ("msda_out", "msda_value", "enc_ffn_out")},
    {"remat_encoder": True, "remat_save_names": ()},
    {"fusion": "use_checkpoint_fusion"},
])
def test_encoder_remat_matches_plain(option, monkeypatch):
    if "fusion" in option:
        remat = _tiny(fusion=dataclasses.replace(tiny_config().transformer.fusion, use_checkpoint_fusion=True))
        regions = remat.cfg.transformer.enc_layers // remat.cfg.transformer.fusion.fusion_interval
    else:
        remat = _tiny(**option)
        regions = remat.cfg.transformer.enc_layers
    want_loss, want = _loss_and_grads(_tiny())
    calls = _count_calls(monkeypatch, deformable, "checkpoint")
    got_loss, got = _loss_and_grads(remat)
    assert len(calls) == regions
    assert got_loss == want_loss
    checked = 0
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)
        checked += 1
    assert checked > 100


def test_remat_is_off_without_gradients(monkeypatch):
    model = _tiny(remat_encoder=True).eval()
    calls = _count_calls(monkeypatch, deformable, "checkpoint")
    cfg = model.cfg
    T = cfg.max_obj_texts + cfg.max_verb_texts
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3, dtype=torch.uint8), torch.ones(1, 64, 64, dtype=torch.bool),
              torch.zeros(1, T, cfg.text_encoder.hidden_size), torch.ones(1, T, dtype=torch.bool))
    assert calls == []


def test_unknown_save_name_raises():
    with pytest.raises(ValueError, match="remat_save_names"):
        _tiny(remat_encoder=True, remat_save_names=("msda_out", "attn_probs"))


@pytest.mark.parametrize("save_names, layer, forwards", [
    (("enc_ffn_out",), "linear2", 1),
    ((), "linear2", 2),
    (("msda_value",), "self_attn.value_proj", 1),
    ((), "self_attn.value_proj", 2),
])
def test_a_kept_projection_runs_its_forward_once(save_names, layer, forwards, monkeypatch):
    """A kept projection's forward runs once per layer in a step, its
    backward taking no forward of its own; one not kept runs again in the
    layer's recompute."""
    model = _tiny(remat_encoder=True, remat_save_names=save_names)
    layers = model.transformer.encoder.layers
    weights = {id(enc.get_submodule(layer).weight) for enc in layers}
    calls = []
    linear = F.linear

    def counted(x, w, b=None):
        calls.append(id(w) in weights)
        return linear(x, w, b)

    monkeypatch.setattr(F, "linear", counted)
    _loss_and_grads(model)
    assert sum(calls) == forwards * len(layers)


@pytest.mark.parametrize("autocast", [False, True])
def test_kept_linear_matches_the_linears_autograd(autocast):
    """The kept linear's own VJP gives the output and gradients of
    autograd through `nn.Linear`, in float32 and under bf16 autocast."""
    torch.manual_seed(0)
    layer = torch.nn.Linear(24, 40)
    x = torch.randn(2, 5, 24, requires_grad=True)
    with torch.autocast("cpu", torch.bfloat16, enabled=autocast):
        got = kept_linear(layer, x, [])
        want = layer(x)
    assert got.dtype == want.dtype == (torch.bfloat16 if autocast else torch.float32)
    cot = torch.randn(got.shape).to(got.dtype)
    for g, w in zip(torch.autograd.grad(got, (x, layer.weight, layer.bias), cot),
                    torch.autograd.grad(want, (x, layer.weight, layer.bias), cot)):
        assert g.dtype == w.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6 * float(w.abs().max()))
    np.testing.assert_array_equal(got.detach().float().numpy(), want.detach().float().numpy())


def test_use_checkpoint_on_a_resnet_backbone_raises():
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, use_checkpoint=True))
    assert cfg.backbone.name.startswith("resnet")
    with pytest.raises(ValueError, match="use_checkpoint"):
        RLIPParSeDA(cfg)


# ---------------------------------------------------------------- the kernels' Functions


def test_window_attention_function_under_checkpoint(monkeypatch):
    rng = np.random.RandomState(0)
    h, N = 2, 16
    qkv = torch.from_numpy(rng.randn(4, N, 3 * h * 32).astype(np.float32)).requires_grad_()
    bias = torch.from_numpy(rng.randn(h, N, N).astype(np.float32)).requires_grad_()
    mask = torch.from_numpy(np.where(rng.rand(2, N, N) < 0.3, -100.0, 0.0).astype(np.float32))
    cot = torch.from_numpy(rng.randn(4, N, h * 32).astype(np.float32))
    launches = []

    def launch(q, b, m, heads):
        launches.append(1)
        return wa.window_attention_plain(q, b, m, heads)

    monkeypatch.setattr(wa, "_launch_kernel", launch)

    def region(q, b):
        return torch.sin(wa._WindowAttentionCUDA.apply(q, b, mask, h))

    backward_calls = wa.window_attention.backward_calls
    got = torch.autograd.grad(checkpoint(region, qkv, bias, use_reentrant=False), (qkv, bias), cot)
    assert len(launches) == 2  # the forward, and again in the recompute
    assert wa.window_attention.backward_calls == backward_calls + 1  # the backward once
    want = torch.autograd.grad(torch.sin(wa.window_attention_plain(qkv, bias, mask, h)), (qkv, bias), cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kept", [True, False])
def test_msda_function_keeps_its_output_under_checkpoint(kept, monkeypatch):
    rng = np.random.RandomState(1)
    shapes = ((6, 8), (3, 4))
    S = sum(a * b for a, b in shapes)
    value = torch.from_numpy(rng.randn(2, S, 2, 8).astype(np.float32)).requires_grad_()
    loc = torch.from_numpy(rng.rand(2, 5, 2, 2, 3, 2).astype(np.float32)).requires_grad_()
    attn = torch.from_numpy(rng.rand(2, 5, 2, 2, 3).astype(np.float32)).requires_grad_()
    cot = torch.from_numpy(rng.randn(2, 5, 16).astype(np.float32))
    fwd, bwd = [], []

    def launch(v, sh, lo, at):
        fwd.append(1)
        return msda.ms_deform_attn_plain(v, sh, lo, at)

    def launch_backward(v, sh, lo, at, g):
        bwd.append(1)
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in (v, lo, at)]
            return torch.autograd.grad(msda.ms_deform_attn_plain(xs[0], sh, xs[1], xs[2]), xs, g)

    monkeypatch.setattr(msda, "_launch_kernel", launch)
    monkeypatch.setattr(msda, "_launch_backward_kernel", launch_backward)

    def region(v, lo, at, keep):
        return torch.sin(msda._MSDeformAttnCUDA.apply(v * 1.5, shapes, lo, at, keep))

    out = checkpoint(region, value, loc, attn, [] if kept else None, use_reentrant=False)
    got = torch.autograd.grad(out, (value, loc, attn), cot)
    assert (len(fwd), len(bwd)) == ((1, 1) if kept else (2, 1))
    plain = torch.sin(msda.ms_deform_attn_plain(value * 1.5, shapes, loc, attn))
    want = torch.autograd.grad(plain, (value, loc, attn), cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)
