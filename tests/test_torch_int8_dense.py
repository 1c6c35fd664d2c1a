"""The port's quantized inference path against the JAX package, in float32
on CPU:
  * `int8_matmul`, `quantize_symmetric` and `Int8Linear` vs JAX
    `int8_matmul` / `Int8Dense` (the integer codes equal, the results within
    1e-6 relative), the nn.Linear state-dict contract and the inference-only
    guard;
  * one `MSDeformAttention` with impl "pallas_int8" and int8_dense, and the
    Swin backbone with int8_dense, vs their JAX counterparts;
  * the whole slice: RLIP-ParSeDA with both int8 options, built from the
    same numpy weights through `engine/convert`, vs the JAX model with the
    Pallas `_v4_int8_kernel` in interpret mode;
  * the port's `eval/int8_gate.py` vs the JAX one on the same result dicts;
  * a train step with an int8 option raises.
The CUDA kernel and `torch._int_mm` on the card are held in
tests/test_torch_kernels_cuda.py."""

import dataclasses

try:
    # imported while every xdist worker collects, before any test runs:
    # tests/test_heatmap_targets.py and tests/test_vg_preprocess.py put a
    # spec-less `cv2` stub in sys.modules when they run, after which a first
    # `import transformers` in the same worker raises ValueError, so the
    # tests that use transformers passed or failed with the schedule
    import transformers  # noqa: F401
except ImportError:
    pass

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rlipv2_tpu.config import BackboneConfig
from rlipv2_tpu.eval import int8_gate as jax_gate
from rlipv2_tpu.models import layers as jlay
from rlipv2_tpu.models import swin as jax_swin
from rlipv2_tpu.models.parseda import RLIPParSeDA as JaxRLIPParSeDA
from rlipv2_tpu.models.parseda import init_model_params
from rlipv2_tpu.ops import int8_dense as jax_i8
from rlipv2_tpu_torch.engine import convert
from rlipv2_tpu_torch.engine.loops import train_one_epoch
from rlipv2_tpu_torch.engine.train import check_trainable, make_train_step
from rlipv2_tpu_torch.eval import int8_gate
from rlipv2_tpu_torch.models import layers, swin
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
from rlipv2_tpu_torch.ops.int8_dense import Int8Linear, int8_matmul, linear, quantize_symmetric
from test_parseda_forward import tiny_config
from test_torch_modules import SHAPES, S, load
from test_torch_parseda import random_params

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REL = 1e-6  # the same integer sums; the float32 rescale in another order


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", [(37, 24, 40), (2, 5, 64, 48), (3, 7, 5)])  # (..., Cin, Cout)
def test_int8_matmul_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    *lead, cin, cout = shape
    x = rng.randn(*lead, cin).astype(np.float32) * 2
    x[..., 0, :] = 0.0  # an all-zero token: the 1e-12 scale floor
    kernel = (rng.randn(cin, cout) / np.sqrt(cin)).astype(np.float32)
    want = jax.jit(jax_i8.int8_matmul)(jnp.asarray(x), jnp.asarray(kernel))
    got = int8_matmul(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(kernel.T)))
    _close(got, want)
    for arr, jax_axis, dim in ((x, -1, -1), (kernel.T, 1, 1)):
        q, s = quantize_symmetric(torch.from_numpy(np.ascontiguousarray(arr)), dim=dim)
        wq, ws = jax.jit(jax_i8.quantize_symmetric, static_argnames="axis")(jnp.asarray(arr), axis=jax_axis)
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        # jitted, XLA turns `amax / 127` into a multiply by the rounded
        # reciprocal, which may move the scale by one ulp
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=2.5e-7, atol=0)


def test_int8_linear_matches_jax_int8_dense_and_loads_linear_weights():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 24).astype(np.float32)
    jm = jax_i8.Int8Dense(40)
    bias = (0.1 * rng.randn(40)).astype(np.float32)
    params = {"kernel": jnp.asarray((rng.randn(24, 40) / np.sqrt(24)).astype(np.float32)), "bias": jnp.asarray(bias)}
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))

    m = linear(24, 40, int8=True)
    assert isinstance(m, Int8Linear) and type(linear(24, 40)) is torch.nn.Linear
    dense = torch.nn.Linear(24, 40)
    dense.load_state_dict({"weight": torch.from_numpy(np.asarray(params["kernel"]).T.copy()),
                           "bias": torch.from_numpy(bias)})
    m.load_state_dict(dense.state_dict(), strict=True)  # nn.Linear's keys and shapes
    before = Int8Linear.calls
    with torch.no_grad():
        got = m(torch.from_numpy(x))
        assert got.dtype == torch.float32
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert m(torch.from_numpy(x)).dtype == torch.bfloat16  # the autocast dtype, as JAX's dtype
    assert Int8Linear.calls == before + 2
    _close(got, want)
    with pytest.raises(RuntimeError, match="inference only"):
        m(torch.from_numpy(x))  # grad enabled and the weight requires grad


def test_int8_ms_deform_attention_layer():
    """value_proj and output_proj int8, offsets and weights float, the
    int8 MSDA in the middle, vs the JAX layer with both options (4-d
    reference boxes, as the decoders give them; the 2-d encoder form
    differs only in the float location math of test_torch_modules.py)."""
    rng = np.random.RandomState(19)
    q = rng.randn(2, 9, 32).astype(np.float32)
    value = rng.randn(2, S, 32).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (2, 9, 3, 4)).astype(np.float32)
    valid = np.ones((2, S), bool)
    valid[1, 30:] = False
    jm = jlay.MSDeformAttention(d_model=32, n_levels=3, n_heads=4, n_points=3, impl="pallas_int8",
                                int8_dense=True)
    args = (jnp.asarray(q), jnp.asarray(ref), jnp.asarray(value), SHAPES, jnp.asarray(valid))
    # the param tree does not depend on the impl; "xla" skips tracing the kernel
    init_layer = jlay.MSDeformAttention(d_model=32, n_levels=3, n_heads=4, n_points=3, impl="xla",
                                        int8_dense=True)
    params = random_params(lambda: init_layer.init(jax.random.PRNGKey(0), *args), seed=5)["params"]
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p: jm.apply({"params": p}, *args))(params)
    m = load(layers.MSDeformAttention(32, 3, 4, 3, impl="pallas_int8", int8_dense=True),
             convert.msda(params, "a"), "a.")
    assert [type(getattr(m, k)) for k in ("value_proj", "output_proj", "sampling_offsets", "attention_weights")] \
        == [Int8Linear, Int8Linear, torch.nn.Linear, torch.nn.Linear]
    with torch.no_grad():
        got = m(*(torch.from_numpy(a) for a in (q, ref, value)), SHAPES, torch.from_numpy(valid))
    _close(got, want, 1e-5)


def _jax_int8_dense_calls(jm, params, x):
    """(outputs, {module path: (input, output)} of every Int8Dense call) of
    one jitted JAX apply; paths as "stage0_block1/attn/qkv"."""

    def run(params, x):
        calls = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, jax_i8.Int8Dense) and context.method_name == "__call__":
                calls["/".join(context.module.path)] = (args[0], out)
            return out

        with flax.linen.intercept_methods(record):
            return jm.apply(params, x), calls

    want, calls = jax.jit(run)(params, x)
    return want, {k: (np.array(a), np.array(b)) for k, (a, b) in calls.items()}


def _port_name(jax_path: str) -> str:
    """stage{s}_block{b}/attn/qkv -> layers.{s}.blocks.{b}.attn.qkv, .../mlp_fc1 -> ...mlp.fc1"""
    block, *rest = jax_path.split("/")
    st, b = block.removeprefix("stage").split("_block")
    tail = {"attn/qkv": "attn.qkv", "attn/proj": "attn.proj", "mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2"}
    return f"layers.{st}.blocks.{b}.{tail['/'.join(rest)]}"


# End to end the int8 Swin drifts from the JAX one by more than the float
# backbone's 1e-4. The port's and the JAX activations differ by float32
# noise (~1e-6: sums in another order), and where such noise moves an
# activation across a rounding boundary its code flips by one. At this size
# and seed that happens once: 1 of the 24 576 codes entering stage 1's qkv.
# The flipped code changes that token's q, k and v, so the attention of its
# whole window, and every later block spreads it: the outputs drift by up to
# 1.7 % of max|out| (stage 3). The test holds every int8 layer, fed the JAX
# layer's own input, to the JAX output within 1e-6; counts the codes that
# flip where the two inputs differ by float noise only (NOISE, at most
# MAX_NOISE_FLIPS, each by one code); and bounds the end-to-end drift by
# SWIN_DRIFT of max|out|, which covers one flipped quantum spread over three
# stages.
NOISE = 1e-5
MAX_NOISE_FLIPS = 4
SWIN_DRIFT = 3e-2
SWIN_LAYERS = ("attn/qkv", "attn/proj", "mlp_fc1", "mlp_fc2")  # call order in a block


def test_int8_swin_matches_jax():
    """`swin_test` at 72x104 (every stage pads) with int8_dense: qkv, proj
    and the MLP int8, PatchMerging's reduction float."""
    H, W = 72, 104
    jm = jax_swin.SwinTransformer(jax_swin.SWIN_SPECS["swin_test"], int8_dense=True)
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))), seed=0)
    tspec = swin.SWIN_SPECS["swin_test"]
    model = swin.SwinTransformer(tspec, int8_dense=True)
    sd = convert.swin(params["params"], tspec, "")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    assert type(model.layers[0].downsample.reduction) is torch.nn.Linear
    x = np.random.RandomState(1).randn(2, H, W, 3).astype(np.float32)
    want, jax_calls = _jax_int8_dense_calls(jm, params, jnp.asarray(x))

    port_inputs = {}
    modules = dict(model.named_modules())
    hooks = [m.register_forward_hook(lambda mod, i, o, name=name: port_inputs.__setitem__(name, i[0]))
             for name, m in modules.items() if isinstance(m, Int8Linear)]
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    order = [f"stage{s}_block{b}/{n}" for s, d in enumerate(tspec.depths) for b in range(d) for n in SWIN_LAYERS]
    assert sorted(order) == sorted(jax_calls) and sorted(port_inputs) == sorted(map(_port_name, order))

    noise_flips = {}
    for path in order:
        xin, yout = jax_calls[path]
        layer = modules[_port_name(path)]
        with torch.no_grad():
            _close(layer(torch.from_numpy(xin)), yout)
        ours = port_inputs[_port_name(path)].reshape(xin.shape)
        if float((ours - torch.from_numpy(xin)).abs().max()) > NOISE:
            continue  # downstream of a flip: the inputs differ by more than noise
        # codes of both inputs by the port's quantizer, held equal to JAX's above
        delta = (quantize_symmetric(ours, dim=-1)[0].int() - quantize_symmetric(torch.from_numpy(xin), dim=-1)[0].int())
        assert int(delta.abs().max()) <= 1, path
        noise_flips[path] = int((delta != 0).sum())
    assert all(noise_flips[f"stage0_block0/{n}"] == 0 for n in SWIN_LAYERS)
    assert sum(noise_flips.values()) <= MAX_NOISE_FLIPS, noise_flips
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(g.permute(0, 2, 3, 1).numpy() - w).max()) <= SWIN_DRIFT * float(np.abs(w).max())


def _int8_config():
    """The tiny config with both int8 options."""
    cfg = tiny_config()
    return dataclasses.replace(
        cfg,
        backbone=dataclasses.replace(cfg.backbone, int8_dense=True),
        transformer=dataclasses.replace(cfg.transformer, msda_impl="pallas_int8", int8_dense=True),
    )


# The whole slice: logits and boxes within the port's model tolerance. At
# this size and seed no activation code flips between the two (they agree to
# ~1e-6); one flipped code moves a logit by ~1e-2 (seen with one decoder
# layer instead of two), so this bound also shows that none flipped.
ATOL = 2e-3
OUT_KEYS = ("pred_obj_logits", "pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes")


@pytest.fixture(scope="module")
def int8_pair():
    """(cfg, jax outputs, torch outputs) of the tiny model with both int8
    options on one batch (odd size, a padded and an all-padded image). The
    JAX forward runs once, its int8 MSDA kernel in interpret mode."""
    cfg = _int8_config()
    jm = JaxRLIPParSeDA(cfg)
    T = cfg.max_obj_texts + cfg.max_verb_texts
    # the param tree does not depend on the MSDA impl: trace the init with
    # "xla", which skips tracing the Pallas kernel
    init_model = JaxRLIPParSeDA(dataclasses.replace(
        cfg, transformer=dataclasses.replace(cfg.transformer, msda_impl="xla")))
    params = random_params(lambda: init_model_params(
        init_model, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 64, 64), bool),
        jnp.zeros((1, T, cfg.text_encoder.hidden_size)), jnp.ones((1, T), bool),
        cfg.max_obj_texts, jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32),
    ), seed=0)
    model = RLIPParSeDA(cfg).eval()
    sd = convert.state_dict_from_jax(params, cfg)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, strict=True)

    rng = np.random.RandomState(1)
    B, H, W = 2, 61, 83
    pixels = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    valid = np.ones((B, H, W), bool)
    valid[0, 40:, :] = False
    valid[0, :, 57:] = False
    valid[1] = False
    text = rng.randn(B, T, cfg.text_encoder.hidden_size).astype(np.float32)
    text_valid = np.ones((B, T), bool)
    text_valid[:, 3] = False
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, *a: jm.apply(p, *a, cfg.max_obj_texts))(
            params, jnp.asarray(pixels), jnp.asarray(valid), jnp.asarray(text), jnp.asarray(text_valid))
    inputs = [torch.from_numpy(a) for a in (pixels, valid, text, text_valid)]
    calls = Int8Linear.calls
    with torch.no_grad():
        got = model(*inputs, cfg.max_obj_texts)
    n_int8 = sum(isinstance(m, Int8Linear) for m in model.modules())
    return cfg, want, got, Int8Linear.calls - calls, n_int8, model, inputs


def test_int8_model_matches_jax(int8_pair):
    cfg, want, got, calls, n_int8, _, _ = int8_pair
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == cfg.transformer.dec_layers - 1
    for g, w in [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"])):
        for k in OUT_KEYS:
            assert np.isfinite(g[k].numpy()).all(), k
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), atol=ATOL, rtol=0, err_msg=k)
    # every int8 projection ran once: 2 encoder + 2 x 2 decoder layers x 4
    # (value, output, linear1, linear2), 1 fusion block x 6
    assert n_int8 == 4 * (2 + 2 * 2) + 6 and calls == n_int8


def test_int8_model_differs_from_the_exact_one(int8_pair):
    """The exact model with the same weights (the state-dict layouts are
    the same) gives other outputs, so the comparison above is not vacuous."""
    cfg, _, got, _, _, model, inputs = int8_pair
    exact = RLIPParSeDA(dataclasses.replace(cfg, backbone=tiny_config().backbone, transformer=dataclasses.replace(
        cfg.transformer, msda_impl="auto", int8_dense=False))).eval()
    assert [(k, v.shape) for k, v in exact.state_dict().items()] == \
        [(k, v.shape) for k, v in model.state_dict().items()]
    exact.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        ref = exact(*inputs, cfg.max_obj_texts)
    for k in OUT_KEYS:
        assert float((got[k] - ref[k]).abs().max()) > 1e-5, k


def _results(rng, n_images=4, nq=6, n_verb=5, n_obj=4):
    out = []
    for _ in range(n_images):
        xy = rng.uniform(0, 400, (2 * nq, 2)).astype(np.float32)
        wh = rng.uniform(20, 200, (2 * nq, 2)).astype(np.float32)
        out.append({
            "labels": np.concatenate([np.zeros(nq, np.int64), rng.randint(0, n_obj, nq)]),
            "boxes": np.concatenate([xy, xy + wh], 1),
            "verb_scores": rng.rand(nq, n_verb).astype(np.float32),
            "sub_ids": np.arange(nq),
            "obj_ids": np.arange(nq, 2 * nq),
        })
    return out


def test_map_delta_points_matches_jax():
    rng = np.random.RandomState(0)
    exact = _results(rng)
    quant = [{**r, "verb_scores": r["verb_scores"] * (1 + 0.05 * rng.randn(*r["verb_scores"].shape))}
             for r in exact]
    got, want = int8_gate.map_delta_points(exact, quant, 5, 4), jax_gate.map_delta_points(exact, quant, 5, 4)
    assert got == want and got[0] > 0.0
    for g, w in zip(int8_gate.canned_gt_from_results(exact), jax_gate.canned_gt_from_results(exact)):
        for k in ("boxes", "labels", "hois"):
            np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(AssertionError, match="bit-identical"):
        int8_gate.map_delta_points(exact, exact, 5, 4)


@pytest.mark.parametrize("option", ["msda", "transformer_dense", "backbone_dense"])
def test_train_step_with_an_int8_option_raises(option):
    cfg = tiny_config()
    if option == "msda":
        cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(cfg.transformer, msda_impl="pallas_int8"))
    elif option == "transformer_dense":
        cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(cfg.transformer, int8_dense=True))
    else:
        cfg = dataclasses.replace(cfg, backbone=BackboneConfig(name="resnet_test", num_outputs=3, int8_dense=True))
    with pytest.raises(ValueError, match="inference only"):
        check_trainable(cfg)
    model = RLIPParSeDA(cfg)
    with pytest.raises(ValueError, match="inference only"):
        make_train_step(model, None, None, None, None)
    with pytest.raises(ValueError, match="inference only"):
        train_one_epoch(None, model, None, [], 1, cfg, None)
    check_trainable(tiny_config())
