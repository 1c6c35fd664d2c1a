"""Multi-scale deformable attention in the torch port against the JAX
package: the port's plain gather version and its per-level version vs JAX
`ms_deform_attn(impl="xla")` and `ms_deform_attn_reference`, all float32.
The plain version's gradients are also held against jax.grad of the
Pallas path (the TPU backward kernel, in interpret mode), the oracle of the
CUDA backward kernel. The CUDA kernels are held against the plain version
on the GPU only (tests/test_torch_kernels_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rlipv2_tpu.models.deformable import encoder_reference_points as jax_encoder_reference_points
from rlipv2_tpu.models.layers import sampling_offset_bias_init as jax_sampling_offset_bias_init
from rlipv2_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from rlipv2_tpu.ops.ms_deform_attn import ms_deform_attn_reference as jax_msda_reference
from rlipv2_tpu_torch.ops import cuda_build
from rlipv2_tpu_torch.ops.ms_deform_attn import (
    ms_deform_attn,
    ms_deform_attn_int8_plain,
    ms_deform_attn_plain,
    ms_deform_attn_reference,
)
from rlipv2_tpu_torch.tools.msda_locations import INIT_GRID_NOISE_PX, TIGHT_SIGMA_PX, encoder_locations

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5  # float32, unit-scale values, 4-64 bilinear terms per output
SHAPES = ((6, 8), (3, 5), (2, 2))  # odd widths exercise the level strides


def make_inputs(seed, B=2, Q=7, H=4, D=8, P=3, lo=0.0, hi=1.0, anchors=False, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = rng.randn(B, S, H, D).astype(np.float32)
    if anchors:  # decoder: 4-d anchors, loc = centre + offset / P * wh * 0.5
        box = rng.uniform(0.05, 0.95, size=(B, Q, 1, 1, 1, 4))
        off = rng.randn(B, Q, H, L, P, 2)
        loc = (box[..., :2] + off / P * box[..., 2:] * 0.5).astype(np.float32)
    else:
        loc = rng.uniform(lo, hi, size=(B, Q, H, L, P, 2)).astype(np.float32)
    attn = rng.rand(B, Q, H, L, P).astype(np.float32)
    attn /= attn.sum(axis=(-2, -1), keepdims=True)
    return value, loc, attn


CASES = {
    # encoder self-attention: Q = S queries over every level
    "encoder": dict(seed=0, Q=sum(h * w for h, w in SHAPES)),
    "out_of_bounds": dict(seed=1, lo=-0.2, hi=1.2),
    "decoder_4d_q7": dict(seed=2, Q=7, anchors=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax(case):
    value, loc, attn = make_inputs(**CASES[case])
    want_xla = np.asarray(jax_msda(jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(attn), impl="xla"))
    want_ref = np.asarray(jax_msda_reference(jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(attn)))
    t = [torch.from_numpy(a) for a in (value, loc, attn)]
    got_plain = ms_deform_attn_plain(t[0], SHAPES, t[1], t[2]).numpy()
    got_ref = ms_deform_attn_reference(t[0], SHAPES, t[1], t[2]).numpy()
    assert got_plain.shape == want_xla.shape
    np.testing.assert_allclose(got_plain, want_xla, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_plain, want_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_ref, want_ref, atol=ATOL, rtol=0)


GRAD_ATOL = 2e-5  # float32; d loc carries the level widths (up to 8) as a factor


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_grad_matches_jax(case):
    """d(value, loc, attn) of <out, cotangent> through the CPU path vs
    jax.grad of impl="xla": the oracle the CUDA backward will be held to."""
    value, loc, attn = make_inputs(**CASES[case])
    B, Q, H = attn.shape[:3]
    cot = np.random.RandomState(100).randn(B, Q, H * value.shape[-1]).astype(np.float32)

    def jax_loss(v, l, a):
        return jnp.sum(jax_msda(v, SHAPES, l, a, impl="xla") * cot)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    t = [torch.from_numpy(a).requires_grad_() for a in (value, loc, attn)]
    (ms_deform_attn(t[0], SHAPES, t[1], t[2]) * torch.from_numpy(cot)).sum().backward()
    for name, got, w in zip(("value", "loc", "attn"), t, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0, err_msg=name)


PALLAS_REL = 1e-4  # of max|grad|, float32; as tests/test_msda_v4.py holds the Pallas grads


@pytest.mark.parametrize("case", ["encoder", "out_of_bounds", "decoder_4d_q7"])
def test_plain_grad_matches_jax_pallas_backward(case):
    """The oracle of the CUDA backward kernel against the TPU backward kernel
    itself: grads of the port's plain version vs jax.grad of
    impl="pallas" (`_v4_bwd_kernel` plus the vjp of `_separable_prepare`),
    the Pallas kernels run in interpret mode on the CPU."""
    value, loc, attn = make_inputs(**CASES[case])
    B, Q, H = attn.shape[:3]
    cot = np.random.RandomState(101).randn(B, Q, H * value.shape[-1]).astype(np.float32)

    def jax_loss(v, l, a):
        return jnp.sum(jax_msda(v, SHAPES, l, a, impl="pallas") * cot)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    t = [torch.from_numpy(a).requires_grad_() for a in (value, loc, attn)]
    (ms_deform_attn_plain(t[0], SHAPES, t[1], t[2]) * torch.from_numpy(cot)).sum().backward()
    for name, got, w in zip(("value", "loc", "attn"), t, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got.grad.numpy() / scale, w / scale, atol=PALLAS_REL, rtol=0, err_msg=name)


def _launch_counts():
    return (ms_deform_attn.launches, ms_deform_attn.backward_launches, ms_deform_attn.int8_launches,
            dict(ms_deform_attn.designs), dict(ms_deform_attn.backward_designs),
            dict(ms_deform_attn.int8_designs))


@pytest.mark.parametrize("impl", ["auto", "pallas_int8"])
def test_cpu_call_takes_plain_version_and_counts_no_launch(impl):
    """A CPU tensor takes the plain version (the exact one with its
    autograd, or the int8 one) and leaves every launch and design count
    as it was."""
    value, loc, attn = make_inputs(3)
    t = [torch.from_numpy(a) for a in (value, loc, attn)]
    before = _launch_counts()
    if impl == "pallas_int8":
        with torch.no_grad():
            out = ms_deform_attn(t[0], SHAPES, t[1], t[2], impl=impl)
        want = ms_deform_attn_int8_plain(t[0], SHAPES, t[1], t[2])
    else:
        t[0].requires_grad_()
        out = ms_deform_attn(t[0], SHAPES, t[1], t[2], impl=impl)
        out.sum().backward()
        want = ms_deform_attn_plain(t[0], SHAPES, t[1], t[2])
    assert _launch_counts() == before
    np.testing.assert_array_equal(out.detach().numpy(), want.detach().numpy())


@pytest.mark.parametrize("spread", ["init_grid", "tight"])
def test_encoder_locations_are_reference_points_plus_offsets(spread):
    """The locations that the kernels are timed and tested at
    (`tools/msda_locations.py`) against the JAX package's reference points
    and sampling-offset init: each token's pixel centre plus, in level
    pixels over the level's (w, h), the init grid (init_grid only) and the
    noise that the same generator draws."""
    B, H, P, Q, L = 2, 4, 3, 50, len(SHAPES)
    got = encoder_locations(spread, SHAPES, B, H, P, torch.Generator().manual_seed(3), Q=Q).numpy()
    noise = torch.randn(B, Q, H, L, P, 2, generator=torch.Generator().manual_seed(3)).numpy()
    px = TIGHT_SIGMA_PX * noise
    if spread == "init_grid":
        grid = np.asarray(jax_sampling_offset_bias_init(H, L, P)(None, None)).reshape(H, L, P, 2)
        px = grid + INIT_GRID_NOISE_PX * noise
    ref = np.asarray(jax_encoder_reference_points(SHAPES, jnp.ones((B, L, 2))))[:, :Q]  # (B, Q, L, 2)
    wh = np.array([[w, h] for h, w in SHAPES], np.float32)[:, None, :]
    want = ref[:, :, None, :, None, :] + px / wh
    assert got.shape == (B, Q, H, L, P, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_plain_returns_value_dtype_from_float32_sums():
    value, loc, attn = make_inputs(4)
    v16 = torch.from_numpy(value).bfloat16()
    out = ms_deform_attn(v16, SHAPES, torch.from_numpy(loc), torch.from_numpy(attn))
    assert out.dtype == torch.bfloat16
    want = ms_deform_attn_plain(v16.float(), SHAPES, torch.from_numpy(loc), torch.from_numpy(attn))
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), atol=2e-2, rtol=0)


KERNEL_SOURCES = ["ms_deform_attn_fwd.cu", "ms_deform_attn_bwd.cu", "ms_deform_attn_int8_fwd.cu"]


@pytest.mark.parametrize("source", KERNEL_SOURCES)
def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path, source):
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(source)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("source", KERNEL_SOURCES)
def test_kernel_library_is_named_by_source_hash(monkeypatch, tmp_path, source):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    path = cuda_build.library_path(source)
    assert path.parent == tmp_path
    assert path.name.startswith(source.replace(".cu", "-")) and path.suffix == ".so"
    assert path == cuda_build.library_path(source)
