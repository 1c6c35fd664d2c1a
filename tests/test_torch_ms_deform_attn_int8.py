"""The int8 MSDA forward of the torch port (impl "pallas_int8") against the
JAX package: `ms_deform_attn_int8_plain`, the CPU path and the oracle of
the CUDA kernel csrc/ms_deform_attn_int8_fwd.cu, vs JAX
`ms_deform_attn(..., impl="pallas_int8")`, whose Pallas kernel
`_v4_int8_kernel` runs in interpret mode, on the four cases of
tests/test_msda_v3.py. Also: the value codes vs the JAX wrapper's
expression, half-to-even rounding of the mixer codes, the `impl` names,
and the forward-only contract. The kernel itself is held against the plain
version on the GPU (tests/test_torch_kernels_cuda.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rlipv2_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from rlipv2_tpu_torch.config import TransformerConfig
from rlipv2_tpu_torch.models.parseda import check_supported
from rlipv2_tpu_torch.ops.ms_deform_attn import (
    EXACT_IMPLS,
    _int8_mixer,
    ms_deform_attn,
    ms_deform_attn_int8_plain,
    ms_deform_attn_plain,
    quantize_value_int8,
)
from test_msda_v3 import CASES, make_inputs
from test_parseda_forward import tiny_config

torch.set_num_threads(2)

# float32: the same codes on both sides, sums in another order
REL_TOL = 1e-5
# against the exact function: the JAX package's own bound on the int8 path
# (tests/test_msda_v4.py), per-level value codes and x127 mixer codes
FIDELITY = 2e-2


def _jax_int8(value, shapes, loc, attn):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax_msda(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn),
                                   impl="pallas_int8"))


def _case(case):
    shapes, B, H, D, P, Q, seed, loc_range, local = case
    value, loc, attn = make_inputs(shapes, B, H, D, P, Q, seed, loc_range, local)
    return shapes, np.array(value), np.array(loc), np.array(attn)


@pytest.mark.parametrize("case", CASES, ids=["global_oob", "local", "decoder", "one_level_wide_oob"])
def test_int8_plain_matches_jax_pallas_int8(case):
    shapes, value, loc, attn = _case(case)
    want = _jax_int8(value, shapes, loc, attn)
    got = ms_deform_attn_int8_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                    torch.from_numpy(attn)).numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= REL_TOL * scale

    exact = np.asarray(jax_msda(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn), impl="xla"))
    err = float(np.abs(got - exact).max())
    assert 0.0 < err <= FIDELITY * float(np.abs(exact).max()), err


def test_value_codes_match_the_jax_wrapper_expression():
    """Per (b, h, level, channel): s = max(max|v|, 1e-6), q = clip(round(v *
    (127 / s)), -127, 127), the expression of ms_deform_attn_v4.py:986-1002
    in jnp, on a bf16 value with an all-zero channel (the 1e-6 floor)."""
    shapes, B, H, D = ((5, 6), (2, 3)), 2, 3, 8
    S = sum(h * w for h, w in shapes)
    v = np.random.RandomState(0).randn(B, S, H, D).astype(np.float32) * 3
    v[:, :30, 1, 2] = 0.0
    vb = torch.from_numpy(v).bfloat16()
    q8, scales = quantize_value_int8(vb, shapes)

    @jax.jit
    def codes(piece):
        s = jnp.maximum(jnp.max(jnp.abs(piece), axis=1), 1e-6)
        return jnp.clip(jnp.round(piece * (127.0 / s[:, None])), -127, 127).astype(jnp.int8), s

    vf = vb.float().numpy()
    off = 0
    for lvl, (h, w) in enumerate(shapes):
        want, s = codes(jnp.asarray(vf[:, off : off + h * w]))
        np.testing.assert_array_equal(q8[:, off : off + h * w].numpy(), np.asarray(want))
        np.testing.assert_array_equal(scales[:, :, lvl].numpy(), np.asarray(s))
        off += h * w
    assert q8.dtype == torch.int8 and tuple(scales.shape) == (B, H, len(shapes), D)


# float32 sampling x-coordinates at which wx0 / colmax * 127 is exactly
# k + 0.5 on a level of width 8 with attention weight 1 (found by search)
TIES = {14: 0.4246908128261566, 44: 0.4050655961036682}


@pytest.mark.parametrize("k", sorted(TIES))
def test_mixer_code_ties_round_to_even(k):
    """A hand-made point whose column code is exactly k + 0.5 (k even):
    round half to even gives k, as jnp.round does; rounding half away
    from zero would give k + 1 and move the output by colmax / 127."""
    shapes = ((4, 8),)
    loc = np.zeros((1, 1, 1, 1, 1, 2), np.float32)
    loc[..., 0] = TIES[k]
    loc[..., 1] = 0.375  # y = 1.0 exactly: row 1 only, weight 1
    attn = np.ones((1, 1, 1, 1, 1), np.float32)
    value = np.zeros((1, 32, 1, 1), np.float32)
    value[0, 1 * 8 + 2] = 1.0  # row 1, column x0 = 2: code 127, scale 1

    x = np.float32(TIES[k]) * np.float32(8) - np.float32(0.5)
    fx = x - np.floor(x)
    assert np.floor(x) == 2 and (np.float32(1) - fx) / fx * np.float32(127) == k + 0.5
    _, _, c0, c1, r0, _ = _int8_mixer(shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    assert float(c0) == k and float(c1) == 127 and float(r0) == float(fx)

    got = ms_deform_attn_int8_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                    torch.from_numpy(attn)).item()
    want_even = float(fx) * 127 * k / (127 * 127)
    assert abs(got - want_even) <= 1e-6
    assert abs(got - float(fx) * 127 * (k + 1) / (127 * 127)) > 1e-3
    np.testing.assert_allclose(_jax_int8(value, shapes, loc, attn).ravel(), [got], rtol=1e-6)


def test_impl_names_map_as_the_jax_package():
    shapes, value, loc, attn = _case(CASES[0])
    t = [torch.from_numpy(a) for a in (value, loc, attn)]
    plain = ms_deform_attn_plain(t[0], shapes, t[1], t[2])
    for impl in (*EXACT_IMPLS, "xla"):
        assert torch.equal(ms_deform_attn(t[0], shapes, t[1], t[2], impl=impl), plain), impl
    assert torch.equal(ms_deform_attn(t[0], shapes, t[1], t[2], impl="pallas_int8"),
                       ms_deform_attn_int8_plain(t[0], shapes, t[1], t[2]))
    with pytest.raises(NotImplementedError, match="pallas_zerograd"):
        ms_deform_attn(t[0], shapes, t[1], t[2], impl="pallas_zerograd")
    with pytest.raises(ValueError, match="unknown"):
        ms_deform_attn(t[0], shapes, t[1], t[2], impl="cuda")

    def cfg_with(impl, **kw):
        c = tiny_config()
        return dataclasses.replace(c, transformer=dataclasses.replace(c.transformer, msda_impl=impl, **kw))

    for impl in (*EXACT_IMPLS, "xla", "pallas_int8"):
        check_supported(cfg_with(impl, int8_dense=True))
    with pytest.raises(NotImplementedError, match="pallas_zerograd"):
        check_supported(cfg_with("pallas_zerograd"))
    with pytest.raises(ValueError, match="unknown msda_impl"):
        check_supported(cfg_with("fast"))
    assert TransformerConfig().msda_impl == "auto"


@pytest.mark.parametrize("which", ["value", "loc", "attn"])
def test_int8_path_refuses_inputs_that_require_grad(which):
    shapes, value, loc, attn = _case(CASES[2])
    t = dict(zip(("value", "loc", "attn"), (torch.from_numpy(a) for a in (value, loc, attn))))
    t[which].requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        ms_deform_attn(t["value"], shapes, t["loc"], t["attn"], impl="pallas_int8")
    with torch.no_grad():  # under no_grad nothing requires grad: it runs
        ms_deform_attn(t["value"] * 1, shapes, t["loc"] * 1, t["attn"] * 1, impl="pallas_int8")
