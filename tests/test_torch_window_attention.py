"""The port's plain window attention against the JAX package, in float32 on
CPU: against `_attn_reference` and against the Pallas kernel
`fused_window_attention` in interpret mode, at N = 49 (window 7) and
N = 144 (window 12), with and without the shift mask, within 2e-5 (the
atol of the JAX package's own kernel test); its gradients against
`jax.grad` through the kernel's custom_vjp within 1e-4 (the same test's
limit). Sizes are tiny (nW 2, B 2, h 2, d 32): the interpret mode costs
seconds a call. On CPU tensors the dispatcher takes the plain version and
launches nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rlipv2_tpu.ops.window_attention import _attn_reference, fused_window_attention
from rlipv2_tpu_torch.ops.window_attention import window_attention, window_attention_plain

torch.set_num_threads(2)

NW, B, H, D = 2, 2, 2, 32


def make(N, masked, seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(NW * B, N, 3 * H * D).astype(np.float32)
    bias = rng.randn(H, N, N).astype(np.float32)
    mask = np.where(rng.rand(NW, N, N) < 0.3, -100.0, 0.0).astype(np.float32) if masked else None
    return qkv, bias, mask


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _jax(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("N", [49, 144])
def test_plain_matches_jax_reference_and_interpret_kernel(N, masked):
    qkv, bias, mask = make(N, masked)
    got = window_attention_plain(_torch(qkv), _torch(bias), _torch(mask), H).numpy()
    ref = np.asarray(_attn_reference(_jax(qkv), _jax(bias), _jax(mask), H))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(fused_window_attention(_jax(qkv), _jax(bias), _jax(mask), H, 2))
    np.testing.assert_allclose(got, kern, atol=2e-5, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_plain_grads_match_jax_kernel_vjp(masked):
    qkv, bias, mask = make(49, masked, seed=1)

    def f(a, b):
        return jnp.sum(fused_window_attention(a, b, _jax(mask), H, 2) ** 2)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    tq, tb = _torch(qkv).requires_grad_(), _torch(bias).requires_grad_()
    (window_attention_plain(tq, tb, _torch(mask), H) ** 2).sum().backward()
    for g, w in ((tq.grad, want[0]), (tb.grad, want[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_dispatcher_takes_plain_on_cpu_and_launches_nothing():
    args = [_torch(a) for a in make(49, True)]
    before = window_attention.launches
    got = window_attention(*args, H)
    assert window_attention.launches == before
    np.testing.assert_array_equal(got.numpy(), window_attention_plain(*args, H).numpy())
