"""The port's CUDA kernels on the GPU. They have no CPU mode, so every test
here is marked `cuda` and skips where torch sees no CUDA device. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain

pytestmark = pytest.mark.cuda

SHAPES = ((6, 8), (3, 5), (2, 2))
CASES = {  # (seed, Q, loc range)
    "encoder": (0, sum(h * w for h, w in SHAPES), 0.0, 1.0),
    "out_of_bounds": (1, 7, -0.2, 1.2),
    "many_queries": (2, 5000, 0.0, 1.0),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(seed, Q, lo, hi, device, B=2, H=4, D=40, P=3):
    """D = 40 covers the kernel's channel loop past one warp."""
    rng = np.random.RandomState(seed)
    L, S = len(SHAPES), sum(h * w for h, w in SHAPES)
    value = rng.randn(B, S, H, D).astype(np.float32)
    loc = rng.uniform(lo, hi, size=(B, Q, H, L, P, 2)).astype(np.float32)
    attn = rng.rand(B, Q, H, L, P).astype(np.float32)
    attn /= attn.sum(axis=(-2, -1), keepdims=True)
    return [torch.from_numpy(a).to(device) for a in (value, loc, attn)]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_msda_kernel_matches_plain(cuda_device, case, dtype, tol):
    value, loc, attn = make_inputs(*CASES[case], cuda_device)
    v = value.to(dtype)
    before = ms_deform_attn.launches
    got = ms_deform_attn(v, SHAPES, loc, attn)
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, loc.shape[1], 4 * 40)
    want = ms_deform_attn_plain(v.float(), SHAPES, loc, attn)
    assert float((got.float() - want).abs().max()) <= tol


def test_msda_kernel_rejects_what_it_does_not_take(cuda_device):
    value, loc, attn = make_inputs(0, 7, 0.0, 1.0, cuda_device)
    with pytest.raises(TypeError):
        ms_deform_attn(value.half(), SHAPES, loc, attn)
    with pytest.raises(ValueError):
        ms_deform_attn(value, SHAPES[:2], loc, attn)


def _plain_grads(value, loc, attn, cot):
    """d(value, loc, attn) of <out, cot> by autograd of the plain version,
    in float32 from the same values."""
    t = [x.detach().float().requires_grad_() for x in (value, loc, attn)]
    out = ms_deform_attn_plain(t[0], SHAPES, t[1], t[2])
    return torch.autograd.grad(out, t, cot.float())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_msda_backward_kernel_matches_plain(cuda_device, case, dtype, rel):
    """Each grad within rel * max|ref| of the plain version's: the atomic
    adds into dvalue land in a different order on every run, and a bf16
    value and cotangent are rounded before the float32 reference sees them."""
    value, loc, attn = make_inputs(*CASES[case], cuda_device)
    v = value.to(dtype).requires_grad_()
    loc.requires_grad_()
    attn.requires_grad_()
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    cot = torch.randn(2, loc.shape[1], 4 * 40, generator=gen, device=cuda_device).to(dtype)
    before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
    got = torch.autograd.grad(ms_deform_attn(v, SHAPES, loc, attn), (v, loc, attn), cot)
    torch.cuda.synchronize()
    assert (ms_deform_attn.launches, ms_deform_attn.backward_launches) == (before[0] + 1, before[1] + 1)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    want = _plain_grads(v, loc, attn, cot)
    for name, g, w in zip(("value", "loc", "attn"), got, want):
        err = float((g.float() - w).abs().max())
        assert err <= rel * float(w.abs().max()), (name, err)


def test_msda_backward_kernel_all_invalid_samples_give_zero(cuda_device):
    value, loc, attn = make_inputs(0, 7, 0.0, 1.0, cuda_device)
    loc = (loc + 3.0).requires_grad_()  # every corner outside every level
    v = value.requires_grad_()
    attn.requires_grad_()
    out = ms_deform_attn(v, SHAPES, loc, attn)
    grads = torch.autograd.grad(out, (v, loc, attn), torch.ones_like(out))
    for g in grads:
        assert bool((g == 0).all())


def test_golden_pack_on_gpu(cuda_device):
    from rlipv2_tpu_torch.tools.golden_pack import check_pack

    before = ms_deform_attn.launches
    report = check_pack(device=cuda_device)
    assert max(report.values()) <= 2e-3
    assert ms_deform_attn.launches - before == 4 + 2 + 2  # enc 4, ho dec 2, verb dec 2
