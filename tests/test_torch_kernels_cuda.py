"""The port's CUDA kernels on the GPU (MSDA forward and backward, the int8
MSDA forward, window attention) and the int8 products of
`ops/int8_dense.py` on the card. The kernels have no CPU mode, so every test here is marked `cuda` and
skips where torch sees no CUDA device. This file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from rlipv2_tpu_torch.ops.int8_dense import Int8Linear, int8_matmul
from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_int8_plain, ms_deform_attn_plain
from rlipv2_tpu_torch.ops.window_attention import window_attention, window_attention_plain

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


ENC_SHAPES_SMALL = ((16, 24), (8, 12), (4, 6), (2, 3))
D32_CASES = {  # (seed, B, Q, H, loc range); D = 32, L = 4, P = 4 as the main paths call it
    "encoder": (10, 2, sum(h * w for h, w in ENC_SHAPES_SMALL), 8, 0.0, 1.0),
    "out_of_bounds": (11, 2, 300, 8, -0.2, 1.2),
    "decoder_q200": (12, 2, 200, 8, None, None),
    "ragged_warps": (13, 1, 7, 3, 0.0, 1.0),  # B * Q * H = 21: not a multiple of a block's 8 warps
}


def d32_inputs(seed, B, Q, H, lo, hi, device):
    """value (B, S, H, 32), loc and attn at L = 4, P = 4; lo None gives
    decoder locations around 4-d anchors (centre + offset / P * wh / 2)."""
    rng = np.random.RandomState(seed)
    L, P, S = len(ENC_SHAPES_SMALL), 4, sum(h * w for h, w in ENC_SHAPES_SMALL)
    value = rng.randn(B, S, H, 32).astype(np.float32)
    if lo is None:
        anchors = rng.rand(B, Q, 1, 1, 1, 4).astype(np.float32)
        offsets = rng.randn(B, Q, H, L, P, 2).astype(np.float32)
        loc = anchors[..., :2] + offsets / P * anchors[..., 2:] * 0.5
    else:
        loc = rng.uniform(lo, hi, size=(B, Q, H, L, P, 2)).astype(np.float32)
    attn = rng.rand(B, Q, H, L, P).astype(np.float32)
    attn /= attn.sum(axis=(-2, -1), keepdims=True)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (value, loc, attn)]


@pytest.mark.parametrize("case", sorted(D32_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_msda_d32_gather_matches_plain(cuda_device, case, dtype, tol):
    """D = 32 takes the load-parallel gather: within 1e-5 (float32) and
    2e-2 (bf16 value, against the plain version in float32 from the same
    bf16 values) of the plain version, as the channel loop is held."""
    value, loc, attn = d32_inputs(*D32_CASES[case], cuda_device)
    v = value.to(dtype)
    before = dict(ms_deform_attn.designs)
    got = ms_deform_attn(v, ENC_SHAPES_SMALL, loc, attn)
    torch.cuda.synchronize()
    assert ms_deform_attn.designs["gather_d32"] == before["gather_d32"] + 1
    assert ms_deform_attn.designs["channel_loop"] == before["channel_loop"]
    assert got.dtype == dtype and got.shape == (v.shape[0], loc.shape[1], v.shape[2] * 32)
    want = ms_deform_attn_plain(v.float(), ENC_SHAPES_SMALL, loc, attn)
    assert float((got.float() - want).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_d32_gather_all_invalid_locations_give_zeros(cuda_device, dtype):
    """Every corner outside its level: clamped addresses, zero weights, an
    output of exact zeros."""
    value, loc, attn = d32_inputs(14, 2, 50, 8, 0.0, 1.0, cuda_device)
    got = ms_deform_attn(value.to(dtype), ENC_SHAPES_SMALL, loc + 3.0, attn)
    torch.cuda.synchronize()
    assert bool((got == 0).all())


def test_golden_pack_on_gpu(cuda_device):
    from rlipv2_tpu_torch.tools.golden_pack import check_pack

    before = ms_deform_attn.launches
    report = check_pack(device=cuda_device)
    assert max(report.values()) <= 2e-3
    assert ms_deform_attn.launches - before == 4 + 2 + 2  # enc 4, ho dec 2, verb dec 2


def window_inputs(N, masked, device, nW=4, B=2, h=3, seed=0):
    """Packed qkv (nW * B, N, 3 * h * 32), bias (h, N, N) and a 0 / -100
    mask (nW, N, N), windows B-major."""
    rng = np.random.RandomState(seed)
    qkv = rng.randn(nW * B, N, 3 * h * 32).astype(np.float32)
    bias = rng.randn(h, N, N).astype(np.float32)
    mask = np.where(rng.rand(nW, N, N) < 0.3, -100.0, 0.0).astype(np.float32)
    return (torch.from_numpy(qkv).to(device), torch.from_numpy(bias).to(device),
            torch.from_numpy(mask).to(device) if masked else None)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("N", [49, 144])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_window_attention_kernel_matches_plain(cuda_device, N, masked, dtype, tol):
    """float32 within 2e-5 (the JAX package's kernel test); bf16 qkv within
    2e-2 of the plain version in float32 from the same bf16 values (the
    kernel rounds P and the output to bf16)."""
    qkv, bias, mask = window_inputs(N, masked, cuda_device)
    x = qkv.to(dtype)
    before = window_attention.launches
    got = window_attention(x, bias, mask, 3)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (8, N, 96)
    want = window_attention_plain(x.float(), bias, mask, 3)
    assert float((got.float() - want).abs().max()) <= tol


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("N,nW,B,h", [(144, 3, 5, 5), (49, 4, 3, 7), (160, 2, 5, 2)])
def test_window_attention_tensor_core_tiles_match_plain(cuda_device, N, nW, B, h, masked):
    """The bf16 tile kernel at N = 144, 49 (padded to 64) and 160 (where
    the mask does not fit in shared memory and is read from L2), with window
    counts that leave a block a short group (13-15 windows without a mask,
    8 a block) and head counts that are not powers of two; within 2e-2 of
    the plain version in float32 from the same bf16 values."""
    qkv, bias, mask = window_inputs(N, masked, cuda_device, nW=nW, B=B, h=h, seed=N + h)
    x = qkv.bfloat16()
    before = window_attention.launches
    got = window_attention(x, bias, mask, h)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (nW * B, N, h * 32)
    want = window_attention_plain(x.float(), bias, mask, h)
    assert float((got.float() - want).abs().max()) <= 2e-2


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_window_attention_tensor_core_large_scores(cuda_device, masked):
    """Scores of |S| ~ 1e3 (the softmax needs its max subtraction, else exp
    overflows): the bf16 tile kernel still within 2e-2 of the plain version."""
    qkv, bias, mask = window_inputs(144, masked, cuda_device, seed=5)
    qkv[..., : 2 * 96] *= 8.0  # q and k: |q.k| / sqrt(32) ~ 64; v keeps its scale
    x, bias = qkv.bfloat16(), bias * 300.0  # bias ~ 300: |S| ~ 1e3
    got = window_attention(x, bias, mask, 3)
    want = window_attention_plain(x.float(), bias, mask, 3)
    torch.cuda.synchronize()
    assert float(want.float().abs().max()) > 1.0
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want).abs().max()) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_grads_match_plain(cuda_device, dtype):
    """The kernel's autograd.Function takes autograd of the plain version,
    recomputed from the same inputs: within 1e-5 of max|ref|."""
    qkv, bias, mask = window_inputs(144, True, cuda_device, seed=1)
    x, b = qkv.to(dtype).requires_grad_(), bias.requires_grad_()
    cot = torch.randn(8, 144, 96, device=cuda_device).to(dtype)
    got = torch.autograd.grad(window_attention(x, b, mask, 3), (x, b), cot)
    want = torch.autograd.grad(window_attention_plain(x, b, mask, 3), (x, b), cot)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert float((g.float() - w.float()).abs().max()) <= 1e-5 * float(w.float().abs().max())


def test_window_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    qkv, bias, mask = window_inputs(49, True, cuda_device)
    with pytest.raises(TypeError):
        window_attention(qkv.half(), bias, mask, 3)
    with pytest.raises(TypeError):
        window_attention(qkv, bias.bfloat16(), mask, 3)
    with pytest.raises(TypeError):
        window_attention(qkv, bias, mask.bfloat16(), 3)
    with pytest.raises(ValueError):  # head dim 16
        window_attention(qkv, bias[:1].repeat(6, 1, 1), mask, 6)
    with pytest.raises(ValueError):  # 3 mask windows do not divide 8
        window_attention(qkv, bias, mask[:3], 3)
    big, big_bias, _ = window_inputs(169, False, cuda_device, nW=1, B=1)
    with pytest.raises(ValueError):  # 13 x 13 tokens a window
        window_attention(big, big_bias, None, 3)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_int8_msda_kernel_matches_plain(cuda_device, case, dtype, rel):
    """The int8 kernel against `ms_deform_attn_int8_plain` on the same
    value: the same codes, sums in another order; float32 within 1e-5 of
    max|plain|, bf16 within 1e-2 (one bf16 rounding of the float32 sum)."""
    value, loc, attn = make_inputs(*CASES[case], cuda_device)
    v = value.to(dtype)
    before = (ms_deform_attn.launches, ms_deform_attn.int8_launches)
    got = ms_deform_attn(v, SHAPES, loc, attn, impl="pallas_int8")
    torch.cuda.synchronize()
    assert (ms_deform_attn.launches, ms_deform_attn.int8_launches) == (before[0], before[1] + 1)
    assert got.dtype == dtype and got.shape == (2, loc.shape[1], 4 * 40)
    want = ms_deform_attn_int8_plain(v, SHAPES, loc, attn).float()
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= rel * scale
    exact = ms_deform_attn_plain(v.float(), SHAPES, loc, attn)
    err = float((got.float() - exact).abs().max())
    assert 0.0 < err <= 2e-2 * float(exact.abs().max())


@pytest.mark.parametrize("k,x", [(14, 0.4246908128261566), (44, 0.4050655961036682)])
def test_int8_msda_kernel_rounds_ties_to_even(cuda_device, k, x):
    """A point whose column code is exactly k + 0.5 (tests/
    test_torch_ms_deform_attn_int8.py): the kernel gives the even code k,
    as the plain version does; half away from zero would give k + 1."""
    shapes = ((4, 8),)
    loc = torch.zeros(1, 1, 1, 1, 1, 2, device=cuda_device)
    loc[..., 0], loc[..., 1] = x, 0.375
    attn = torch.ones(1, 1, 1, 1, 1, device=cuda_device)
    value = torch.zeros(1, 32, 1, 32, device=cuda_device)
    value[0, 1 * 8 + 2] = 1.0
    got = ms_deform_attn(value, shapes, loc, attn, impl="pallas_int8")
    want = ms_deform_attn_int8_plain(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    fx = float(np.float32(x) * np.float32(8) - np.float32(0.5)) - 2.0
    assert abs(float(got[0, 0, 0]) - fx * k / 127) <= 1e-6


def test_int8_msda_refuses_grad_and_unsupported_dtypes(cuda_device):
    value, loc, attn = make_inputs(0, 7, 0.0, 1.0, cuda_device)
    with pytest.raises(RuntimeError, match="forward only"):
        ms_deform_attn(value.requires_grad_(), SHAPES, loc, attn, impl="pallas_int8")
    with pytest.raises(TypeError):
        ms_deform_attn(value.detach().half(), SHAPES, loc, attn, impl="pallas_int8")


@pytest.mark.parametrize("shape", [(5, 40, 24), (300, 256, 1024), (17, 37, 51)])  # (M, Cin, Cout)
def test_int8_matmul_on_the_card_matches_the_cpu(cuda_device, shape):
    """`torch._int_mm` on the card (zero-padded where its shape rules ask:
    M <= 16, Cin or Cout not multiples of 8) gives the integer sums of the
    CPU path; the float32 rescale within 1e-6 of max|out|."""
    M, cin, cout = shape
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(M, cin, generator=gen)
    w = torch.randn(cout, cin, generator=gen) / cin ** 0.5
    want = int8_matmul(x, w)
    got = int8_matmul(x.to(cuda_device), w.to(cuda_device)).cpu()
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    layer = Int8Linear(cin, cout).to(cuda_device)
    before = Int8Linear.calls
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        assert layer(x.to(cuda_device)).dtype == torch.bfloat16
    assert Int8Linear.calls == before + 1
