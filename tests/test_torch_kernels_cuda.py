"""The port's CUDA kernels on the GPU (MSDA forward and backward, the int8
MSDA forward, window attention), the int8 products of
`ops/int8_dense.py` and the nvJPEG decoder of the HICO loader on the card. The kernels have no CPU mode, so every test here is marked `cuda` and
skips where torch sees no CUDA device. This file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from rlipv2_tpu_torch.data.image_io import ImageReader, NvJpegDecoder
from rlipv2_tpu_torch.ops.int8_dense import Int8Linear, int8_matmul
from rlipv2_tpu_torch.ops.ms_deform_attn import (
    launch_int8_kernel, ms_deform_attn, ms_deform_attn_int8_plain, ms_deform_attn_plain, quantize_value_int8)
from rlipv2_tpu_torch.ops.window_attention import window_attention, window_attention_plain
from rlipv2_tpu_torch.tools.hico_fixture import CMYK_FIXTURE, FIXTURE_DIR, FIXTURES, MIN_PSNR_DB, psnr_db, source_image
from rlipv2_tpu_torch.tools.msda_locations import encoder_locations

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


def d32_case_inputs(case, device):
    """D32_CASES, plus "init_grid" (the first 300 tokens' locations at the
    spread of the sampling-offset init, `tools/msda_locations.py`) and
    "collision" (every query and head samples one point, so the reductions
    of a call land on 16 rows a head)."""
    if case == "init_grid":
        value, _, attn = d32_inputs(15, 2, 300, 8, 0.0, 1.0, device)
        gen = torch.Generator(device=device).manual_seed(15)
        return value, encoder_locations("init_grid", ENC_SHAPES_SMALL, 2, 8, 4, gen, Q=300), attn
    if case == "collision":
        value, loc, attn = d32_inputs(16, 2, 300, 8, 0.0, 1.0, device)
        return value, torch.full_like(loc, 0.43), attn
    return d32_inputs(*D32_CASES[case], device)


D32_BWD_CASES = sorted([*D32_CASES, "init_grid", "collision"])


@pytest.mark.parametrize("case", D32_BWD_CASES)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_msda_d32_backward_matches_plain(cuda_device, case, dtype, rel):
    """D = 32 takes the gather and vector scatter: dvalue, dloc and dattn
    within rel * max|ref| of autograd of the plain version in float32 from
    the same values (atomic order changes from run to run; bf16 rounds the
    value and the cotangent)."""
    value, loc, attn = d32_case_inputs(case, cuda_device)
    v = value.to(dtype).requires_grad_()
    loc.requires_grad_()
    attn.requires_grad_()
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    cot = torch.randn(v.shape[0], loc.shape[1], v.shape[2] * 32, generator=gen, device=cuda_device).to(dtype)
    before = dict(ms_deform_attn.backward_designs)
    got = torch.autograd.grad(ms_deform_attn(v, ENC_SHAPES_SMALL, loc, attn), (v, loc, attn), cot)
    torch.cuda.synchronize()
    assert ms_deform_attn.backward_designs == {**before, "gather_scatter_d32": before["gather_scatter_d32"] + 1}
    t = [x.detach().float().requires_grad_() for x in (v, loc, attn)]
    want = torch.autograd.grad(ms_deform_attn_plain(t[0], ENC_SHAPES_SMALL, t[1], t[2]), t, cot.float())
    for name, g, w in zip(("value", "loc", "attn"), got, want):
        err = float((g.float() - w).abs().max())
        assert err <= rel * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_d32_backward_all_invalid_locations_give_zeros(cuda_device, dtype):
    """Every corner outside its level: no reduction into dvalue and zero
    dloc and dattn, from the D = 32 design."""
    value, loc, attn = d32_inputs(17, 2, 50, 8, 0.0, 1.0, cuda_device)
    v = value.to(dtype).requires_grad_()
    loc = (loc + 3.0).requires_grad_()
    attn.requires_grad_()
    before = ms_deform_attn.backward_designs["gather_scatter_d32"]
    out = ms_deform_attn(v, ENC_SHAPES_SMALL, loc, attn)
    grads = torch.autograd.grad(out, (v, loc, attn), torch.ones_like(out))
    torch.cuda.synchronize()
    assert ms_deform_attn.backward_designs["gather_scatter_d32"] == before + 1
    for g in grads:
        assert bool((g == 0).all())


def test_msda_backward_misaligned_value_takes_the_channel_loop(cuda_device):
    """A value view 4 bytes past a 16-byte boundary cannot take 16-byte
    loads: the backward launches the channel loop, and still matches."""
    value, loc, attn = d32_inputs(18, 2, 60, 8, 0.0, 1.0, cuda_device)
    base = torch.zeros(value.numel() + 1, device=cuda_device)
    base[1:] = value.reshape(-1)
    base.requires_grad_()
    v = base[1:].view(value.shape)
    assert v.data_ptr() % 16 != 0 and v.is_contiguous()
    loc.requires_grad_()
    attn.requires_grad_()
    cot = torch.randn(2, 60, 8 * 32, device=cuda_device)
    before = dict(ms_deform_attn.backward_designs)
    got = torch.autograd.grad(ms_deform_attn(v, ENC_SHAPES_SMALL, loc, attn), (base, loc, attn), cot)
    torch.cuda.synchronize()
    assert ms_deform_attn.backward_designs == {**before, "channel_loop": before["channel_loop"] + 1}
    t = [x.detach().float().requires_grad_() for x in (value, loc, attn)]
    want = torch.autograd.grad(ms_deform_attn_plain(t[0], ENC_SHAPES_SMALL, t[1], t[2]), t, cot)
    assert float(got[0][0]) == 0.0
    for name, g, w in zip(("value", "loc", "attn"), (got[0][1:].view(value.shape), *got[1:]), want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("case", D32_BWD_CASES)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_int8_msda_d32_gather_matches_plain(cuda_device, case, dtype, rel):
    """D = 32 takes the int8 load-parallel gather: within 1e-5 (float32)
    and 1e-2 (bf16) of max|int8 plain| (the same codes, sums in another
    order), and within 2e-2 of the exact function but not equal to it."""
    value, loc, attn = d32_case_inputs(case, cuda_device)
    v = value.to(dtype)
    before = dict(ms_deform_attn.int8_designs)
    got = ms_deform_attn(v, ENC_SHAPES_SMALL, loc, attn, impl="pallas_int8")
    torch.cuda.synchronize()
    assert ms_deform_attn.int8_designs == {**before, "gather_d32": before["gather_d32"] + 1}
    assert got.dtype == dtype and got.shape == (v.shape[0], loc.shape[1], v.shape[2] * 32)
    want = ms_deform_attn_int8_plain(v, ENC_SHAPES_SMALL, loc, attn).float()
    assert float((got.float() - want).abs().max()) <= rel * float(want.abs().max())
    exact = ms_deform_attn_plain(v.float(), ENC_SHAPES_SMALL, loc, attn)
    err = float((got.float() - exact).abs().max())
    assert 0.0 < err <= 2e-2 * float(exact.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_msda_d32_gather_all_invalid_locations_give_zeros(cuda_device, dtype):
    value, loc, attn = d32_inputs(19, 2, 50, 8, 0.0, 1.0, cuda_device)
    before = ms_deform_attn.int8_designs["gather_d32"]
    got = ms_deform_attn(value.to(dtype), ENC_SHAPES_SMALL, loc + 3.0, attn, impl="pallas_int8")
    torch.cuda.synchronize()
    assert ms_deform_attn.int8_designs["gather_d32"] == before + 1
    assert bool((got == 0).all())


def test_int8_msda_misaligned_codes_take_the_channel_loop(cuda_device):
    """Codes 1 byte past an 8-byte boundary cannot take 8-byte loads: the
    int8 kernel launches the channel loop and gives the D = 32 design's
    result within 1e-5 of max|out|."""
    value, loc, attn = d32_inputs(20, 2, 60, 8, 0.0, 1.0, cuda_device)
    q8, scales = quantize_value_int8(value, ENC_SHAPES_SMALL)
    shifted = torch.empty(q8.numel() + 1, dtype=torch.int8, device=cuda_device)
    shifted[1:] = q8.reshape(-1)
    q8_view = shifted[1:].view(q8.shape)
    assert q8_view.data_ptr() % 8 != 0 and q8_view.is_contiguous()
    before = dict(ms_deform_attn.int8_designs)
    got = launch_int8_kernel(q8_view, scales, ENC_SHAPES_SMALL, loc, attn, torch.float32)
    mid = dict(ms_deform_attn.int8_designs)
    want = launch_int8_kernel(q8, scales, ENC_SHAPES_SMALL, loc, attn, torch.float32)
    torch.cuda.synchronize()
    assert mid == {**before, "channel_loop": before["channel_loop"] + 1}
    assert ms_deform_attn.int8_designs == {**mid, "gather_d32": mid["gather_d32"] + 1}
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_golden_pack_on_gpu(cuda_device):
    from rlipv2_tpu_torch.tools.golden_pack import check_pack

    before = ms_deform_attn.launches
    report = check_pack(device=cuda_device)
    assert max(report.values()) <= 2e-3
    assert ms_deform_attn.launches - before == 4 + 2 + 2  # enc 4, ho dec 2, verb dec 2


def test_rlip_parsed_v1_forward_launches_the_msda_kernel(cuda_device):
    """RLIP-ParSeD v1 (`rlip_parsed`: the plain deformable encoder) at tiny
    widths with the preset's 6 encoder and 3 decoder layers and head dim 32:
    its forward on the card launches the MSDA forward kernel 12 times, on
    the D = 32 gather, and gives the outputs of the same model and weights
    on the CPU, which takes the plain MSDA, within the golden pack's 2e-3."""
    import copy

    from rlipv2_tpu_torch.config import BackboneConfig, FusionConfig, ModelConfig, TextEncoderConfig, TransformerConfig
    from rlipv2_tpu_torch.models.factory import build_model
    from rlipv2_tpu_torch.tools.main_path import random_state_dict

    cfg = ModelConfig(
        variant="rlip_parsed", backbone=BackboneConfig(name="resnet_test", num_outputs=3),
        text_encoder=TextEncoderConfig(vocab_size=128, hidden_size=32, num_layers=1, num_heads=4,
                                       intermediate_size=64, max_position_embeddings=64),
        transformer=TransformerConfig(hidden_dim=64, nheads=2, enc_layers=6, dec_layers=3, dim_feedforward=128,
                                      fusion=FusionConfig(embed_dim=64, num_heads=4)),
        num_queries=16, max_obj_texts=5, max_verb_texts=7, dtype="float32")
    model = build_model(cfg)
    model.load_state_dict(random_state_dict(model), strict=True)
    model.eval()
    rng = np.random.RandomState(0)
    pixels = torch.from_numpy(rng.randint(0, 256, (2, 96, 128, 3)).astype(np.uint8))
    valid = torch.ones(2, 96, 128, dtype=torch.bool)
    valid[0, 70:, :] = False
    valid[0, :, 101:] = False
    text = torch.from_numpy(rng.randn(2, 12, 32).astype(np.float32))
    text_valid = torch.ones(2, 12, dtype=torch.bool)
    text_valid[:, 3] = False
    inputs = (pixels, valid, text, text_valid)
    with torch.no_grad():
        want = model(*inputs, 5)
        on_card = copy.deepcopy(model).to(cuda_device)
        before, d32 = ms_deform_attn.launches, ms_deform_attn.designs.get("gather_d32", 0)
        got = on_card(*(x.to(cuda_device) for x in inputs), 5)
        torch.cuda.synchronize()
    assert ms_deform_attn.launches - before == 12  # 6 encoder, 3 ho-decoder, 3 verb-decoder layers
    assert ms_deform_attn.designs["gather_d32"] - d32 == 12
    for k in ("pred_obj_logits", "pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes"):
        err = float((got[k].cpu() - want[k]).abs().max())
        assert err <= 2e-3, (k, err)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_grads_under_checkpoint(cuda_device, dtype):
    """Non-reentrant checkpointing around the kernel (a Swin block under
    `use_checkpoint`): its backward, autograd inside autograd, gives the
    gradients of the run without checkpointing, and the recompute launches
    the kernel once more."""
    from torch.utils.checkpoint import checkpoint

    qkv, bias, mask = window_inputs(144, True, cuda_device, seed=2)
    cot = torch.randn(8, 144, 96, device=cuda_device).to(dtype)

    def region(x, b):
        return torch.nn.functional.gelu(window_attention(x * 1.0, b, mask, 3))

    grads, launches = [], []
    for remat in (False, True):
        x, b = qkv.to(dtype).requires_grad_(), bias.clone().requires_grad_()
        before = window_attention.launches
        out = checkpoint(region, x, b, use_reentrant=False) if remat else region(x, b)
        grads.append(torch.autograd.grad(out, (x, b), cot))
        launches.append(window_attention.launches - before)
    assert launches == [1, 2]
    for g, w in zip(*grads[::-1]):
        assert float((g.float() - w.float()).abs().max()) <= 1e-6 * float(w.float().abs().max())


@pytest.mark.parametrize("save_names,forward_launches", [(("msda_out",), 1), (("enc_ffn_out",), 2), ((), 2)])
def test_encoder_layer_remat_launches_and_grads(cuda_device, save_names, forward_launches):
    """One deformable encoder layer (dropout on, one seed) at its kernel
    shapes: under `remat_encoder` the MSDA forward kernel launches once
    when the output is kept ("msda_out") and again in the recompute
    otherwise, the backward kernel once; the loss and the gradients equal
    those of the layer without remat (the backward kernel's float atomics
    add in another order: 1e-5 of max|g|)."""
    from rlipv2_tpu_torch.config import TransformerConfig
    from rlipv2_tpu_torch.models.deformable import DeformableEncoderLayer, encoder_reference_points

    shapes = ((24, 32), (12, 16), (6, 8), (3, 4))
    S = sum(h * w for h, w in shapes)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    src = torch.randn(2, S, 256, generator=gen, device=cuda_device)
    pos = torch.randn(2, S, 256, generator=gen, device=cuda_device)
    valid = torch.ones(2, S, dtype=torch.bool, device=cuda_device)
    refs = encoder_reference_points(shapes, torch.ones(2, 4, 2, device=cuda_device))
    cot = torch.randn(2, S, 256, generator=gen, device=cuda_device)
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        cfg = TransformerConfig(remat_encoder=remat, remat_save_names=save_names)
        layer = DeformableEncoderLayer(cfg).to(cuda_device).train()
        x = src.clone().requires_grad_()
        before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
        torch.manual_seed(1)  # the dropout masks
        out = layer(x, pos, refs, shapes, valid)
        grads = torch.autograd.grad(out, [x, *layer.parameters()], cot)
        runs.append((out.detach(), grads, (ms_deform_attn.launches - before[0],
                                           ms_deform_attn.backward_launches - before[1])))
    (out0, g0, n0), (out1, g1, n1) = runs
    assert n0 == (1, 1) and n1 == (forward_launches, 1)
    assert torch.equal(out0, out1)
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max()) + 1e-7


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
    before = ms_deform_attn.int8_designs["gather_d32"]
    got = ms_deform_attn(value, shapes, loc, attn, impl="pallas_int8")
    want = ms_deform_attn_int8_plain(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert ms_deform_attn.int8_designs["gather_d32"] == before + 1  # D = 32: the load-parallel gather
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


def test_nvjpeg_decodes_the_fixture(cuda_device):
    """Each JPEG of tests/fixtures/hico_jpeg through the loader's reader:
    RGB of the file's size within MIN_PSNR_DB of its seeded source, the
    same bytes from two decodes and from four threads at once; a CMYK
    file raises, naming it."""
    from concurrent.futures import ThreadPoolExecutor

    reader = ImageReader(cuda_device)
    try:
        first = {}
        for spec in FIXTURES:
            img = reader.read(FIXTURE_DIR / spec.name)
            assert img.device.type == "cpu" and img.dtype == torch.uint8
            assert tuple(img.shape) == (spec.height, spec.width, 3)
            assert psnr_db(img.numpy(), source_image(spec)) >= MIN_PSNR_DB, spec.name
            assert torch.equal(reader.read(FIXTURE_DIR / spec.name), img)
            first[spec.name] = img
        before = NvJpegDecoder.decodes
        with ThreadPoolExecutor(4) as pool:
            again = list(pool.map(lambda i: reader.read(FIXTURE_DIR / FIXTURES[i % 6].name), range(24)))
        assert NvJpegDecoder.decodes == before + 24
        for i, img in enumerate(again):
            assert torch.equal(img, first[FIXTURES[i % 6].name])
        with pytest.raises(ValueError, match=CMYK_FIXTURE):
            reader.read(FIXTURE_DIR / CMYK_FIXTURE)
    finally:
        reader.close()
