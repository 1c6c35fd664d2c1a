"""Multi-scale deformable attention (counterpart of rlipv2_tpu/ops/ms_deform_attn.py).

Three versions of one function, all in the JAX package's layouts:
value (B, S, H, D), sampling locations (B, Q, H, L, P, 2) in [0, 1],
attention weights (B, Q, H, L, P); the result is (B, Q, H*D).

  * `ms_deform_attn_plain`: one gather over the level-flattened value, the
    counterpart of `_ms_deform_attn_xla`. It is the CPU path and the
    oracle the CUDA kernel is held against.
  * `ms_deform_attn_reference`: a naive per-level loop, the counterpart of
    `ms_deform_attn_reference`; for tests.
  * `ms_deform_attn`: the public entry. A CUDA tensor launches the
    hand-written kernels (csrc/ms_deform_attn_fwd.cu, replacing the TPU
    `_v4_kernel`, and csrc/ms_deform_attn_bwd.cu for its gradient,
    replacing `_v4_bwd_kernel`); a CPU tensor takes the plain version and
    its autograd. There is no fallback from one to the other. `impl` takes
    the JAX package's names (`IMPLS`).

The opt-in int8 inference path (`impl="pallas_int8"`, forward only):
`quantize_value_int8` and `ms_deform_attn_int8_plain` are its plain
version (the CPU path and the kernel's oracle); a CUDA tensor launches
csrc/ms_deform_attn_int8_fwd.cu, replacing the TPU `_v4_int8_kernel`.

Numerics follow the Pallas path (`_separable_prepare` and `_msda_pallas`):
locations and weights are cast to float32 before the coordinate math, sums
are taken in float32 and the result is returned in value.dtype. Sampling is
grid_sample with align_corners=False and zero padding: x = loc * W - 0.5,
and corner validity is tested before clamping.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

SpatialShapes = Sequence[tuple[int, int]]

_KERNEL_SOURCE = "ms_deform_attn_fwd.cu"
_BWD_KERNEL_SOURCE = "ms_deform_attn_bwd.cu"
_INT8_KERNEL_SOURCE = "ms_deform_attn_int8_fwd.cu"
_BWD_MAX_D = 128  # the backward kernel holds a grad_out row in 4 registers a lane
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' designs, by the code `msda_fwd_design`, `msda_bwd_design`
# and `msda_int8_fwd_design` return
FWD_DESIGNS = {1: "gather_d32", 0: "channel_loop"}
BWD_DESIGNS = {1: "gather_scatter_d32", 0: "channel_loop"}
INT8_DESIGNS = {1: "gather_d32", 0: "channel_loop"}


def _level_starts(spatial_shapes: SpatialShapes) -> list[int]:
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += h * w
    return starts


def _corner_indices_and_weights(spatial_shapes, loc):
    """loc (B, Q, H, L, P, 2) float32 -> flat indices into the S axis and
    bilinear weights (zero where out of bounds), each (B, Q, H, L, P, 4)."""
    dev = loc.device
    wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=loc.dtype, device=dev)
    W = torch.tensor([w for _, w in spatial_shapes], device=dev)[:, None]
    H = torch.tensor([h for h, _ in spatial_shapes], device=dev)[:, None]
    starts = torch.tensor(_level_starts(spatial_shapes), device=dev)[:, None]

    xy = loc * wh[:, None, :] - 0.5
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()

    def corner(xi, yi, wgt):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = starts + yi.clamp(min=0).minimum(H - 1) * W + xi.clamp(min=0).minimum(W - 1)
        return idx, torch.where(valid, wgt, torch.zeros_like(wgt))

    corners = [
        corner(x0i, y0i, (1.0 - fx) * (1.0 - fy)),
        corner(x0i + 1, y0i, fx * (1.0 - fy)),
        corner(x0i, y0i + 1, (1.0 - fx) * fy),
        corner(x0i + 1, y0i + 1, fx * fy),
    ]
    idx = torch.stack([c[0] for c in corners], dim=-1)
    wgt = torch.stack([c[1] for c in corners], dim=-1)
    return idx, wgt


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Gather formulation in float32; returns (B, Q, H*D) in value.dtype."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value S={S} != sum of level sizes {spatial_shapes}")
    if L != len(spatial_shapes):
        raise ValueError(f"{L} sampling levels but {len(spatial_shapes)} spatial shapes")
    loc = sampling_locations.float()
    attn = attention_weights.float()
    idx, wgt = _corner_indices_and_weights(spatial_shapes, loc)
    wgt = wgt * attn[..., None]  # (B, Q, H, L, P, 4)

    K = L * P * 4
    v = value.float().transpose(1, 2).reshape(B * H * S, D)  # rows (b, h, s)
    base = (torch.arange(B * H, device=value.device) * S).view(B, 1, H, 1)
    flat = (idx.reshape(B, Q, H, K) + base).reshape(-1)
    gathered = v.index_select(0, flat).view(B, Q, H, K, D)
    out = torch.einsum("bqhk,bqhkd->bqhd", wgt.reshape(B, Q, H, K), gathered)
    return out.reshape(B, Q, H * D).to(value.dtype)


def quantize_value_int8(
    value: torch.Tensor, spatial_shapes: SpatialShapes
) -> tuple[torch.Tensor, torch.Tensor]:
    """value (B, S, H, D) -> (int8 codes (B, S, H, D), float32 scales (B, H,
    L, D)): per (batch, head, level, channel), s = max(max|v|, 1e-6) over
    the level's tokens and q = clip(round(v * (127 / s)), -127, 127), as the
    JAX wrapper of `_v4_int8_kernel` quantizes. round is half to even."""
    B, S, H, D = value.shape
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value S={S} != sum of level sizes {spatial_shapes}")
    vf = value.float()
    q8 = torch.empty((B, S, H, D), dtype=torch.int8, device=value.device)
    scales = []
    for (h, w), start in zip(spatial_shapes, _level_starts(spatial_shapes)):
        piece = vf[:, start : start + h * w]
        s = piece.abs().amax(dim=1).clamp(min=1e-6)  # (B, H, D)
        # torch.div, not `127.0 / s`: the reflected operator multiplies by
        # the reciprocal and rounds twice
        q8[:, start : start + h * w] = torch.round(piece * torch.div(127.0, s)[:, None]).clamp(-127, 127).to(
            torch.int8
        )
        scales.append(s)
    return q8, torch.stack(scales, dim=2)


def _int8_mixer(spatial_shapes, loc, attn):
    """Separable bilinear weights and their int8 codes, as
    `_separable_prepare` and `_v4_int8_kernel` form them, float32, each
    (B, Q, H, L, P): floor column and row x0, y0; column codes c0, c1 =
    round(wx / colmax * 127); row weights r0, r1 = wy * colmax. A code or
    weight of a corner outside its level is 0."""
    dev = loc.device
    wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32, device=dev)
    W = torch.tensor([w for _, w in spatial_shapes], dtype=torch.float32, device=dev)[:, None]
    H = torch.tensor([h for h, _ in spatial_shapes], dtype=torch.float32, device=dev)[:, None]
    xy = loc * wh[:, None, :] - 0.5
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0

    def inside(c, n):
        return ((c >= 0) & (c <= n - 1)).float()

    wy0 = (1.0 - fy) * inside(y0, H)
    wy1 = fy * inside(y0 + 1, H)
    wx0 = (1.0 - fx) * inside(x0, W) * attn
    wx1 = fx * inside(x0 + 1, W) * attn
    colmax = torch.maximum(torch.maximum(wx0, wx1), torch.tensor(1e-8, device=dev))
    c0 = torch.round((wx0 / colmax) * 127.0)
    c1 = torch.round((wx1 / colmax) * 127.0)
    return x0, y0, c0, c1, wy0 * colmax, wy1 * colmax


def ms_deform_attn_int8_plain(
    value: torch.Tensor,
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """The int8 MSDA forward of the JAX `impl="pallas_int8"` as a gather;
    returns (B, Q, H*D) in value.dtype. Per level, sum over points and the
    two rows of r_row * (q[row, x0] * c0 + q[row, x1] * c1) (the integer
    products exact, as float32), times s / 127^2 per channel, summed over
    levels in float32."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes):
        raise ValueError(f"{L} sampling levels but {len(spatial_shapes)} spatial shapes")
    q8, scales = quantize_value_int8(value, spatial_shapes)
    x0, y0, c0, c1, r0, r1 = _int8_mixer(
        spatial_shapes, sampling_locations.float(), attention_weights.float()
    )
    rows = q8.transpose(1, 2).reshape(B * H * S, D)  # rows (b, h, s)
    base = (torch.arange(B * H, device=value.device) * S).view(B, 1, H, 1)
    out = torch.zeros(B, Q, H, D, dtype=torch.float32, device=value.device)
    for lvl, ((h, w), start) in enumerate(zip(spatial_shapes, _level_starts(spatial_shapes))):

        def code(yi, xi):
            """q[yi, xi] (B, Q, H, P, D) as float32; 0 outside the level."""
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = start + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            g = rows.index_select(0, (idx + base).reshape(-1)).view(B, Q, H, P, D).float()
            return g * valid[..., None]

        xl, yl = x0[:, :, :, lvl].long(), y0[:, :, :, lvl].long()
        a0, a1 = c0[:, :, :, lvl, :, None], c1[:, :, :, lvl, :, None]
        t0 = code(yl, xl) * a0 + code(yl, xl + 1) * a1
        t1 = code(yl + 1, xl) * a0 + code(yl + 1, xl + 1) * a1
        acc = (t0 * r0[:, :, :, lvl, :, None] + t1 * r1[:, :, :, lvl, :, None]).sum(3)
        out += acc * (scales[:, None, :, lvl] * (1.0 / (127.0 * 127.0)))
    return out.reshape(B, Q, H * D).to(value.dtype)


def ms_deform_attn_reference(
    value: torch.Tensor,
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Naive per-level loop (the algorithm of the reference's
    `ms_deform_attn_core_pytorch`). Tests only."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    bi = torch.arange(B, device=value.device)[:, None, None, None]
    hi = torch.arange(H, device=value.device)[None, None, :, None]
    out = torch.zeros(B, Q, H, D, dtype=torch.float32, device=value.device)
    for lvl, ((h, w), start) in enumerate(zip(spatial_shapes, _level_starts(spatial_shapes))):
        v = value[:, start : start + h * w].float().reshape(B, h, w, H, D)
        loc = sampling_locations[:, :, :, lvl].float()  # (B, Q, H, P, 2)
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        x0 = torch.floor(x).long()
        y0 = torch.floor(y).long()
        fx = x - x0
        fy = y - y0

        def sample(xi, yi):
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            g = v[bi, yi.clamp(0, h - 1), xi.clamp(0, w - 1), hi]  # (B, Q, H, P, D)
            return torch.where(valid[..., None], g, torch.zeros_like(g))

        s = (
            sample(x0, y0) * ((1 - fx) * (1 - fy))[..., None]
            + sample(x0 + 1, y0) * (fx * (1 - fy))[..., None]
            + sample(x0, y0 + 1) * ((1 - fx) * fy)[..., None]
            + sample(x0 + 1, y0 + 1) * (fx * fy)[..., None]
        )
        out = out + (s * attention_weights[:, :, :, lvl, :, None].float()).sum(3)
    return out.reshape(B, Q, H * D).to(value.dtype)


@functools.cache
def _load_kernels() -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """(forward, backward) libraries, built from csrc/ at first use."""
    from rlipv2_tpu_torch.ops.cuda_build import load_library

    vp, ci = ctypes.c_void_p, ctypes.c_int
    fwd = load_library(_KERNEL_SOURCE)
    fwd.msda_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                             ctypes.POINTER(ci), vp]
    fwd.msda_fwd.restype = ci
    fwd.msda_error_string.argtypes = [ci]
    fwd.msda_error_string.restype = ctypes.c_char_p
    fwd.msda_fwd_design.argtypes = [ci, vp]
    fwd.msda_fwd_design.restype = ci
    bwd = load_library(_BWD_KERNEL_SOURCE)
    bwd.msda_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                             ci, ci, ctypes.POINTER(ci), vp]
    bwd.msda_bwd.restype = ci
    bwd.msda_bwd_error_string.argtypes = [ci]
    bwd.msda_bwd_error_string.restype = ctypes.c_char_p
    bwd.msda_bwd_design.argtypes = [ci, vp, vp, vp]
    bwd.msda_bwd_design.restype = ci
    return fwd, bwd


@functools.cache
def _load_int8_kernel() -> ctypes.CDLL:
    """The int8 forward library, built from csrc/ at first use."""
    from rlipv2_tpu_torch.ops.cuda_build import load_library

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = load_library(_INT8_KERNEL_SOURCE)
    lib.msda_int8_fwd.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                                  ctypes.POINTER(ci), vp]
    lib.msda_int8_fwd.restype = ci
    lib.msda_int8_error_string.argtypes = [ci]
    lib.msda_int8_error_string.restype = ctypes.c_char_p
    lib.msda_int8_fwd_design.argtypes = [ci, vp]
    lib.msda_int8_fwd_design.restype = ci
    return lib


def _check_kernel_inputs(value, spatial_shapes, loc, attn, dtypes=tuple(_DTYPE_CODE)) -> None:
    """What the kernels take: value (B, S, H, D) in `dtypes` (float32 or
    bfloat16; int8 codes for the int8 kernel); loc, attn float32; 1-4
    levels; one device; contiguous."""
    B, S, H, D = value.shape
    _, Q, Hl, L, P, two = loc.shape
    if value.dtype not in dtypes:
        raise TypeError(f"ms_deform_attn kernel takes {dtypes} value, got {value.dtype}")
    if loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError("ms_deform_attn kernel takes float32 locations and weights")
    if (Hl, two) != (H, 2) or loc.shape[0] != B or tuple(attn.shape) != (B, Q, H, L, P):
        raise ValueError(
            f"shape mismatch: value {tuple(value.shape)}, loc {tuple(loc.shape)}, "
            f"attn {tuple(attn.shape)}"
        )
    if not 1 <= L <= 4 or L != len(spatial_shapes):
        raise ValueError(f"kernel takes 1-4 levels matching spatial_shapes, got L={L}")
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value S={S} != sum of level sizes {spatial_shapes}")
    for t in (value, loc, attn):
        if t.device != value.device:
            raise ValueError("ms_deform_attn inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("ms_deform_attn kernel takes contiguous tensors")


def _level_geom(spatial_shapes):
    L = len(spatial_shapes)
    return (ctypes.c_int * (3 * L))(
        *[v for (h, w), s in zip(spatial_shapes, _level_starts(spatial_shapes)) for v in (h, w, s)]
    )


def _launch_kernel(value, spatial_shapes, loc, attn) -> torch.Tensor:
    """Checks the inputs and launches the forward kernel on the current
    stream; returns (B, Q, H*D) in value.dtype."""
    _check_kernel_inputs(value, spatial_shapes, loc, attn)
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    lib, _ = _load_kernels()
    out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):  # launch in the tensors' own context
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = lib.msda_fwd(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[value.dtype], B, S, Q, H, D, L, P, _level_geom(spatial_shapes), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ms_deform_attn kernel launch failed: {lib.msda_error_string(err).decode()}"
        )
    ms_deform_attn.launches += 1
    ms_deform_attn.designs[FWD_DESIGNS[lib.msda_fwd_design(D, value.data_ptr())]] += 1
    return out


def _launch_backward_kernel(value, spatial_shapes, loc, attn, grad_out):
    """Checks the inputs and launches the backward kernel on the current
    stream. grad_out (B, Q, H*D) in value.dtype. Returns (dvalue in
    value.dtype, dloc float32, dattn float32)."""
    _check_kernel_inputs(value, spatial_shapes, loc, attn)
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    if D > _BWD_MAX_D:
        raise ValueError(f"ms_deform_attn backward kernel takes D <= {_BWD_MAX_D}, got {D}")
    if grad_out.dtype != value.dtype or tuple(grad_out.shape) != (B, Q, H * D):
        raise ValueError(
            f"grad_out {tuple(grad_out.shape)} {grad_out.dtype} does not match the "
            f"output ({B}, {Q}, {H * D}) {value.dtype}"
        )
    if grad_out.device != value.device:
        raise ValueError("ms_deform_attn inputs must be on one device")
    grad_out = grad_out.contiguous()
    _, lib = _load_kernels()
    # float32 accumulator: bf16 atomics would round every partial sum
    dvalue = torch.zeros((B, S, H, D), dtype=torch.float32, device=value.device)
    dloc = torch.empty_like(loc)
    dattn = torch.empty_like(attn)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = lib.msda_bwd(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(), grad_out.data_ptr(),
            dvalue.data_ptr(), dloc.data_ptr(), dattn.data_ptr(),
            _DTYPE_CODE[value.dtype], B, S, Q, H, D, L, P, _level_geom(spatial_shapes), stream,
        )
    if err != 0:
        raise RuntimeError(
            "ms_deform_attn backward kernel launch failed: "
            f"{lib.msda_bwd_error_string(err).decode()}"
        )
    ms_deform_attn.backward_launches += 1
    design = lib.msda_bwd_design(D, value.data_ptr(), grad_out.data_ptr(), dvalue.data_ptr())
    ms_deform_attn.backward_designs[BWD_DESIGNS[design]] += 1
    return dvalue.to(value.dtype), dloc, dattn


def launch_int8_kernel(q8, scales, spatial_shapes, loc, attn, out_dtype) -> torch.Tensor:
    """Launches the int8 forward kernel on the current stream, on codes and
    scales from `quantize_value_int8`; returns (B, Q, H*D) in out_dtype
    (float32 or bfloat16) and adds one to `ms_deform_attn.int8_launches`."""
    B, S, H, D = q8.shape
    _, Q, _, L, P, _ = loc.shape
    if q8.dtype != torch.int8 or scales.dtype != torch.float32 or tuple(scales.shape) != (B, H, L, D):
        raise TypeError(
            f"int8 kernel takes int8 codes and float32 (B, H, L, D) scales, got {q8.dtype} "
            f"{tuple(q8.shape)} and {scales.dtype} {tuple(scales.shape)}"
        )
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"int8 kernel writes float32/bfloat16, not {out_dtype}")
    _check_kernel_inputs(q8, spatial_shapes, loc, attn, dtypes=(torch.int8,))
    if scales.device != q8.device or not scales.is_contiguous():
        raise ValueError("int8 kernel scales must be contiguous and on the codes' device")
    lib = _load_int8_kernel()
    out = torch.empty((B, Q, H * D), dtype=out_dtype, device=q8.device)
    with torch.cuda.device(q8.device):
        stream = torch.cuda.current_stream(q8.device).cuda_stream
        err = lib.msda_int8_fwd(
            q8.data_ptr(), scales.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[out_dtype], B, S, Q, H, D, L, P, _level_geom(spatial_shapes), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ms_deform_attn int8 kernel launch failed: {lib.msda_int8_error_string(err).decode()}"
        )
    ms_deform_attn.int8_launches += 1
    ms_deform_attn.int8_designs[INT8_DESIGNS[lib.msda_int8_fwd_design(D, q8.data_ptr())]] += 1
    return out


class _MSDeformAttnCUDA(torch.autograd.Function):
    """The forward kernel as an autograd node whose backward is the
    backward kernel (csrc/ms_deform_attn_bwd.cu, replacing the TPU
    `_v4_bwd_kernel`). With `keep` (a list), the first call appends its
    output and a call that finds it filled, the recompute of a
    rematerialized region, returns it without launching (`ops/remat.py`)."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, loc, attn, keep=None):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, attn)
        if keep:
            return keep[0].view_as(keep[0])
        out = _launch_kernel(value, spatial_shapes, loc, attn)
        if keep is not None:
            keep.append(out.detach())
        return out

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        dvalue, dloc, dattn = _launch_backward_kernel(
            value, ctx.spatial_shapes, loc, attn, grad_out
        )
        return dvalue, None, dloc, dattn, None


# the JAX package's `impl` names: its exact TPU kernels all compute the
# function of the CUDA forward kernel
EXACT_IMPLS = ("auto", "pallas", "pallas_v3", "pallas_v5", "pallas_dense")
IMPLS = (*EXACT_IMPLS, "xla", "pallas_int8", "pallas_zerograd")


def ms_deform_attn(
    value: torch.Tensor,  # (B, S, H, D)
    spatial_shapes: SpatialShapes,  # ((H0, W0), ...)
    sampling_locations: torch.Tensor,  # (B, Q, H, L, P, 2)
    attention_weights: torch.Tensor,  # (B, Q, H, L, P)
    impl: str = "auto",
    keep: list | None = None,
) -> torch.Tensor:
    """Multi-scale deformable attention; returns (B, Q, H*D) in value.dtype.

    `impl` takes the JAX package's names. The exact ones (EXACT_IMPLS): CUDA
    tensors launch the hand-written forward kernel (and add one to
    `ms_deform_attn.launches`); their gradient launches the backward kernel
    (one more on `ms_deform_attn.backward_launches`). CPU tensors take
    `ms_deform_attn_plain` and its autograd. "xla" takes
    `ms_deform_attn_plain` on any device. "pallas_int8", forward only,
    launches the int8 kernel on CUDA tensors (one more on
    `ms_deform_attn.int8_launches`) and takes `ms_deform_attn_int8_plain` on
    CPU tensors; it raises on an input that requires grad.
    "pallas_zerograd", a profiling aid of the JAX package, is not ported.
    Each launch also adds one to its kernel's count by design
    (`ms_deform_attn.designs`, `.backward_designs`, `.int8_designs`: the
    D = 32 designs or the channel loop, as the library reports them).

    `keep`, a list, marks a call on the kernel inside a rematerialized
    region that keeps the output (the JAX "msda_out" tag, `ops/remat.py`):
    its recompute launches no forward kernel, and the backward kernel takes
    the saved inputs. The plain version keeps nothing: its autograd needs
    its own forward, which the recompute runs again."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if impl == "xla":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)
    if impl == "pallas_int8":
        return _ms_deform_attn_int8(value, spatial_shapes, sampling_locations, attention_weights)
    if impl == "pallas_zerograd":
        raise NotImplementedError("ms_deform_attn impl 'pallas_zerograd' (a JAX profiling aid) is not ported")
    if impl not in EXACT_IMPLS:
        raise ValueError(f"unknown ms_deform_attn impl {impl!r}; known: {IMPLS}")
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type != "cuda":
        raise NotImplementedError(f"ms_deform_attn has no kernel for {value.device}")
    return _MSDeformAttnCUDA.apply(
        value.contiguous(),
        spatial_shapes,
        sampling_locations.float().contiguous(),
        attention_weights.float().contiguous(),
        keep,
    )


def _ms_deform_attn_int8(value, spatial_shapes, loc, attn) -> torch.Tensor:
    if any(t.requires_grad for t in (value, loc, attn)):
        raise RuntimeError(
            "ms_deform_attn impl 'pallas_int8' is forward only (inference); an input "
            "requires grad: run it under torch.no_grad()"
        )
    if value.device.type == "cpu":
        return ms_deform_attn_int8_plain(value, spatial_shapes, loc, attn)
    if value.device.type != "cuda":
        raise NotImplementedError(f"ms_deform_attn has no int8 kernel for {value.device}")
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"ms_deform_attn int8 kernel takes float32/bfloat16 value, got {value.dtype}")
    q8, scales = quantize_value_int8(value, spatial_shapes)
    return launch_int8_kernel(q8, scales, spatial_shapes, loc.float().contiguous(),
                              attn.float().contiguous(), value.dtype)


ms_deform_attn.launches = 0
# forward launches by design (FWD_DESIGNS): they sum to `launches`
ms_deform_attn.designs = dict.fromkeys(FWD_DESIGNS.values(), 0)
ms_deform_attn.backward_launches = 0
# backward launches by design (BWD_DESIGNS): they sum to `backward_launches`
ms_deform_attn.backward_designs = dict.fromkeys(BWD_DESIGNS.values(), 0)
ms_deform_attn.int8_launches = 0
# int8 launches by design (INT8_DESIGNS): they sum to `int8_launches`
ms_deform_attn.int8_designs = dict.fromkeys(INT8_DESIGNS.values(), 0)
