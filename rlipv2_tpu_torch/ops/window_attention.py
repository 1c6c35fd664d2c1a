"""Swin window attention (counterpart of rlipv2_tpu/ops/window_attention.py).

One function in the JAX package's packed layout: qkv (nWB, N, 3C), the
projection output of nWB = B * nW windows, B-major; bias (h, N, N) float32,
the relative-position bias; mask (nW, N, N) float32 (0 or -100, the shifted
window mask) or None. The result is (nWB, N, C) in qkv.dtype.

  * `window_attention_plain`: the einsum formulation, the counterpart of
    `_attn_reference`. It is the CPU path and the oracle the CUDA kernel is
    held against.
  * `window_attention`: the public entry. A CUDA tensor launches the
    hand-written kernel (csrc/window_attention_fwd.cu, replacing the TPU
    `_kernel`: tensor-core tiles for bf16, a SIMT kernel for float32); a
    CPU tensor takes the plain version and its autograd.
    There is no fallback from one to the other.

Numerics follow the TPU kernel: scores, the bias and mask add and the
softmax in float32; P cast to qkv.dtype before P V; P V summed in float32
and returned in qkv.dtype. The gradient is autograd of the plain version
recomputed from the saved inputs, as the JAX package's `custom_vjp` takes
the vjp of `_attn_reference`: there is no backward kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_KERNEL_SOURCE = "window_attention_fwd.cu"
_HEAD_DIM = 32  # every published Swin spec; both designs of the kernel are built for it
_MAX_TOKENS = 160  # tokens a window whose scores a row the kernel keeps in registers (12 x 12 = 144)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def window_attention_plain(
    qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None, h: int
) -> torch.Tensor:
    """softmax(Q K^T d^-1/2 + bias (+ mask)) V per window and head; returns
    (nWB, N, C) in qkv.dtype."""
    nWB, N, C3 = qkv.shape
    C = C3 // 3
    d = C // h
    with torch.autocast(device_type=qkv.device.type, enabled=False):
        q, k, v = (t.float().reshape(nWB, N, h, d) for t in qkv.split(C, dim=-1))
        a = torch.einsum("bnhd,bmhd->bhnm", q, k) * d ** -0.5 + bias.float()
        if mask is not None:
            nW = mask.shape[0]
            a = (a.view(nWB // nW, nW, h, N, N) + mask.float()[None, :, None]).view(nWB, h, N, N)
        p = torch.softmax(a, dim=-1).to(qkv.dtype).float()
        out = torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(nWB, N, C)
    return out.to(qkv.dtype)


@functools.cache
def _load_kernel() -> ctypes.CDLL:
    """The kernel's library, built from csrc/ at first use."""
    from rlipv2_tpu_torch.ops.cuda_build import load_library

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = load_library(_KERNEL_SOURCE)
    lib.window_attn_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.window_attn_fwd.restype = ci
    lib.window_attn_error_string.argtypes = [ci]
    lib.window_attn_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(qkv, bias, mask, h) -> None:
    """What the kernel takes: qkv (nWB, N, 3 * h * 32) float32/bfloat16 with
    N <= 160; bias (h, N, N) float32; mask None or (nW, N, N) float32 with
    nW dividing nWB; one device; contiguous."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (nWB, N, 3C), got {tuple(qkv.shape)}")
    nWB, N, C3 = qkv.shape
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"window_attention kernel takes float32/bfloat16 qkv, got {qkv.dtype}")
    if C3 != 3 * h * _HEAD_DIM:
        raise ValueError(f"window_attention kernel takes head dim {_HEAD_DIM}: qkv {tuple(qkv.shape)}, h={h}")
    if not 1 <= N <= _MAX_TOKENS:
        raise ValueError(f"window_attention kernel takes 1..{_MAX_TOKENS} tokens a window, got {N}")
    tensors = [qkv, bias] + ([] if mask is None else [mask])
    if any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError("window_attention kernel takes a float32 bias and mask")
    if tuple(bias.shape) != (h, N, N):
        raise ValueError(f"bias must be ({h}, {N}, {N}), got {tuple(bias.shape)}")
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (N, N):
            raise ValueError(f"mask must be (nW, {N}, {N}), got {tuple(mask.shape)}")
        if mask.shape[0] == 0 or nWB % mask.shape[0]:
            raise ValueError(f"{mask.shape[0]} mask windows do not divide {nWB} windows")
    for t in tensors:
        if t.device != qkv.device:
            raise ValueError("window_attention inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("window_attention kernel takes contiguous tensors")


def _launch_kernel(qkv, bias, mask, h) -> torch.Tensor:
    """Checks the inputs and launches the kernel on the current stream;
    returns (nWB, N, C) in qkv.dtype."""
    _check_kernel_inputs(qkv, bias, mask, h)
    nWB, N, C3 = qkv.shape
    lib = _load_kernel()
    out = torch.empty((nWB, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):  # launch in the tensors' own context
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.window_attn_fwd(
            qkv.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[qkv.dtype], nWB, N, h,
            0 if mask is None else mask.shape[0], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"window_attention kernel launch failed: {lib.window_attn_error_string(err).decode()}"
        )
    window_attention.launches += 1
    return out


class _WindowAttentionCUDA(torch.autograd.Function):
    """The kernel as an autograd node whose backward is autograd of the
    plain version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, h):
        ctx.h = h
        ctx.save_for_backward(qkv, bias, mask)
        return _launch_kernel(qkv, bias, mask, h)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(w) for t, w in zip(saved, wanted)]
            out = window_attention_plain(*inputs, ctx.h)
            leaves = [t for t, w in zip(inputs, wanted) if w]
            grads = iter(torch.autograd.grad(out, leaves, grad_out))
        return (*(next(grads) if w else None for w in wanted), None)


def window_attention(
    qkv: torch.Tensor,  # (nWB, N, 3C)
    bias: torch.Tensor,  # (h, N, N) float32
    mask: torch.Tensor | None,  # (nW, N, N) float32
    h: int,
) -> torch.Tensor:
    """Window attention; returns (nWB, N, C) in qkv.dtype.

    CUDA tensors launch the hand-written kernel (and add one to
    `window_attention.launches`); their gradient is autograd of the plain
    version. CPU tensors take `window_attention_plain` and its autograd."""
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, mask, h)
    if qkv.device.type != "cuda":
        raise NotImplementedError(f"window_attention has no kernel for {qkv.device}")
    return _WindowAttentionCUDA.apply(
        qkv.contiguous(), bias.contiguous(), None if mask is None else mask.contiguous(), h
    )


window_attention.launches = 0
