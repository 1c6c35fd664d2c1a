"""W8A8 int8 linear layers (counterpart of rlipv2_tpu/ops/int8_dense.py).

The opt-in quantized dense stacks of the inference path (`int8_dense` on
the backbone and the transformer configs): Swin qkv/proj/MLP, the
deformable FFNs, the MSDA value/output projections and the BiMHA
projections. Inference only: rounding has no useful gradient, so
`Int8Linear` raises where autograd would record it.

Scheme, as in the JAX package:
  * weights: symmetric per-output-channel max-abs scales, quantized at
    every call;
  * activations: symmetric per-token max-abs scales;
  * the product of the int8 codes in int32 (`torch._int_mm`, the library's
    int8 matrix product, as the JAX package leaves its int8 dot to XLA),
    then the float32 rescale x_scale * w_scale and the bias.

On CUDA, `torch._int_mm` takes only some shapes (more than 16 rows, inner
and output sizes multiples of 8); `int8_matmul` pads the codes with zeros
to such a shape, which leaves the integer sums as they are. It never turns
to a float matrix product.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

_MIN_ROWS_CUDA = 17  # torch._int_mm on CUDA: more than 16 rows
_MULTIPLE_CUDA = 8  # ... and inner and output sizes multiples of 8


def quantize_symmetric(x: torch.Tensor, dim) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric max-abs int8 quantization along `dim`: (codes int8, scale
    float32 with `dim` kept as size 1), x ~= codes * scale. The scale is
    amax / 127, at least 1e-12; codes are round(x / scale), half to even."""
    x = x.float()
    scale = (x.abs().amax(dim=dim, keepdim=True) / 127.0).clamp(min=1e-12)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """int32 (M, N) = a (M, K) int8 @ b_t.T, with b_t (N, K) int8. On CUDA
    the codes are zero-padded to a shape `torch._int_mm` takes."""
    M, K = a.shape
    N = b_t.shape[0]
    if a.device.type != "cuda":
        return torch._int_mm(a, b_t.t())
    Mp = max(M, _MIN_ROWS_CUDA)
    Kp = -(-K // _MULTIPLE_CUDA) * _MULTIPLE_CUDA
    Np = -(-N // _MULTIPLE_CUDA) * _MULTIPLE_CUDA
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        b_t = F.pad(b_t, (0, Kp - K, 0, Np - N))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return out[:M, :N] if (Mp, Np) != (M, N) else out


def int8_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (..., Cin) @ weight.T, weight (Cout, Cin) as nn.Linear keeps it, in
    float32: per-token activation scales, per-output-channel weight scales,
    the int32 sum exact (127 * 127 * Cin < 2^31 for every width the models
    use), so the only error is the two roundings."""
    xq, xs = quantize_symmetric(x, dim=-1)  # (..., Cin), (..., 1)
    wq, ws = quantize_symmetric(weight, dim=1)  # (Cout, Cin), (Cout, 1)
    acc = _int_mm(xq.reshape(-1, x.shape[-1]), wq).view(*x.shape[:-1], weight.shape[0])
    return acc.float() * xs * ws[:, 0]


class Int8Linear(nn.Linear):
    """nn.Linear with a W8A8 dynamically quantized product: the same
    `weight` (Cout, Cin) and `bias` state-dict keys, so reference-layout
    weights load unchanged. The epilogue is float32; the output is in the
    autocast dtype where autocast is on, else in the input's dtype.
    `Int8Linear.calls` counts forwards."""

    calls = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad):
            raise RuntimeError(
                "Int8Linear is inference only (rounding has no useful gradient): run it "
                "under torch.no_grad()"
            )
        dev = x.device.type
        out_dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
        out = int8_matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias.float()
        Int8Linear.calls += 1
        return out.to(out_dtype)


def linear(in_features: int, out_features: int, *, int8: bool = False, bias: bool = True) -> nn.Linear:
    """nn.Linear or its int8 twin, chosen by the call site's config flag."""
    return (Int8Linear if int8 else nn.Linear)(in_features, out_features, bias=bias)
