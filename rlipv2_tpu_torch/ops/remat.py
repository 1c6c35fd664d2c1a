"""Values that a rematerialized region keeps (counterpart of the JAX
package's `checkpoint_name` tags under
`jax.checkpoint_policies.save_only_these_names`).

A region run by `torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`
drops what its ops save for the backward and runs again in the backward to
get it back. A value the region keeps is computed once: its first call
appends the value to `keep`, a list the region takes as an argument (so it
lives as long as the region's saved inputs do), and the call in the
recompute, which finds `keep` filled, returns that value and computes
nothing. Its backward needs no forward either: a kept linear takes its
vector-Jacobian product from the saved input and weight, and the MSDA
kernel's autograd.Function keeps its output with `ms_deform_attn(...,
keep=...)` and runs its backward kernel on the saved inputs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F


class _KeptLinear(torch.autograd.Function):
    """F.linear(x, weight, bias) under the caller's autocast, kept in
    `keep`; the backward is the linear's VJP in the dtype the forward ran
    in, cast back to each input's dtype."""

    @staticmethod
    def forward(ctx, keep, x, weight, bias):
        dev = x.device.type
        ctx.dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
        ctx.save_for_backward(x, weight, bias)
        if keep:
            return keep[0].view_as(keep[0])
        out = F.linear(x, weight, bias)
        keep.append(out.detach())
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, bias = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[1:]
        g = grad_out.to(ctx.dtype).reshape(-1, grad_out.shape[-1])
        dx = dw = db = None
        if need_x:
            dx = (g @ weight.to(ctx.dtype)).view(x.shape).to(x.dtype)
        if need_w:
            dw = (g.t() @ x.to(ctx.dtype).reshape(-1, x.shape[-1])).to(weight.dtype)
        if need_b:
            db = g.sum(0).to(bias.dtype)
        return None, dx, dw, db


def kept_linear(layer: nn.Linear, x: torch.Tensor, keep: Optional[list]) -> torch.Tensor:
    """layer(x), kept in `keep` when it is a list. An int8 projection
    (inference only) is not kept."""
    from rlipv2_tpu_torch.ops.int8_dense import Int8Linear

    if keep is None or isinstance(layer, Int8Linear):
        return layer(x)
    return _KeptLinear.apply(keep, x, layer.weight, layer.bias)
