"""Swin Transformer backbone (counterpart of rlipv2_tpu/models/swin.py;
reference models/swin/swin_transformer.py, variants at
models/swin/backbone.py:105-163).

Parameter names are the reference state-dict keys (`patch_embed.proj`,
`layers.{s}.blocks.{b}.attn.qkv`, `layers.{s}.downsample.reduction`,
`norm{1,2,3}`, ...), so reference-layout weights load with strict=True.
Takes (B, H, W, 3) channels-last pixels and returns stages 1-3 (strides 8,
16, 32) as NCHW tensors. Channels-last inside, as the JAX module.

Behaviour follows the JAX module, which differs from the reference's
detection Swin in two places (ROADMAP queue 3):
  * the feature map is padded with zeros to a window multiple once per
    stage, before its first block, and cropped after the stage, so padded
    tokens pass through every block's norms, MLP and residuals and are keys
    of the edge windows (the reference pads after `norm1` and crops after
    each block);
  * the 4x4/stride-4 patch embedding pads an input side that is not a
    multiple of 4 as flax's "SAME" does: total // 2 low, the rest high.
The shift is taken only when min(Hp, Wp) > window on the padded grid, and
the shift mask is built on the padded grid. PatchMerging concatenates the
2x2 neighbourhood in the reference order [r0c0, r1c0, r0c1, r1c1]; the JAX
module's is [r0c0, r0c1, r1c0, r1c1] and `engine/convert.py::swin`
permutes between the two.

DropPath (stochastic depth, JAX `DropPath`): block i of all the stages
drops each residual branch of a sample with rate linspace(0,
drop_path_rate, sum(depths))[i] and scales the kept ones by 1 / keep. The
keep masks come from the `generator` that the caller passes to `forward`
(never from the global RNG): all of a forward's masks are drawn before its
first block, so a block rematerialized by `use_checkpoint`
(torch.utils.checkpoint around each whole block, as the JAX module's
`nn.remat(SwinBlock.__call__)`) gets the same masks in its recompute. Eval
mode drops nothing. `int8_dense`
makes qkv, proj and the MLP W8A8 (ops/int8_dense.py), inference only, as
the JAX module's `int8_dense`; PatchMerging's reduction stays float.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rlipv2_tpu_torch.ops.int8_dense import linear
from rlipv2_tpu_torch.ops.window_attention import window_attention


@dataclasses.dataclass(frozen=True)
class SwinSpec:
    embed_dim: int
    depths: tuple
    num_heads: tuple
    window_size: int = 7
    pretrain_img_size: int = 224


SWIN_SPECS = {
    "swin_tiny": SwinSpec(96, (2, 2, 6, 2), (3, 6, 12, 24), 7),
    "swin_small": SwinSpec(96, (2, 2, 18, 2), (3, 6, 12, 24), 7),
    "swin_base": SwinSpec(128, (2, 2, 18, 2), (4, 8, 16, 32), 7),
    "swin_base_384": SwinSpec(128, (2, 2, 18, 2), (4, 8, 16, 32), 12, 384),
    "swin_large": SwinSpec(192, (2, 2, 18, 2), (6, 12, 24, 48), 7),
    "swin_large_384": SwinSpec(192, (2, 2, 18, 2), (6, 12, 24, 48), 12, 384),
    # tiny test variant
    "swin_test": SwinSpec(32, (1, 1, 1, 1), (2, 2, 4, 4), 4),
}
OUT_STAGES = (1, 2, 3)  # strides 8, 16, 32


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nH*nW, ws, ws, C); H, W divisible by ws."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    B = wins.shape[0] // ((H // ws) * (W // ws))
    x = wins.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) indices into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0) + np.array([ws - 1, ws - 1])
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shifted_window_mask(H: int, W: int, ws: int, shift: int, device=None) -> torch.Tensor:
    """Additive mask (nW, ws^2, ws^2) float32 for shifted windows on an
    (H, W) grid: 0 within a region, -100 across regions. Built on `device`."""
    img = torch.zeros(H, W, dtype=torch.int32, device=device)
    cnt = 0
    for h_sl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w_sl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[h_sl, w_sl] = cnt
            cnt += 1
    m = img.reshape(H // ws, ws, W // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    return torch.where(m[:, None, :] != m[:, :, None], -100.0, 0.0).float()


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, int8_dense: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads)
        )
        # computed, not loaded: a seeded state dict would fill an integer
        # buffer with zeros
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size)),
            persistent=False,
        )
        self.qkv = linear(dim, 3 * dim, int8=int8_dense)
        self.proj = linear(dim, dim, int8=int8_dense)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """x (nW*B, N, C); mask (nW, N, N) float32 or None."""
        N = x.shape[1]
        h = self.num_heads
        qkv = self.qkv(x)
        bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        bias = bias.view(N, N, h).permute(2, 0, 1)
        dev = x.device.type
        if torch.is_autocast_enabled(dev):
            # the bias is rounded to the compute dtype, as the JAX module's
            bias = bias.to(torch.get_autocast_dtype(dev))
        return self.proj(window_attention(qkv, bias.float(), mask, h))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, int8_dense: bool = False):
        super().__init__()
        self.fc1 = linear(dim, hidden, int8=int8_dense)
        self.fc2 = linear(hidden, dim, int8=int8_dense)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def drop_path(x: torch.Tensor, rate: float, keep: torch.Tensor | None) -> torch.Tensor:
    """The JAX `DropPath` on a drawn keep mask: x / (1 - rate) * keep, keep
    (B, 1, 1, 1) of zeros and ones; x itself where keep is None (eval, or a
    rate of 0)."""
    if keep is None:
        return x
    return x / (1.0 - rate) * keep.to(x.dtype)


class SwinBlock(nn.Module):
    def __init__(
        self, dim: int, num_heads: int, window_size: int, shift: int, mlp_ratio: float = 4.0,
        int8_dense: bool = False, drop_path: float = 0.0,
    ):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size, int8_dense)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), int8_dense)

    def forward(
        self, x: torch.Tensor, shift_mask: torch.Tensor | None, keep: torch.Tensor | None = None
    ) -> torch.Tensor:
        """x (B, H, W, C), H and W window multiples; shift_mask is the
        stage's mask, None where the padded grid is too small to shift;
        keep (2, B, 1, 1, 1), the DropPath keep masks of the attention and
        MLP branches, or None to drop nothing."""
        B, H, W, C = x.shape
        ws = self.window_size
        shift = self.shift if shift_mask is not None else 0
        y = self.norm1(x)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        wins = window_partition(y, ws).reshape(-1, ws * ws, C)
        wins = self.attn(wins, shift_mask if shift else None)
        y = window_reverse(wins.reshape(-1, ws, ws, C), ws, H, W)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + drop_path(y, self.drop_path, None if keep is None else keep[0])
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path, None if keep is None else keep[1])


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        H2, W2 = x.shape[1] // 2, x.shape[2] // 2
        # (B, H2, row, W2, col, C) -> [r0c0, r1c0, r0c1, r1c1], the reference order
        x = x.reshape(B, H2, 2, W2, 2, C).permute(0, 1, 3, 4, 2, 5).reshape(B, H2, W2, 4 * C)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, ceil(H/4), ceil(W/4), C)."""
        ph, pw = (-x.shape[1]) % 4, (-x.shape[2]) % 4
        y = F.pad(x.permute(0, 3, 1, 2), (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return self.norm(self.proj(y).permute(0, 2, 3, 1))


class BasicLayer(nn.Module):
    """One stage: its blocks and the PatchMerging that follows (none after
    the last stage)."""

    def __init__(
        self, dim: int, depth: int, num_heads: int, window_size: int, downsample: bool,
        int8_dense: bool = False, drop_path: tuple = (),
    ):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, shift=0 if b % 2 == 0 else window_size // 2,
                      int8_dense=int8_dense, drop_path=drop_path[b] if drop_path else 0.0)
            for b in range(depth)
        )
        self.downsample = PatchMerging(dim) if downsample else None


class SwinTransformer(nn.Module):
    def __init__(
        self, spec: SwinSpec, drop_path_rate: float = 0.0, int8_dense: bool = False,
        use_checkpoint: bool = False,
    ):
        super().__init__()
        self.spec = spec
        self.drop_path_rate = drop_path_rate
        self.use_checkpoint = use_checkpoint
        n = len(spec.depths)
        # block i's DropPath rate, over all the stages' blocks in order (JAX `dpr`)
        self.drop_path_rates = [float(r) for r in np.linspace(0, drop_path_rate, sum(spec.depths))]
        starts = np.cumsum((0,) + tuple(spec.depths))
        self.out_channels = [spec.embed_dim * 2**s for s in OUT_STAGES]
        self.patch_embed = PatchEmbed(spec.embed_dim)
        self.layers = nn.ModuleList(
            BasicLayer(spec.embed_dim * 2**s, depth, spec.num_heads[s], spec.window_size, s < n - 1,
                       int8_dense, tuple(self.drop_path_rates[starts[s] : starts[s + 1]]))
            for s, depth in enumerate(spec.depths)
        )
        for s in OUT_STAGES:
            self.add_module(f"norm{s}", nn.LayerNorm(spec.embed_dim * 2**s, eps=1e-5))

    @classmethod
    def from_name(
        cls, name: str, drop_path_rate: float = 0.0, int8_dense: bool = False, use_checkpoint: bool = False
    ) -> "SwinTransformer":
        return cls(SWIN_SPECS[name], drop_path_rate, int8_dense, use_checkpoint)

    def drop_path_masks(self, batch: int, generator: torch.Generator | None, device) -> list:
        """Every block's DropPath keep masks, (2, batch, 1, 1, 1) float32
        (the two branches), drawn in one call from `generator`; None for a
        block of rate 0, and for every block in eval mode."""
        n = len(self.drop_path_rates)
        if not (self.training and self.drop_path_rate > 0):
            return [None] * n
        if generator is None:
            raise ValueError(
                "Swin DropPath in train mode draws its masks from an explicit torch.Generator: "
                "pass `generator` (the train step owns one)"
            )
        keep = 1.0 - torch.tensor(self.drop_path_rates, device=device)
        u = torch.rand((n, 2, batch, 1, 1, 1), generator=generator, device=device)
        masks = (u < keep[:, None, None, None, None, None]).float()
        return [None if r == 0 else masks[i] for i, r in enumerate(self.drop_path_rates)]

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> list[torch.Tensor]:
        """(B, H, W, 3) -> the stride 8, 16, 32 maps (B, C, h, w); in train
        mode with drop_path_rate > 0 `generator` draws the DropPath masks."""
        ws = self.spec.window_size
        keeps = iter(self.drop_path_masks(x.shape[0], generator, x.device))
        remat = self.use_checkpoint and torch.is_grad_enabled()
        x = self.patch_embed(x)
        outs = []
        for s, layer in enumerate(self.layers):
            B, H, W, C = x.shape
            xp = F.pad(x, (0, 0, 0, (-W) % ws, 0, (-H) % ws))
            Hp, Wp = xp.shape[1:3]
            mask = shifted_window_mask(Hp, Wp, ws, ws // 2, xp.device) if min(Hp, Wp) > ws else None
            for blk in layer.blocks:
                keep = next(keeps)
                if remat:
                    # the masks are inputs, and a block draws nothing itself,
                    # so its recompute needs no saved RNG state
                    xp = checkpoint(blk, xp, mask, keep, use_reentrant=False, preserve_rng_state=False)
                else:
                    xp = blk(xp, mask, keep)
            x = xp[:, :H, :W]
            if s in OUT_STAGES:
                outs.append(getattr(self, f"norm{s}")(x).permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs
