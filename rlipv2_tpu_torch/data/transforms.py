"""HICO image and box augmentations on uint8 host tensors (counterpart of
rlipv2_tpu/data/transforms.py; reference datasets/hico.py:471-501).

Images are (H, W, 3) uint8 torch tensors on the CPU; the model normalizes on
the device, so nothing here makes a float image. `HOITransform` draws from
its `random.Random` in the JAX transform's order (flip, the three jitter
factors, the branch, the scales, the crop), so one seed gives both the same
geometry:
  * train: horizontal flip; colour jitter 0.4/0.4/0.4; then a multi-scale
    resize (480-800 short side, long side at most 1333), or a resize to
    400/500/600, a random crop of 384-600 and the multi-scale resize;
  * val: the short side to 800, the long side at most 1333.

`item_stream(rng)` makes every draw of the items read on this thread
inside the block come from `rng`: the train loop gives each item of a
global batch its own stream, so an item draws the same whether one
process or one rank of a data-parallel run reads it.

Resizing is bilinear with antialias, as PIL's BILINEAR is when it shrinks
(torch's uint8 path, within one level of PIL). The colour jitter is PIL's
ImageEnhance Brightness, Contrast and Color in turn, each an `Image.blend`
of uint8 images in float32 truncated back to uint8, which is the branch the
JAX package takes where PIL is installed. Boxes stay xyxy in pixels of the
output image until `normalize_boxes`.
"""

from __future__ import annotations

import contextlib
import random
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

TRAIN_SCALES = [480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800]
_ITEM = threading.local()


@contextlib.contextmanager
def item_stream(rng: random.Random):
    """Inside the block, `item_rng` gives `rng` on this thread: every
    augmentation (and the R-Tagger dataset's pair sample) of the items read
    there draws from it."""
    before = getattr(_ITEM, "rng", None)
    _ITEM.rng = rng
    try:
        yield
    finally:
        _ITEM.rng = before


def item_rng(own: random.Random) -> random.Random:
    """The stream of `item_stream` where one is set on this thread, else
    `own`."""
    rng = getattr(_ITEM, "rng", None)
    return own if rng is None else rng


def resize_image(img: torch.Tensor, size: int, max_size: Optional[int] = 1333):
    """(H, W, 3) uint8 -> resized so that the short side is `size` and the
    long side at most `max_size`, and the (sh, sw) scale factors."""
    h, w = img.shape[:2]
    short, long = min(h, w), max(h, w)
    scale = size / short
    if max_size is not None and long * scale > max_size:
        scale = max_size / long
    nh, nw = int(round(h * scale)), int(round(w * scale))
    # (1, 3, H, W) in channels-last memory, the layout of the uint8 kernel
    x = img.permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)
    out = F.interpolate(x, size=(nh, nw), mode="bilinear", antialias=True, align_corners=False)
    return out[0].permute(1, 2, 0).contiguous(), (nh / h, nw / w)


def luma(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 -> (H, W) uint8, PIL's RGB -> L conversion
    (ITU-R 601-2 weights in 16-bit fixed point, rounded)."""
    x = img.to(torch.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16).to(torch.uint8)


def blend(degenerate: torch.Tensor, img: torch.Tensor, factor: float) -> torch.Tensor:
    """PIL's `Image.blend(degenerate, img, factor)` on uint8: d + f * (x - d)
    in float32, clipped to [0, 255] and truncated."""
    f = torch.tensor(factor, dtype=torch.float32)
    d = degenerate.to(torch.float32)
    diff = (img.to(torch.int32) - degenerate.to(torch.int32)).to(torch.float32)
    out = d + diff * f
    return out.clamp_(0.0, 255.0).to(torch.uint8)


class HOITransform:
    """The train / val pipeline. target fields: boxes (n, 4) xyxy pixels,
    labels (n,), and box_indices (n,) when present; a crop drops the boxes
    it empties from all three."""

    def __init__(self, train: bool, scales=None, max_size: int = 1333, rng=None, val_size: int = 800):
        self.train = train
        self.scales = scales or TRAIN_SCALES
        self.max_size = max_size
        self.val_size = val_size
        self.rng = rng or random.Random()

    def hflip(self, img, target):
        w = img.shape[1]
        if len(target["boxes"]):
            b = target["boxes"]
            target["boxes"] = np.stack([w - b[:, 2], b[:, 1], w - b[:, 0], b[:, 3]], axis=1)
        return img.flip(1), target

    def color_jitter(self, img, strength=0.4):
        """Brightness (blend with black), contrast (blend with the rounded
        mean of the luma image) and saturation (blend with the luma image),
        in that order, each on the previous one's uint8 result."""
        b = item_rng(self.rng).uniform(1 - strength, 1 + strength)
        c = item_rng(self.rng).uniform(1 - strength, 1 + strength)
        s = item_rng(self.rng).uniform(1 - strength, 1 + strength)
        img = blend(torch.zeros_like(img), img, b)
        gray = luma(img)
        mean = int(gray.sum(dtype=torch.int64).item() / gray.numel() + 0.5)
        img = blend(torch.full_like(img, mean), img, c)
        return blend(luma(img)[..., None].expand_as(img), img, s)

    def random_resize(self, img, target, sizes):
        size = item_rng(self.rng).choice(sizes)
        img, (sh, sw) = resize_image(img, size, self.max_size)
        if len(target["boxes"]):
            target["boxes"] = target["boxes"] * np.array([sw, sh, sw, sh], np.float32)
        return img, target

    def random_size_crop(self, img, target, min_size=384, max_crop=600):
        h, w = img.shape[:2]
        cw = item_rng(self.rng).randint(min_size, min(w, max_crop)) if w > min_size else w
        ch = item_rng(self.rng).randint(min_size, min(h, max_crop)) if h > min_size else h
        x0 = item_rng(self.rng).randint(0, max(w - cw, 0)) if w > cw else 0
        y0 = item_rng(self.rng).randint(0, max(h - ch, 0)) if h > ch else 0
        img = img[y0 : y0 + ch, x0 : x0 + cw]
        if len(target["boxes"]):
            b = target["boxes"] - np.array([x0, y0, x0, y0], np.float32)
            b[:, 0::2] = b[:, 0::2].clip(0, cw)
            b[:, 1::2] = b[:, 1::2].clip(0, ch)
            keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
            target["boxes"] = b[keep]
            target["labels"] = target["labels"][keep]
            if "box_indices" in target:
                target["box_indices"] = target["box_indices"][keep]
        return img, target

    def __call__(self, img: torch.Tensor, target: dict):
        """(H, W, 3) uint8 -> the augmented (H', W', 3) uint8 image,
        contiguous, and the target with boxes xyxy in its pixels."""
        if self.train:
            if item_rng(self.rng).random() < 0.5:
                img, target = self.hflip(img, target)
            img = self.color_jitter(img)
            if item_rng(self.rng).random() < 0.5:
                img, target = self.random_resize(img, target, self.scales)
            else:
                img, target = self.random_resize(img, target, [400, 500, 600])
                img, target = self.random_size_crop(img, target)
                img, target = self.random_resize(img, target, self.scales)
        else:
            img, target = self.random_resize(img, target, [self.val_size])
        return img.contiguous(), target


def normalize_boxes(boxes_xyxy: np.ndarray, h: int, w: int) -> np.ndarray:
    """xyxy px -> normalized cxcywh (reference: datasets/transforms.py
    Normalize)."""
    if len(boxes_xyxy) == 0:
        return boxes_xyxy.reshape(0, 4)
    b = boxes_xyxy.astype(np.float32)
    cx = (b[:, 0] + b[:, 2]) / 2 / w
    cy = (b[:, 1] + b[:, 3]) / 2 / h
    bw = (b[:, 2] - b[:, 0]) / w
    bh = (b[:, 3] - b[:, 1]) / h
    return np.stack([cx, cy, bw, bh], axis=1)
