"""The train step (counterpart of rlipv2_tpu/engine/train.py; reference
engine.py:45-201 `train_one_epoch` inner loop), on one device.

`make_train_step(model, criterion, optimizer, scheduler, tcfg)` returns
`train_step(batch) -> metrics`. One step runs the forward (bf16 autocast
when the model's config says so), the criterion and `weighted_total`, the
backward, the non-finite check, global gradient clipping over the
parameters that have a gradient, the optimizer step and the scheduler step.

The host waits for the device once per step, when the matcher copies the
cost matrices of all decoder layers to the host. Everything after that is
enqueued: the metrics stay device tensors, so the loop can read them one
step late, and a non-finite loss skips the update on the device through
the fused AdamW's `found_inf` (the reference aborts training instead,
engine.py:125-128; the JAX step zeroes the grads and sets `nonfinite`).

Not ported yet, and rejected: gradient accumulation, mesh shardings, the
R-Tagger step and in-graph text-encoder training (ROADMAP queue 1 items 15,
16 and 18). A config with an int8 inference option (`msda_impl
"pallas_int8"`, either `int8_dense`) is refused with a ValueError: those
paths are forward only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rlipv2_tpu_torch.config import ModelConfig, TrainConfig
from rlipv2_tpu_torch.engine.optim import update_ema
from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
from rlipv2_tpu_torch.structures import HOITargets


class TrainBatch(NamedTuple):
    pixels: torch.Tensor  # (B, H, W, 3) uint8
    pixel_valid: torch.Tensor  # (B, H, W) bool
    text_emb: torch.Tensor  # (B, T, l_dim) cached text features
    text_valid: torch.Tensor  # (B, T) bool
    targets: HOITargets


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ValueError for a config that selects an int8 inference path:
    the int8 MSDA kernel has no backward, and the int8 products' rounding
    has no useful gradient."""
    options = [
        name
        for name, on in (
            ('transformer.msda_impl="pallas_int8"', cfg.transformer.msda_impl == "pallas_int8"),
            ("transformer.int8_dense", cfg.transformer.int8_dense),
            ("backbone.int8_dense", cfg.backbone.int8_dense),
        )
        if on
    ]
    if options:
        raise ValueError(
            f"{', '.join(options)}: int8 paths are inference only and cannot be trained; "
            "train with the exact config and quantize for evaluation"
        )


def make_train_step(
    model: torch.nn.Module,
    criterion: SetCriterionHOI,
    optimizer: torch.optim.Optimizer,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler],
    tcfg: TrainConfig,
    accumulation_steps: int = 1,
    mesh=None,
    tagger: bool = False,
):
    """Returns train_step(batch: TrainBatch) -> metrics (device tensors):
    loss, nonfinite (1.0 when the update was skipped), grad_norm (before
    clipping; 0 when skipped, as in the JAX step) and every loss term.
    With `tcfg.ema`, `train_step.ema_params` holds the Polyak average of
    the trainable parameters."""
    check_trainable(model.cfg)
    if accumulation_steps != 1:
        raise NotImplementedError("gradient accumulation is not ported yet (ROADMAP queue 1 item 15)")
    if mesh is not None:
        raise NotImplementedError("sharded training is not ported yet (ROADMAP queue 1 item 18)")
    if tagger:
        raise NotImplementedError("the R-Tagger train step is not ported yet (ROADMAP queue 1 item 16)")
    n_obj = model.cfg.max_obj_texts
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: TrainBatch) -> dict:
        optimizer.zero_grad(set_to_none=True)
        out = model(batch.pixels, batch.pixel_valid, batch.text_emb, batch.text_valid, n_obj)
        losses = criterion(
            out, batch.targets, batch.text_valid[:, :n_obj], batch.text_valid[:, n_obj:]
        )
        total = criterion.weighted_total(losses)
        total.backward()
        finite = torch.isfinite(total)
        grad_norm = torch.nn.utils.clip_grad_norm_(
            [p for p in params if p.grad is not None], tcfg.clip_max_norm
        )
        optimizer.found_inf = (~finite).float()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        if tcfg.ema:
            update_ema(train_step.ema_params, params, tcfg.ema_decay)
        return {
            "loss": total.detach(),
            "nonfinite": (~finite).float(),
            "grad_norm": torch.where(finite, grad_norm, torch.zeros_like(grad_norm)),
            **{k: v.detach() for k, v in losses.items()},
        }

    train_step.ema_params = [p.detach().clone() for p in params] if tcfg.ema else None
    return train_step
