"""Optimizer, LR schedules and EMA (counterpart of rlipv2_tpu/engine/optim.py).

  * three AdamW groups with their own learning rates, weight decay
    `cfg.weight_decay` in each: the model (`cfg.lr`), the backbone
    (`cfg.lr_backbone`) and the RoBERTa text encoder (`cfg.lr_text_encoder`)
    (reference main.py:523-552);
  * the step / multistep / linear-warmup schedules in units of train steps
    (reference util/optim.py:32-120) as one `LambdaLR` factor;
  * the frozen parameters of the reference: the backbone's stem `conv1` and
    `layer1` get requires_grad=False (reference models/backbone.py keeps
    only layer2-4 trainable); FrozenBN is buffers already;
  * `update_ema`, Polyak averaging (reference util/optim.py:12-29).

Global gradient clipping at `cfg.clip_max_norm` runs in the train step over
the parameters that have a gradient, as the reference's
`clip_grad_norm_(model.parameters(), 0.1)` (engine.py:169) does.

Two places where the port follows the reference and not the JAX package
(ROADMAP queue 3): the JAX `optax.clip_by_global_norm` runs over the whole
parameter tree, so the grads of frozen leaves inflate its norm; and its
AdamW weight decay moves text-encoder parameters that get a zero gradient
on the frozen-text path. Here a parameter without a gradient is neither
counted in the norm nor moved by AdamW. The JAX package also freezes
`conv1` of the first block of backbone stages 2-4 (its name filter
matches "conv1" in "/layer2_block0/conv1"); the reference trains them, and
so does the port.

The `freeze_regime` options raise NotImplementedError until a caller needs
them (ROADMAP queue 1 item 15).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from rlipv2_tpu_torch.config import TrainConfig


def lr_factor(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Multiplier of each group's base learning rate at a train step."""
    if cfg.schedule == "step":
        drop = cfg.lr_drop * steps_per_epoch
        return lambda step: 1.0 if step < drop else 0.1
    if cfg.schedule == "multistep":
        d1 = cfg.lr_drop * steps_per_epoch
        d2 = (cfg.lr_drop + 2) * steps_per_epoch
        return lambda step: 0.1 ** (int(step >= d1) + int(step >= d2))
    if cfg.schedule in ("linear_with_warmup", "all_linear_with_warmup"):
        total = cfg.epochs * steps_per_epoch

        def factor(step):
            if step < cfg.warmup_steps:
                return min(step / max(cfg.warmup_steps, 1), 1.0)
            return max(0.0, (total - step) / max(total - cfg.warmup_steps, 1))

        return factor
    raise ValueError(f"unknown schedule: {cfg.schedule}")


def param_group_name(name: str) -> str:
    """backbone / text_encoder / model, by reference state-dict name."""
    if name.startswith("backbone."):
        return "backbone"
    if name.startswith("transformer.text_encoder."):
        return "text_encoder"
    return "model"


def freeze_backbone_stem_and_layer1(model: torch.nn.Module) -> None:
    """requires_grad=False on the backbone's stem conv and layer1, as the
    reference does for every backbone parameter outside layer2-4."""
    for name, p in model.named_parameters():
        if name.startswith("backbone.") and not any(f".layer{i}." in name for i in (2, 3, 4)):
            p.requires_grad_(False)


def build_optimizer(
    model: torch.nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1000, freeze_text_encoder: bool = False
) -> tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """(AdamW over the three groups, its LambdaLR). The frozen parameters
    (requires_grad=False) are left out; `freeze_text_encoder` freezes the
    RoBERTa parameters first (requires_grad=False), as the JAX
    `create_train_state(freeze_text_encoder=True)` keeps them out of its
    optimizer. The AdamW is the fused one, whose `found_inf` lets the train
    step skip an update on the device."""
    if cfg.freeze_regime is not None:
        raise NotImplementedError(
            f"freeze_regime={cfg.freeze_regime!r} is not ported yet (ROADMAP queue 1 item 15)"
        )
    lrs = {"model": cfg.lr, "backbone": cfg.lr_backbone, "text_encoder": cfg.lr_text_encoder}
    groups: dict[str, list] = {k: [] for k in lrs}
    for name, p in model.named_parameters():
        if freeze_text_encoder and param_group_name(name) == "text_encoder":
            p.requires_grad_(False)
        if p.requires_grad:
            groups[param_group_name(name)].append(p)
    opt = torch.optim.AdamW(
        [{"params": ps, "lr": lrs[k], "name": k} for k, ps in groups.items() if ps],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay, fused=True,
    )
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_factor(cfg, steps_per_epoch))


@torch.no_grad()
def update_ema(ema_params: Iterable[torch.Tensor], params: Iterable[torch.Tensor], decay: float) -> None:
    """In place: ema = ema * decay + param * (1 - decay)."""
    for e, p in zip(ema_params, params):
        e.mul_(decay).add_(p.detach(), alpha=1.0 - decay)
