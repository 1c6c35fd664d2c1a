"""Optimizer, LR schedules and EMA (counterpart of rlipv2_tpu/engine/optim.py).

  * three AdamW groups with their own learning rates, weight decay
    `cfg.weight_decay` in each: the model (`cfg.lr`), the backbone
    (`cfg.lr_backbone`) and the RoBERTa text encoder (`cfg.lr_text_encoder`)
    (reference main.py:523-552);
  * the step / multistep / linear-warmup schedules in units of train steps
    (reference util/optim.py:32-120) as one `LambdaLR` factor;
  * frozen parameters get requires_grad=False (`freeze_parameters`), by
    reference state-dict name (`frozen`): the ResNet stem `conv1` and
    `layer1` (reference models/backbone.py trains layer2-4; FrozenBN is
    buffers already), as the JAX `_param_group`, whose rule freezes no Swin
    parameter (`patch_embed`, `stage{s}_block{d}`, `merge{s}` and
    `out_norm{s}` hold none of its names), so a Swin backbone trains
    whole at `lr_backbone`; and the fine-tune's `freeze_regime` (JAX
    `_regime_frozen`, reference main.py:632-688): "frozen_vision" also
    freezes ResNet `layer2` (nothing more on Swin), "unfrozen_params"
    trains the RoBERTa text encoder alone, "frozen_detection" freezes the
    backbone, the ALIF encoder, the ho decoder (its box heads too) and the
    input projections with their GroupNorms (the JAX `input_norm_{i}`);
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
`conv1` of blocks 0-9 of backbone stages 2-4 (its name filter looks for
"conv1" within 20 characters of "backbone", as in "/layer2_block0/conv1");
the reference trains them, and so does the port.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

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


FREEZE_REGIMES = ("frozen_vision", "unfrozen_params", "frozen_detection")
_BODY = "backbone.0.body."


def frozen(name: str, regime: Optional[str] = None) -> bool:
    """Whether the parameter of reference name `name` is frozen: the
    backbone's stem and layer1 always (the ResNet names; a Swin has
    neither), and what `regime` adds."""
    if name.startswith((_BODY + "conv1.", _BODY + "layer1.")):
        return True
    if regime is None:
        return False
    if regime == "frozen_vision":
        return name.startswith(_BODY + "layer2.")
    if regime == "unfrozen_params":
        return not name.startswith("transformer.text_encoder.")
    if regime == "frozen_detection":
        return name.startswith(("backbone.", "transformer.encoder.", "transformer.ho_decoder.", "input_proj."))
    raise ValueError(f"unknown freeze_regime {regime!r}; known: {FREEZE_REGIMES}")


def freeze_parameters(model: torch.nn.Module, regime: Optional[str] = None) -> None:
    """requires_grad=False on every parameter `frozen` names. A parameter
    registered under two names (the box heads) is judged by its first, as
    `named_parameters` gives it: the decoder's."""
    for name, p in model.named_parameters():
        if frozen(name, regime):
            p.requires_grad_(False)


def build_optimizer(
    model: torch.nn.Module, cfg: TrainConfig, steps_per_epoch: int = 1000, freeze_text_encoder: bool = False
) -> tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """(AdamW over the three groups, its LambdaLR). It first freezes
    (requires_grad=False) what `freeze_parameters` does for
    `cfg.freeze_regime` and, with `freeze_text_encoder`, the RoBERTa
    parameters, as the JAX `create_train_state(freeze_text_encoder=True)`
    keeps them out of its optimizer; the frozen parameters are left out.
    The AdamW is the fused one, whose `found_inf` lets the train step skip
    an update on the device."""
    freeze_parameters(model, cfg.freeze_regime)
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
