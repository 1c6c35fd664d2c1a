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
  * `update_ema`, Polyak averaging (reference util/optim.py:12-29);
  * `ModelAxisShards`: the optimizer and the EMA over the shards that a
    placement plan splits over a model axis (`engine/train.py`), with the
    same parameter groups, learning rates and weight decay.

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

from typing import Callable, Iterable, Optional, Sequence

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


class ModelAxisShards:
    """One rank's shards of the parameters that a placement plan ({name:
    split dimension or None}, `engine/train.py`) splits over the model
    axis `axis` (a `parallel/mesh.py` DataParallel over the model group).
    A split parameter that `optimizer` holds is replaced in its parameter
    group, at its place, by a shard copy: the optimizer keeps its moments
    for the shard alone, with the group's learning rate and weight decay,
    and the EMA keeps the shard (`held`). The whole parameter stays in the
    model for the forward and backward; `before_step` copies its current
    slice into the shard and the slice of its (reduced, clipped) gradient
    into the shard's, and `after_step` all-gathers the stepped shards back
    into it. A parameter that the plan keeps whole, or that no optimizer
    holds (frozen), is not touched. A checkpoint holds whole tensors:
    `whole_optimizer_state` and `whole` gather them (collectives), and
    `part_optimizer_state` and `part` take this rank's slices of them, so
    a file moves between sharded and unsharded runs."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer, plan: dict, axis):
        self.axis = axis
        held = {id(p) for g in optimizer.param_groups for p in g["params"]}
        self.split = []  # (name, parameter, dimension, shard)
        for name, p in model.named_parameters():
            dim = plan.get(name)
            if dim is not None and axis.world > 1 and id(p) in held:
                self.split.append((name, p, dim, self.part_of(p, dim).clone()))
        self.dims = {name: dim for name, _, dim, _ in self.split}
        self._by_name = {name: (p, s) for name, p, _, s in self.split}
        swap = {id(p): s for _, p, _, s in self.split}
        for g in optimizer.param_groups:
            g["params"] = [swap.get(id(p), p) for p in g["params"]]
        for _, p, dim, s in self.split:  # moments loaded before the plan
            if p in optimizer.state:
                optimizer.state[s] = {k: self._cut(v, p.shape, dim) for k, v in optimizer.state.pop(p).items()}
        self._swap = swap

    def part_of(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of the whole tensor `x` (a view)."""
        n = x.shape[dim] // self.axis.world
        return x.detach().narrow(dim, self.axis.rank * n, n)

    def _cut(self, v, shape, dim):
        """A state entry's slice where it has the parameter's shape (the
        moments); others (the step count) as they are."""
        return self.part_of(v, dim).clone() if torch.is_tensor(v) and v.shape == shape else v

    def held(self, params: Sequence[torch.Tensor]) -> list:
        """`params` with each split parameter's shard in its place."""
        return [self._swap.get(id(p), p) for p in params]

    def zero_grad(self) -> None:
        """The whole split parameters' gradients gone (the optimizer's
        zero_grad clears the shards')."""
        for _, p, _, _ in self.split:
            p.grad = None

    @torch.no_grad()
    def before_step(self) -> None:
        for _, p, dim, s in self.split:
            s.copy_(self.part_of(p, dim))
            s.grad = None if p.grad is None else self.part_of(p.grad, dim).contiguous()

    @torch.no_grad()
    def after_step(self) -> None:
        for _, _, _, s in self.split:
            s.grad = None
        shards = [s for _, _, _, s in self.split]
        for i, whole in self.axis.gather_split(shards, [dim for _, _, dim, _ in self.split]):
            self.split[i][1].copy_(whole)

    def _indices(self, optimizer) -> dict:
        """{split name: its index in the optimizer's state_dict}."""
        order = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
        return {name: order[id(s)] for name, _, _, s in self.split}

    def whole_optimizer_state(self, optimizer: torch.optim.Optimizer) -> dict:
        """optimizer.state_dict() with each split parameter's moments
        gathered whole on the CPU: the state dict of the unsharded
        optimizer. A collective of the model group."""
        sd = optimizer.state_dict()
        state = {i: dict(v) for i, v in sd["state"].items()}
        keys, shards, dims = [], [], []
        for name, i in self._indices(optimizer).items():
            s = self._by_name[name][1]
            for k, v in state.get(i, {}).items():
                if torch.is_tensor(v) and v.shape == s.shape:
                    keys.append((i, k))
                    shards.append(v)
                    dims.append(self.dims[name])
        for j, whole in self.axis.gather_split(shards, dims, host=True):
            i, k = keys[j]
            state[i][k] = whole
        return {**sd, "state": state}

    def part_optimizer_state(self, optimizer: torch.optim.Optimizer, sd: dict) -> dict:
        """The unsharded optimizer's state dict `sd` with each split
        parameter's moments cut to this rank's slice."""
        state = {i: dict(v) for i, v in sd["state"].items()}
        for name, i in self._indices(optimizer).items():
            shape = self._by_name[name][0].shape
            if i in state:
                state[i] = {k: self._cut(v, shape, self.dims[name]) for k, v in state[i].items()}
        return {**sd, "state": state}

    def whole(self, names: Sequence[str], tensors: Sequence[torch.Tensor]) -> list:
        """`tensors` (the EMA, by parameter name) with each split one
        gathered whole on the CPU. A collective of the model group."""
        out = list(tensors)
        at = [j for j, name in enumerate(names) if name in self.dims]
        for j, whole in self.axis.gather_split([out[k] for k in at], [self.dims[names[k]] for k in at], host=True):
            out[at[j]] = whole
        return out

    def part(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor `x` of parameter `name`;
        `x` where the plan keeps it whole."""
        return x if name not in self.dims else self.part_of(x, self.dims[name])
