"""Checkpoint save and resume (counterpart of rlipv2_tpu/engine/checkpoint.py:21-51;
reference main.py:599-613 resume and :726-757 save).

`CheckpointManager(directory, keep=5, save_interval=1)` writes one file per
saved step, `checkpoint{step:04d}.pth`: `torch.save` of the reference's
layout, a dict with the model's state dict under `model`, then
`optimizer`, `lr_scheduler`, `epoch`, `ema` and `args`, and `rng`: the
random states a run draws from (the global CPU generator, the model's CUDA
device's, the train step's generator of the DropPath masks and the
tagger's noise, the train augmentations' `random.Random` and the R-Tagger
dataset's pair sampler). Each file is written to a temporary name and renamed, so
a file that exists is whole; only the last `keep` stay. `restore(target)`
loads the newest (or a given) step into a `TrainState` in place, the model
strictly, so a resumed run continues the optimizer's moments, the
scheduler's step count, its learning rates and the random streams: k steps,
a save, a restore and one more step equal k + 1 straight steps, dropout and
DropPath on. (The JAX step keeps its key in `TrainState.rng`; its
augmentations draw from an unseeded `random.Random`.) A file without `rng`
(written before the port saved it) still loads; the run keeps the states
it was seeded with, and `TrainState.rng_restored` is False.

In a data-parallel run (`TrainState.mesh`) every rank calls `save` and
`restore`: the ranks' random states (each draws its own dropout masks and
train-step generator stream) are gathered, rank 0 alone writes the file,
with its own states under `rng` and every rank's under `rng_ranks`, and on
a restore each rank takes its own. A file written by a run of another
world size restores the rest, and the per-rank states stay as seeded
(`rng_restored` False).
"""

from __future__ import annotations

import dataclasses
import os
import random
import re
from pathlib import Path
from typing import Any, Optional

import torch

from rlipv2_tpu_torch.parallel.mesh import DataParallel

_NAME = re.compile(r"^checkpoint(\d+)\.pth$")


@dataclasses.dataclass
class TrainState:
    """What a run keeps: the model, its optimizer and scheduler, the EMA
    tensors of its trainable parameters (the train step's `ema_params`, in
    `named_parameters` order) and the last finished epoch."""

    model: torch.nn.Module
    optimizer: Optional[torch.optim.Optimizer] = None
    lr_scheduler: Optional[Any] = None
    ema: Optional[list] = None
    epoch: int = -1
    # the train step's generator (`make_train_step`'s `train_step.generator`),
    # the train augmentations' random.Random and the tagger dataset's
    # negative-pair sampler (`VGRelTaggerDataset.pair_rng`)
    generator: Optional[torch.Generator] = None
    data_rng: Optional[random.Random] = None
    sampler_rng: Optional[random.Random] = None
    # after a load: whether the file held the random states
    rng_restored: Optional[bool] = None
    # the data axis of a data-parallel run (`parallel/mesh.py`)
    mesh: Optional[DataParallel] = None

    def _trainable_names(self) -> list[str]:
        return [k for k, p in self.model.named_parameters() if p.requires_grad]

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def state_dict(self) -> dict:
        """The checkpoint's content; with `mesh` a collective: every rank
        calls it, and each gets every rank's random states."""
        device = self._device()
        rng = {
            "torch": torch.get_rng_state(),
            "cuda": torch.cuda.get_rng_state(device) if device.type == "cuda" else None,
            "step": None if self.generator is None else self.generator.get_state(),
            "data": None if self.data_rng is None else self.data_rng.getstate(),
            "sampler": None if self.sampler_rng is None else self.sampler_rng.getstate(),
        }
        state = {
            "model": self.model.state_dict(),
            "optimizer": None if self.optimizer is None else self.optimizer.state_dict(),
            "lr_scheduler": None if self.lr_scheduler is None else self.lr_scheduler.state_dict(),
            "epoch": self.epoch,
            "ema": None if self.ema is None else dict(zip(self._trainable_names(), self.ema)),
            "rng": rng,
        }
        if self.mesh is not None:
            state["rng_ranks"] = self.mesh.gather_objects(rng)
        return state

    def _load_rng(self, rng: dict) -> None:
        torch.set_rng_state(rng["torch"])
        device = self._device()
        if device.type == "cuda" and rng["cuda"] is not None:
            torch.cuda.set_rng_state(rng["cuda"], device)
        if self.generator is not None:
            if rng["step"] is None:
                raise ValueError("the checkpoint holds no state of the train step's generator")
            self.generator.set_state(rng["step"])
        if self.data_rng is not None:
            if rng["data"] is None:
                raise ValueError("the checkpoint holds no state of the augmentations' random.Random")
            self.data_rng.setstate(rng["data"])
        if self.sampler_rng is not None:
            if rng.get("sampler") is None:
                raise ValueError("the checkpoint holds no state of the tagger dataset's pair sampler")
            self.sampler_rng.setstate(rng["sampler"])

    def load_state_dict(self, state: dict) -> None:
        """In place, the model strictly. A part that this state does not
        hold (an evaluation holds no optimizer) is skipped; a part that it
        holds and the file lacks raises."""
        self.model.load_state_dict(state["model"], strict=True)
        for name in ("optimizer", "lr_scheduler"):
            own = getattr(self, name)
            if own is None:
                continue
            if state[name] is None:
                raise ValueError(f"the checkpoint holds no {name}")
            own.load_state_dict(state[name])
        if self.ema is not None:
            saved = state["ema"]
            names = self._trainable_names()
            if saved is None or list(saved) != names:
                raise ValueError("the checkpoint holds no EMA of the model's trainable parameters")
            with torch.no_grad():
                for e, k in zip(self.ema, names):
                    e.copy_(saved[k])
        self.epoch = int(state["epoch"])
        self.rng_restored = "rng" in state
        if self.rng_restored and self.mesh is not None:
            ranks = state.get("rng_ranks")
            if ranks is not None and len(ranks) == self.mesh.world:
                self._load_rng(ranks[self.mesh.rank])
                return
            self.rng_restored = False  # another world size's states: the shared ones only
            rng = state["rng"]
            if self.data_rng is not None and rng["data"] is not None:
                self.data_rng.setstate(rng["data"])
            return
        if self.rng_restored:
            self._load_rng(state["rng"])


class CheckpointManager:
    def __init__(self, directory, keep: int = 5, save_interval: int = 1):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.save_interval = save_interval

    def path(self, step: int) -> Path:
        return self.directory / f"checkpoint{step:04d}.pth"

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in self.directory.iterdir() if (m := _NAME.match(f.name)))

    def save(self, step: int, state: TrainState, config: Optional[Any] = None) -> Optional[Path]:
        """Write `state` as step `step` unless `step` is off the save
        interval; `config` (a dataclass, a Namespace or a dict) goes under
        `args`. Returns the file written, or None. With `state.mesh` every
        rank calls it and rank 0 writes; the others return None once the
        file is there."""
        if step % self.save_interval:
            return None
        payload = state.state_dict()
        if state.mesh is not None and state.mesh.rank != 0:
            state.mesh.barrier()
            return None
        if dataclasses.is_dataclass(config):
            config = dataclasses.asdict(config)
        elif config is not None and not isinstance(config, dict):
            config = dict(vars(config))
        out = self.path(step)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        torch.save({**payload, "args": config}, tmp)
        os.replace(tmp, out)
        for old in self.steps()[: -self.keep]:
            self.path(old).unlink()
        if state.mesh is not None:
            state.mesh.barrier()
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, target: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """Load step `step` (default the newest) into `target` and return
        it; None when the directory holds no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return load_checkpoint(target, self.path(step))

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX interface."""


def load_checkpoint(target: TrainState, path) -> TrainState:
    """Load one checkpoint file into `target` in place (weights_only: the
    file holds tensors, numbers, strings and containers of them)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    target.load_state_dict(state)
    return target
