"""The train step (counterpart of rlipv2_tpu/engine/train.py; reference
engine.py:45-201 `train_one_epoch` inner loop), on one device or one
rank of a data-parallel run.

`make_train_step(model, criterion, optimizer, scheduler, tcfg,
accumulation_steps=K)` returns `train_step(batch) -> metrics`. One step runs
the forward (bf16 autocast when the model's config says so), the criterion
and `weighted_total`, the backward, the non-finite check, global gradient
clipping over the parameters that have a gradient, the optimizer step and
the scheduler step. With K > 1 (RLIPv2's pre-training over interleaved
datasets, JAX :193-224, reference engine.py:138-165) `batch` is a group of
K TrainBatches: each runs its forward and backward in turn, so the peak
memory is one micro-batch's, the gradients add up in `.grad` and are then
divided by K, and the loss and every loss term are the means over the
group, as the JAX step's are. The non-finite check (on the mean loss),
the clipping, the one optimizer step, the scheduler step and the EMA
update follow the group; the schedule counts optimizer steps.

The step owns a `torch.Generator` on the model's device, seeded from
`TrainConfig.seed`, and passes it to every forward: the Swin backbone's
DropPath draws its masks from it (the JAX step splits its "dropout" key).
The other dropouts draw from the global RNG, as the reference's do.

With `token_ids` and `token_mask` in the batch the step encodes the slot
texts with the model's RoBERTa inside the graph (dropout as the model's
mode says), so the text-encoder group gets gradients (JAX :104-123); the
batch's `text_emb` is then read only by the offline pseudo-verb target.
With `cfg.pseudo_verb` the criterion gets pseudo-verb targets: online from
the forward's detached post-ALIF language states (Euclidean), offline from
`text_emb` (cosine) (JAX :161-183). A model whose forward returns no
`lang_states` (RLIPParSe, RLIPParSeV1Joint: `LANG_STATES` False) refuses
the online mode with a ValueError when the step is built; the JAX step
fails there with a KeyError.

The host waits for the device once per micro-batch, when the matcher copies
the cost matrices of all decoder layers to the host (the triplet filter
works on that copy). Everything after that is
enqueued: the metrics stay device tensors, so the loop can read them one
step late, and a non-finite loss skips the update on the device through
the fused AdamW's `found_inf` (the reference aborts training instead,
engine.py:125-128; the JAX step zeroes the grads and sets `nonfinite`).

With `tagger=True` the step trains the R-Tagger (JAX `tagger_loss_fn`,
:125-150): `model.forward_tagger` (a model built with `tagger=True` and
`subject_class`) takes the batch's GT pairs as queries, noised with
`box_noise_scale` and `label_noise_scale` from the step's generator, and
the criterion's slot-aligned `tagger_losses` take the place of the
Hungarian losses.

With `mesh`, a `parallel/mesh.py` DataParallel (one process per card,
`engine/launch.py`; JAX :256-285, the `data` mesh), the step is a
data-parallel step: each rank takes its contiguous slice of every global
micro-batch (`P("data")`; the slot tokens whole on every rank, as JAX
replicates them), and the criterion, given the handle, divides by the
global batch's normalizers (`losses/criterion.py::_total`), so every loss
term is the rank's share of the global term. After the (accumulated)
backward one bucketed all-reduce sums the gradients over the ranks: the
summed gradient is the gradient of the JAX loss over the whole global
batch, which the JAX step computes as one program. The loss, its terms
and the gradient norm it returns are global values, the same on every
rank; the clip by the global norm, the skip of a non-finite update, the
fused AdamW step and the EMA then run alike on every rank. At
construction rank 0's parameters and buffers are broadcast, as a
DistributedDataParallel wrapper does. The generator is seeded from
`TrainConfig.seed` plus the rank (the reference seeds each rank so), so
ranks draw their own DropPath masks and tagger noise. Online pseudo verbs
read the language states of the global batch's first image, which lies
on rank 0: it broadcasts them. No DistributedDataParallel wrapper: the
slot texts are encoded outside the model's forward, and an accumulated
step reduces once. A model axis (FSDP) is not ported: ROADMAP queue 1
item 18.2.

A config with an int8 inference option (`msda_impl "pallas_int8"`, either
`int8_dense`) is refused with a ValueError: those paths are forward only.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import torch

from rlipv2_tpu_torch.config import ModelConfig, TrainConfig
from rlipv2_tpu_torch.engine.optim import update_ema
from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
from rlipv2_tpu_torch.losses.pseudo_verb import pseudo_verb_similarity
from rlipv2_tpu_torch.parallel.mesh import MODEL_AXIS_TODO, DataParallel
from rlipv2_tpu_torch.structures import HOITargets


class TrainBatch(NamedTuple):
    pixels: torch.Tensor  # (B, H, W, 3) uint8
    pixel_valid: torch.Tensor  # (B, H, W) bool
    text_emb: Optional[torch.Tensor]  # (B, T, l_dim) cached text features; None with tokens
    text_valid: torch.Tensor  # (B, T) bool
    targets: HOITargets
    # the slot texts' tokens (T, L), shared by the batch: the step encodes
    # them in the graph and the text encoder trains
    token_ids: Optional[torch.Tensor] = None
    token_mask: Optional[torch.Tensor] = None


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
    box_noise_scale: Optional[float] = None,
    label_noise_scale: Optional[float] = None,
):
    """Returns train_step(batch) -> metrics (device tensors): loss,
    nonfinite (1.0 when the update was skipped), grad_norm (before
    clipping; 0 when skipped, as in the JAX step) and every loss term;
    `batch` is a TrainBatch, or with accumulation_steps K > 1 a sequence
    of K. With `tcfg.ema`, `train_step.ema_params` holds the Polyak average
    of the trainable parameters. `train_step.generator`, seeded from
    `tcfg.seed`, draws the DropPath masks and the tagger's noise; a
    checkpoint saves its state. `mesh`, a DataParallel, makes it the
    data-parallel step of each rank's slice of the global batch."""
    check_trainable(model.cfg)
    if accumulation_steps < 1:
        raise ValueError(f"accumulation_steps is at least 1, not {accumulation_steps}")
    if mesh is not None and not isinstance(mesh, DataParallel):
        raise NotImplementedError(f"mesh {type(mesh).__name__}: the port's step takes the data axis, a "
                                  f"parallel/mesh.py DataParallel; {MODEL_AXIS_TODO}")
    dp = mesh
    cfg = model.cfg
    if cfg.pseudo_verb and cfg.pseudo_verb_mode == "online" and not getattr(model, "LANG_STATES", True):
        raise ValueError(f"variant {cfg.variant}: online pseudo verbs read the forward's lang_states, which "
                         f"{type(model).__name__} does not return; use pseudo_verb_mode offline")
    if tagger and not (getattr(model, "tagger", False) and cfg.subject_class):
        raise ValueError("the tagger step needs a model built with tagger=True and subject_class "
                         "(its losses reconstruct the subject classes)")
    if tagger and (box_noise_scale is None or label_noise_scale is None):
        raise ValueError("the tagger step takes its box_noise_scale and label_noise_scale")
    n_obj = cfg.max_obj_texts
    params = [p for p in model.parameters() if p.requires_grad]
    seed = tcfg.seed if dp is None else tcfg.seed + dp.rank
    generator = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    if dp is not None:
        criterion = dataclasses.replace(criterion, dp=dp)
        dp.broadcast_([*model.parameters(), *model.buffers()])

    def text_features(batch: TrainBatch) -> torch.Tensor:
        if batch.token_ids is None:
            return batch.text_emb
        pooled = model.encode_text(batch.token_ids, batch.token_mask)  # (T, l_dim)
        return pooled[None].expand(batch.pixels.shape[0], *pooled.shape)

    def verb_sim_targets(batch: TrainBatch, out: dict) -> Optional[torch.Tensor]:
        if not cfg.pseudo_verb:
            return None
        if cfg.pseudo_verb_mode == "online":
            feats, metric = out["lang_states"][0, n_obj:].detach(), "euclidean"
            if dp is not None:  # the global batch's first image is rank 0's
                feats = dp.broadcast(feats)
        else:
            feats, metric = batch.text_emb[0, n_obj:], "cosine"
        return pseudo_verb_similarity(feats, batch.targets.verb_labels, batch.text_valid[:, n_obj:], metric=metric)

    def micro_step(batch: TrainBatch) -> dict:
        """Forward, criterion and backward of one batch: the detached loss
        terms, "loss" the weighted total."""
        obj_valid, verb_valid = batch.text_valid[:, :n_obj], batch.text_valid[:, n_obj:]
        if tagger:
            out = model.forward_tagger(batch.pixels, batch.pixel_valid, text_features(batch), batch.text_valid,
                                       batch.targets, n_obj, box_noise_scale, label_noise_scale, generator)
            losses = criterion.tagger_losses(out, batch.targets, obj_valid, verb_valid)
        else:
            out = model(batch.pixels, batch.pixel_valid, text_features(batch), batch.text_valid, n_obj,
                        generator=generator)
            losses = criterion(out, batch.targets, obj_valid, verb_valid,
                               target_verb_sim=verb_sim_targets(batch, out))
        total = criterion.weighted_total(losses)
        total.backward()
        return {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    def reduce(sums: dict) -> dict:
        """Sum the gradients and the metrics' shares over the ranks. A
        parameter that has a gradient on some rank gets one on every rank
        (zeros where it had none), so the buckets agree."""
        has = dp.sum(torch.tensor([p.grad is not None for p in params], dtype=torch.int32)).tolist()
        for p, n in zip(params, has):
            if n and p.grad is None:
                p.grad = torch.zeros_like(p)
        dp.all_reduce_grads([p.grad for p in params if p.grad is not None])
        keys = list(sums)
        total = dp.sum(torch.stack([sums[k].float() for k in keys]))
        return dict(zip(keys, total.unbind()))

    def train_step(batch: Union[TrainBatch, Sequence[TrainBatch]]) -> dict:
        group = [batch] if accumulation_steps == 1 else list(batch)
        if len(group) != accumulation_steps:
            raise ValueError(f"a step takes {accumulation_steps} micro-batches, not {len(group)}")
        optimizer.zero_grad(set_to_none=True)
        sums = micro_step(group[0])
        for micro in group[1:]:
            more = micro_step(micro)
            sums = {k: v + more[k] for k, v in sums.items()}
        if accumulation_steps > 1:
            sums = {k: v / accumulation_steps for k, v in sums.items()}
            torch._foreach_div_([p.grad for p in params if p.grad is not None], float(accumulation_steps))
        if dp is not None:
            sums = reduce(sums)
        finite = torch.isfinite(sums["loss"])
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
            "loss": sums.pop("loss"),
            "nonfinite": (~finite).float(),
            "grad_norm": torch.where(finite, grad_norm, torch.zeros_like(grad_norm)),
            **sums,
        }

    train_step.ema_params = [p.detach().clone() for p in params] if tcfg.ema else None
    train_step.generator = generator
    return train_step
