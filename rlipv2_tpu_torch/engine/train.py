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
step reduces once.

With `mesh`, a `parallel/mesh.py` Mesh (the JAX `("data", "model")` mesh,
:256-285) and `state_sharding`, a placement plan (`fsdp_state_sharding`,
`tp_state_sharding`, `hybrid_state_sharding` below), the step keeps the
state of each split parameter sharded over the `model` axis: each rank
holds its shard of the parameter's AdamW moments and of its EMA, and
the fused AdamW steps a shard copy of the parameter whose gradient is the
shard of the reduced one (`engine/optim.py::ModelAxisShards`); after the
update an all-gather over the model group rebuilds the whole parameter,
which the forward and backward read as before, so the MSDA and window
kernels run unchanged. The batch is split over the data axis alone
(`P("data")`): the ranks of one model group read the same slice and
compute the same gradient, and the generator is seeded from the seed plus
the data index, so that they draw the same DropPath masks and tagger
noise. The gradients and the metrics are summed over the world and
divided by the model axis's size: every rank then holds the data axis's
sum, the same to the bit on every rank (the copies of one model group may
differ in the last bits where a kernel adds in no fixed order: the MSDA
backward's atomics). The clip by the global norm, the skip of a non-finite
update and the schedule act on the whole gradient as before, so a plan
changes no number of the step: it only moves where the optimizer's state
lives. A parameter that a plan keeps whole, or that no optimizer holds
(frozen), steps as in the data-parallel step.

A config with an int8 inference option (`msda_impl "pallas_int8"`, either
`int8_dense`) is refused with a ValueError: those paths are forward only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence, Union

import torch

from rlipv2_tpu_torch.config import ModelConfig, TrainConfig
from rlipv2_tpu_torch.engine.optim import ModelAxisShards, update_ema
from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
from rlipv2_tpu_torch.losses.pseudo_verb import pseudo_verb_similarity
from rlipv2_tpu_torch.parallel.mesh import DataParallel, Mesh, data_axis
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
    state_sharding: Optional[dict] = None,
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
    data-parallel step of each rank's slice of the global batch; a Mesh
    with `state_sharding` ({parameter name: the dimension split over the
    model axis, or None}) the sharded step, whose `train_step.shards`
    holds the split parameters' shards (None without a plan)."""
    check_trainable(model.cfg)
    if accumulation_steps < 1:
        raise ValueError(f"accumulation_steps is at least 1, not {accumulation_steps}")
    if mesh is not None and not isinstance(mesh, DataParallel):
        raise TypeError(f"mesh {type(mesh).__name__}: the step takes a parallel/mesh.py DataParallel (the data "
                        "axis) or Mesh (data and model axes)")
    if state_sharding is not None and not isinstance(mesh, Mesh):
        raise ValueError("state_sharding splits the state over a model axis: give a parallel/mesh.py Mesh")
    dp = data_axis(mesh)
    # the copies of each gradient that a world sum adds: one a model group's rank
    copies = mesh.model.world if isinstance(mesh, Mesh) else 1
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
        mesh.broadcast_([*model.parameters(), *model.buffers()])
    shards = None if state_sharding is None else ModelAxisShards(model, optimizer, state_sharding, mesh.model)

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
        """Sum the gradients and the metrics' shares over the ranks (over
        the world, then over the model group's copies: the data axis's
        sum). A parameter that has a gradient on some rank gets one on
        every rank (zeros where it had none), so the buckets agree."""
        has = mesh.sum(torch.tensor([p.grad is not None for p in params], dtype=torch.int32)).tolist()
        for p, n in zip(params, has):
            if n and p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params if p.grad is not None]
        mesh.all_reduce_grads(grads)
        keys = list(sums)
        total = mesh.sum(torch.stack([sums[k].float() for k in keys]))
        if copies > 1:
            torch._foreach_div_(grads, float(copies))
            total = total / copies
        return dict(zip(keys, total.unbind()))

    def train_step(batch: Union[TrainBatch, Sequence[TrainBatch]]) -> dict:
        group = [batch] if accumulation_steps == 1 else list(batch)
        if len(group) != accumulation_steps:
            raise ValueError(f"a step takes {accumulation_steps} micro-batches, not {len(group)}")
        optimizer.zero_grad(set_to_none=True)
        if shards is not None:
            shards.zero_grad()
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
        if shards is not None:
            shards.before_step()
        optimizer.step()
        if shards is not None:
            shards.after_step()
        if scheduler is not None:
            scheduler.step()
        if tcfg.ema:
            update_ema(train_step.ema_params, params if shards is None else shards.held(params), tcfg.ema_decay)
        return {
            "loss": sums.pop("loss"),
            "nonfinite": (~finite).float(),
            "grad_norm": torch.where(finite, grad_norm, torch.zeros_like(grad_norm)),
            **sums,
        }

    held = params if shards is None else shards.held(params)
    train_step.ema_params = [p.detach().clone() for p in held] if tcfg.ema else None
    train_step.generator = generator
    train_step.shards = shards
    return train_step


# ---------------------------------------------------------------- placement plans
#
# The JAX functions (engine/train.py:287-441) return a NamedSharding for
# every leaf of the train state: replicated over `model`, or split on one
# dimension. The port's return {parameter name: the port tensor's split
# dimension, or None}, for every name `named_parameters(remove_duplicate=
# False)` gives; the AdamW moments and the EMA follow their parameter (the
# JAX rule maps ema_params as params; its AdamW keeps one flat moment
# vector a parameter group, which the rule splits whole: ROADMAP queue 3).
# The rules
# decide in the JAX layout (`jax_leaves`): the flax leaf's shape, with a
# scanned module's leading layer axis, and its dimensions' order (a Dense
# kernel is (in, out) where Linear.weight is (out, in); a Conv kernel
# HWIO where Conv2d's is OIHW).

# Megatron column / row rules by name suffix (JAX :350-363), in the port's
# names. As in JAX, a name is tested against the column rules first, so
# `out_v_proj` and `out_l_proj` (which end with "v_proj" and "l_proj")
# split column-wise with their biases and their row entries never apply;
# and the RoBERTa `attention.output.dense` ends with "output.dense" and
# splits row-wise (ROADMAP queue 3).
_TP_COL = ("linear1.weight", "mlp.fc1.weight", "intermediate.dense.weight", "v_proj.weight", "l_proj.weight",
           "values_v_proj.weight", "values_l_proj.weight")
_TP_COL_BIAS = tuple(k.replace(".weight", ".bias") for k in _TP_COL)
_TP_ROW = ("linear2.weight", "mlp.fc2.weight", "output.dense.weight", "out_v_proj.weight", "out_l_proj.weight")


class JaxLeaf(NamedTuple):
    """A port parameter seen in the JAX layout."""

    shape: tuple  # the flax leaf's shape
    dims: tuple  # the port dimension each of its dimensions became; None: a scan's layer axis
    embedding: bool = False  # a flax nn.Embed table ("embedding": RoBERTa's word, position, token type)


def _scanned(module: torch.nn.Module) -> dict:
    """{child ModuleList: layers} of `module` where the JAX model runs the
    child under nn.scan, its parameters stacked on a leading layer axis:
    the ALIF encoder's fusion blocks (`blocks`: each holds fusion_interval
    deformable layers, a RoBERTa layer and a VLFuse), the plain deformable
    encoder, the DAB decoder with its box heads, the RoBERTa layers and
    the multi-branch fusion's k branches."""
    from rlipv2_tpu_torch.models.dab_decoder import DABHOIDecoder
    from rlipv2_tpu_torch.models.deformable import ALIFEncoder, DeformableEncoder
    from rlipv2_tpu_torch.models.layers import MultiBranchFusion
    from rlipv2_tpu_torch.models.roberta import _Encoder

    if isinstance(module, ALIFEncoder):
        return dict.fromkeys(("layers", "roberta_layers", "VLFuse_layers"), len(module.roberta_layers))
    if isinstance(module, DeformableEncoder):
        return {"layers": len(module.layers)}
    if isinstance(module, DABHOIDecoder):
        return {k: len(module.layers) for k in ("layers", "sub_bbox_embed", "obj_bbox_embed") if hasattr(module, k)}
    if isinstance(module, _Encoder):
        return {"layer": len(module.layer)}
    if isinstance(module, MultiBranchFusion):
        return dict.fromkeys(("fc_1", "fc_2", "fc_3"), len(module.fc_1))
    return {}


def jax_leaves(model: torch.nn.Module) -> dict:
    """{parameter name: JaxLeaf}, every alias included. Linear weights are
    flax (in, out) kernels, Conv2d weights HWIO kernels; a
    MultiheadAttention's in_proj joins the query, key and value kernels
    (d, heads, head_dim), all of one shape, and its out_proj is the (heads,
    head_dim, d) kernel; everything else keeps its layout. The RoBERTa
    embedding tables are nn.Embed leaves; the port's other nn.Embedding
    tables are plain flax params."""
    from rlipv2_tpu_torch.models.roberta import RobertaEmbeddings

    layers, embed = {}, set()
    for module in model.modules():
        for child, n in _scanned(module).items():
            for sub in getattr(module, child).modules():
                layers[id(sub)] = n
        if isinstance(module, RobertaEmbeddings):
            embed.update(id(m.weight) for m in module.children() if isinstance(m, torch.nn.Embedding))
    leaves = {}

    def put(p, shape, dims, n):
        if id(p) not in leaves:
            lead = (n,) if n else ()
            leaves[id(p)] = JaxLeaf(lead + tuple(shape), (None,) * len(lead) + tuple(dims), id(p) in embed)

    for module in model.modules():
        n = layers.get(id(module), 0)
        if isinstance(module, torch.nn.MultiheadAttention):
            h, d = module.num_heads, module.embed_dim
            put(module.in_proj_weight, (d, h, d // h), (1, 0, 0), n)
            put(module.in_proj_bias, (h, d // h), (0, 0), n)
            put(module.out_proj.weight, (h, d // h, d), (1, 1, 0), n)
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, torch.nn.Linear) and name == "weight":
                put(p, p.shape[::-1], (1, 0), n)
            elif isinstance(module, torch.nn.Conv2d) and name == "weight":
                put(p, (*p.shape[2:], p.shape[1], p.shape[0]), (2, 3, 1, 0), n)
            else:
                put(p, p.shape, range(p.dim()), n)
    return {name: leaves[id(p)] for name, p in model.named_parameters(remove_duplicate=False)}


def _plan(model: torch.nn.Module, rule: Callable[[str, JaxLeaf], Optional[int]]) -> dict:
    """rule(first name, leaf) for each parameter, under every alias."""
    leaves = jax_leaves(model)
    decided = {id(p): rule(name, leaves[name]) for name, p in model.named_parameters()}
    return {name: decided[id(p)] for name, p in model.named_parameters(remove_duplicate=False)}


def fsdp_state_sharding(model: torch.nn.Module, n: int, min_size: int = 1 << 17) -> dict:
    """ZeRO-3 placement over a model axis of `n` (JAX :287): a parameter
    of at least `min_size` elements splits on its largest JAX dimension
    that `n` divides (the lowest JAX index on a tie), every other one and
    the embedding tables stay whole. A split that falls on a scan's layer
    axis, which the port's per-layer tensor does not have, keeps the
    tensor whole."""

    def rule(name, leaf):
        if n <= 1 or not leaf.shape or leaf.embedding or math.prod(leaf.shape) < min_size:
            return None
        for d in sorted(range(len(leaf.shape)), key=lambda i: -leaf.shape[i]):
            if leaf.shape[d] % n == 0:
                return leaf.dims[d]
        return None

    return _plan(model, rule)


def tp_state_sharding(model: torch.nn.Module, n: int) -> dict:
    """Megatron placement over a model axis of `n` (JAX :366): the FFN
    up-projections and the BiMHA projections split their output features,
    the paired down-projections their input features; every other
    parameter stays whole. As the JAX function, it reads no size."""

    def rule(name, leaf):
        shape, dims = leaf.shape, leaf.dims
        if n <= 1 or not shape:
            return None
        if name.endswith(_TP_COL + _TP_COL_BIAS) and shape[-1] % n == 0:
            return dims[-1]
        if name.endswith(_TP_ROW) and len(shape) >= 2 and shape[-2] % n == 0:
            return dims[-2]
        return None

    return _plan(model, rule)


def hybrid_state_sharding(model: torch.nn.Module, n: int, min_size: int = 1 << 17) -> dict:
    """TP where a Megatron rule applies, FSDP for everything else (JAX
    :419): one step runs both rule sets."""
    tp, fsdp = tp_state_sharding(model, n), fsdp_state_sharding(model, n, min_size)
    return {k: fsdp[k] if v is None else v for k, v in tp.items()}
