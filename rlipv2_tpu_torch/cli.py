"""Command-line entry point of the port, `rlipv2-torch` (counterpart of
rlipv2_tpu/cli.py; reference main.py:494-807).

    rlipv2-torch --preset rlip_parseda_v2_r50 --dataset_file hico \\
        --hoi_path HICO_DIR --pretrained RLIPv2.pth --tokenizer_dir ROBERTA_DIR \\
        --giou_verb_label --pseudo_verb --negative_text_sampling 500 \\
        --use_nms_filter --output_dir out

    rlipv2-torch --preset rlip_parseda_v2_r50 --dataset_file vcoco|oi_sgg \\
        --hoi_path VCOCO_OR_OISGG_DIR --pretrained RLIPv2.pth --tokenizer_dir ROBERTA_DIR \\
        --negative_text_sampling 500 --output_dir out

    rlipv2-torch --preset rlip_parseda_v2_r50 --dataset_file pretrain \\
        --pretrain_anno VG.json,COCO_REL.json --vg_folder VG --coco2017_folder COCO \\
        --iterative_paradigm 0,1 --relation_threshold 0.2 --pair_overlap \\
        --negative_text_sampling 500 --sampling_strategy freq \\
        --giou_verb_label --pseudo_verb --triplet_filtering \\
        --pretrained START.pth --tokenizer_dir ROBERTA_DIR --output_dir out

The parser has every flag of the JAX CLI with its default, and `--device`
(default "cuda"; the tests give "cpu"). There is no fallback from the card
to the CPU: with device "cuda" and no card, or a JPEG on the CPU, the run
raises. `main` runs, for the presets with the ResNet-50 or a Swin backbone
(`rlip_parseda_v2_swin_l` / `_swin_large`, `_swin_t`):
  * the HICO-DET, V-COCO and Open Images v6 SGG fine-tunes, resumes and
    evaluations (`--dataset_file hico|vcoco|oi_sgg`): each epoch trains,
    saves a checkpoint, evaluates (`evaluate_hoi`, `evaluate_vcoco`,
    `evaluate_sgg`) and appends a JSON line to `output_dir/log.txt`;
    `--eval` evaluates only. The JAX CLI only evaluates V-COCO and OI-SGG
    (its scripts never train); the port trains them, as the reference
    does (ROADMAP queue 3);
  * relational pre-training (`--dataset_file pretrain`, JAX `run_pretrain`):
    one VG-format dataset per `--pretrain_anno` file (VG, pseudo-labelled
    COCO and O365), batches interleaved per `--iterative_paradigm`; with
    K > 1 entries one optimizer step accumulates K micro-batches, one of
    each entry, and the ragged groups at an epoch's end are dropped; each
    epoch ends with a checkpoint and a log line, with no evaluation;
  * `--dataset_file vg`: the same over one VG file with plain shuffled
    batches (JAX `run_vg`); with `--verb_tagger` the R-Tagger's training
    (scripts/tagger_train_vg.sh): the subject head on, `VGRelTaggerDataset`
    (its pair sampler seeded from --seed, the JAX CLI's from 0) with the
    targets padded to num_queries // 2 pair slots, the model built with
    its tagger parameters, and the train step's `forward_tagger` and
    `tagger_losses` with --box_noise_scale and --label_noise_scale.
The model is the preset's variant (or --variant's), built by
`models/factory.py`: RLIP-ParSeDA (`rlip_parseda_v2`), RLIP-ParSeD
(`rlip_parsed_v2`, the `parsed` and tagger scripts), and with --variant
RLIP-ParSeD v1 (`rlip_parsed`, the plain deformable encoder), RLIP-ParSe
(`rlip_parse`, dense attention with decode-time fusion) or RLIP-ParSe v2
(`rlip_parse_v2`, the dense ALIF encoder). As in the JAX CLI, `parse` and
`rlip_parse_v1_joint` are the factory's only (the latter has no text
encoder), and `check_ported` refuses the other factory-only variants
(`parse_dab_detr`, `rlip_mdetr`, the closed-vocabulary zoo), which the JAX
CLI's --variant does not offer. Neither ParSe variant has an R-Tagger, and RLIP-ParSe returns no
language states for online pseudo verbs: both raise ValueError.
A run warm-starts from `--pretrained` (the JAX CLI parses it and never
reads it) or continues with `--resume` (a checkpoint file or directory)
from the saved epoch, step and learning rate. With `--tokenizer_dir` the
RoBERTa text encoder trains in the graph, unless `--freeze_text_encoder`;
evaluation encodes the label texts with the current text encoder (the JAX
CLI scores with the initial one's cached features).

Text slots: `--negative_text_sampling n` fills int(2n/3) object texts and
the rest verb texts (reference engine.py:733-744), as far as the label
vocabulary reaches, so `text_slots` sizes the model's slots to max(preset,
min(int(2n/3), objects) + 1) object slots (the no-object text takes the
last) and max(preset, min(n - int(2n/3), verbs)) verb slots. Pre-training
counts no vocabulary bound (334 + 167 at n = 500), Open Images its 288
objects and 30 relations (289 + 160); HICO-DET and V-COCO keep the
preset's 96 + 160. No learned parameter depends on the slot counts. The
JAX CLI keeps the preset's slots and overflows them at n = 500 on VG and
OI (ROADMAP queue 3). The run prints its slots and puts them in each log
line.

The R-Tagger's pseudo-relation generation (scripts/tagger_generate_coco.sh)
is `python -m rlipv2_tpu_torch.tools.generate_relations`.

`--remat_encoder` sets `transformer.remat_encoder`; `--frozen_vision`,
`--unfrozen_params` and `--frozen_detection` set the train config's
`freeze_regime`, the first of them in that order (JAX :194-211). The
model flags apply to `main`'s `model_cfg` as to a preset. The Swin
backbone's `backbone.use_checkpoint` has no flag, as in the JAX CLI: a
caller sets it in `model_cfg`.

The loss and head options of RLIP-ParSeDA pass through: `--verb_loss_type`
and `--obj_loss_type` (every type of the JAX CLI) and `--exponential_loss`
/ `--exponential_hyper` go to the criterion; `--verb_curing` and
`--masked_entity_modeling` (which turns the subject head on, as in the
JAX CLI) to the model, whose evaluation then cures the verb scores (the
JAX CLI trains the curing heads and evaluates without them: ROADMAP queue
3). A `--pretrained` file without those heads loads, and they keep their
seeded values. Both options raise ValueError on the variants whose JAX
classes never call such heads (RLIP-ParSeD and the ParSe models).
`--eval --eval_uniformity` (HICO-DET) also matches the predictions to the
GT pairs, writes the per-verb features of the last verb decoder layer to
`--output_dir`/verb_class_features.npz and prints the evaluator's stats
and the uniformity and alignment summary (JAX :410-422).

Several cards: under torchrun (one process per card, `engine/launch.py`)

    python -m torch.distributed.run --nproc_per_node 8 -m rlipv2_tpu_torch.cli \
        --batch_size 64 ...   # the global batch: 8 images a card

`main` joins the process group (`--dist_backend`, default nccl on cuda and
gloo on cpu; gloo also serves ranks that share a card) and runs every
training path data-parallel (`parallel/mesh.py`, the JAX CLI's `data`
mesh, :251-263): `--batch_size` is the global batch, which must divide by
the world size, each rank reads and steps its slice, and the reduced
gradient is the global batch's. The HICO-DET evaluation is sharded over
the ranks (`evaluate_hoi(rank=, world=)`, each rank's batch
`--batch_size / world`); V-COCO, OI-SGG and `--eval_uniformity`, which the
JAX package has in no sharded form, run on rank 0 while the others wait.
Rank 0 alone prints, writes the checkpoints and `log.txt`; each rank
draws its own dropout masks (the global generators reseeded with --seed
plus the rank once the model is built, as the reference seeds its ranks).
Without torchrun's environment the run is one process, as before.

Paths not ported raise NotImplementedError naming their ROADMAP item
(`check_ported`): the model axis of sharded training (`--fsdp > 1`) and
the other model variants.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import random
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("rlipv2_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="rlip_parseda_v2_r50", help="model preset (rlipv2_tpu_torch.config.PRESETS)")
    p.add_argument("--dataset_file", default="hico", choices=["hico", "vcoco", "oi_sgg", "vg", "pretrain"])
    p.add_argument("--hoi_path", type=str, help="dataset root")
    p.add_argument("--pretrain_anno", type=str, help="VG-format annotation JSON(s), comma-separated")
    p.add_argument("--vg_folder", type=str)
    p.add_argument("--coco2017_folder", type=str)
    p.add_argument("--o365_folder", type=str)
    p.add_argument("--iterative_paradigm", default="0", help="dataset index per micro-batch, e.g. 0,1,2")
    p.add_argument("--relation_threshold", type=float, default=0.0)
    p.add_argument("--pair_overlap", action="store_true")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_backbone", type=float, default=1e-5)
    p.add_argument("--lr_text_encoder", type=float, default=1e-5)
    p.add_argument("--freeze_text_encoder", action="store_true",
                   help="do not train RoBERTa; slot texts use cached features")
    p.add_argument("--text_token_len", type=int, default=24, help="token length of in-graph label encoding")
    p.add_argument("--frozen_vision", action="store_true", help="freeze backbone stages 1-2")
    p.add_argument("--unfrozen_params", action="store_true", help="train only the text encoder")
    p.add_argument("--frozen_detection", action="store_true",
                   help="freeze backbone, encoder, ho decoder and input projections")
    p.add_argument("--lr_drop", type=int, default=15)
    p.add_argument("--schedule", default="step")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--eval", action="store_true", help="eval only")
    p.add_argument("--resume", default="", help="checkpoint file, or a directory of them (the newest)")
    p.add_argument("--pretrained", default="", help="reference-layout .pth to warm-start from")
    p.add_argument("--zero_shot_setting", default=None, choices=[None, "UC-RF", "UC-NF", "UO"])
    p.add_argument("--few_shot_transfer", type=int, default=100, choices=[1, 10, 100])
    p.add_argument("--use_nms_filter", action="store_true")
    p.add_argument("--eval_uniformity", action="store_true",
                   help="with --eval: also the verb-feature uniformity analysis")
    p.add_argument("--negative_text_sampling", type=int, default=0)
    p.add_argument("--sampling_strategy", default="freq")
    p.add_argument("--tokenizer_dir", default="", help="dir with vocab.json + merges.txt")
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--print_freq", type=int, default=50)
    p.add_argument("--max_steps", type=int, default=None, help="cap steps per epoch")
    p.add_argument("--giou_verb_label", action="store_true", help="RPL soft labels")
    p.add_argument("--triplet_filtering", action="store_true")
    p.add_argument("--verb_tagger", action="store_true", help="train the relation tagger")
    p.add_argument("--label_noise_scale", type=float, default=0.3)
    p.add_argument("--box_noise_scale", type=float, default=0.6)
    p.add_argument("--variant", default=None,
                   choices=[None, "rlip_parseda_v2", "rlip_parsed_v2", "rlip_parsed", "rlip_parse", "rlip_parse_v2"],
                   help="override the preset's model variant")
    p.add_argument("--verb_loss_type", default=None,
                   help="focal | bce | weighted_bce | asymmetric_bce | CB_focal_bce | cross_modal_matching")
    p.add_argument("--obj_loss_type", default=None, help="cross_entropy | focal | cross_modal_matching")
    p.add_argument("--exponential_loss", action="store_true", help="exponential per-layer aux decay")
    p.add_argument("--exponential_hyper", type=float, default=0.8)
    p.add_argument("--pseudo_verb", action="store_true")
    p.add_argument("--pseudo_verb_mode", default="online", choices=["online", "offline"])
    p.add_argument("--verb_curing", action="store_true")
    p.add_argument("--masked_entity_modeling", action="store_true")
    p.add_argument("--remat_encoder", action="store_true", help="rematerialize encoder layers")
    p.add_argument("--fsdp", type=int, default=1, help="model-axis size for FSDP (1 = data parallel)")
    p.add_argument("--msda_impl", default=None, choices=[None, "auto", "pallas", "pallas_v5", "pallas_int8", "xla"],
                   help="MSDA implementation; pallas_int8 is the int8 inference path")
    p.add_argument("--int8_dense", action="store_true", help="W8A8 projections, inference only")
    p.add_argument("--device", default="cuda", help="torch device of the run: cuda (default) or cpu")
    p.add_argument("--dist_backend", default=None, choices=[None, "nccl", "gloo"],
                   help="process-group backend under torchrun: nccl (default on cuda) or gloo (default on cpu; "
                        "ranks that share a card)")
    return p


PRETRAINING = ("vg", "pretrain")


def check_ported(args) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for a path the
    port does not run yet; ValueError for options that cannot be combined."""
    from rlipv2_tpu_torch.config import PRESETS
    from rlipv2_tpu_torch.models.factory import CLOSED_VOCAB_VARIANTS, FACTORY_ONLY_VARIANTS, PORTED_VARIANTS, \
        TAGGER_VARIANTS, check_heads

    todo = []
    if args.fsdp > 1:
        todo.append("--fsdp > 1 (the model axis of sharded training, FSDP: ROADMAP queue 1 item 18.2)")
    if args.preset not in PRESETS:
        raise ValueError(f"unknown preset {args.preset!r}; known: {sorted(PRESETS)}")
    variant = args.variant or PRESETS[args.preset]().variant
    if variant not in PORTED_VARIANTS:
        todo.append(f"variant {variant} (ROADMAP queue 1 item 20)")
    elif variant in CLOSED_VOCAB_VARIANTS:  # as in the JAX CLI, whose --variant offers none of them
        todo.append(f"variant {variant}: the closed-vocabulary zoo takes no text, so the text-fed training and "
                    "evaluation of this command do not apply; build it with models/factory.py (ROADMAP queue 1 "
                    "item 20)")
    elif variant in FACTORY_ONLY_VARIANTS:
        todo.append(f"variant {variant}: the JAX CLI's --variant offers neither parse_dab_detr nor rlip_mdetr "
                    "(rlipv2_tpu/cli.py:95-101), so this command runs neither; build it with models/factory.py")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))
    check_heads(model_config(args))
    if args.eval_uniformity and not (args.eval and args.dataset_file == "hico"):
        raise ValueError("--eval_uniformity is an evaluation of --dataset_file hico: give it with --eval "
                         "(the JAX CLI ignores it elsewhere)")
    if not args.eval and (args.int8_dense or args.msda_impl == "pallas_int8"):
        raise ValueError("--int8_dense and --msda_impl pallas_int8 are inference only: use them with --eval")
    if args.eval and args.dataset_file in PRETRAINING:
        raise ValueError(f"--dataset_file {args.dataset_file} trains: it has no evaluation (give --eval a HICO run)")
    if args.verb_tagger and args.dataset_file != "vg":
        raise ValueError("--verb_tagger trains on --dataset_file vg (its generation is tools/generate_relations.py)")
    if args.verb_tagger and variant not in TAGGER_VARIANTS:
        raise ValueError(f"--verb_tagger: variant {variant} has no R-Tagger (forward_tagger); "
                         f"the tagger's variants: {', '.join(TAGGER_VARIANTS)}")


def text_slots(cfg, negative_text_sampling: int, n_obj_names: Optional[int] = None,
               n_verb_names: Optional[int] = None):
    """`cfg` with text slots that hold the negative-text budget n, as far as
    a vocabulary of `n_obj_names` objects and `n_verb_names` verbs (None:
    unbounded) supplies it: at least min(int(2n/3), n_obj_names) + 1 object
    slots and min(n - int(2n/3), n_verb_names) verb slots, never fewer than
    `cfg`'s."""
    n_obj = int(negative_text_sampling * 2 / 3.0)
    n_verb = negative_text_sampling - n_obj
    if n_obj_names is not None:
        n_obj = min(n_obj, n_obj_names)
    if n_verb_names is not None:
        n_verb = min(n_verb, n_verb_names)
    return dataclasses.replace(cfg, max_obj_texts=max(cfg.max_obj_texts, n_obj + 1),
                               max_verb_texts=max(cfg.max_verb_texts, n_verb))


def batch_label_slots(cfg, item_sizes, batch_size: int):
    """`cfg` with text slots that hold any batch's own label texts (the
    R-Tagger, whose script samples no negative texts): as many object slots
    as the `batch_size` largest item label spaces hold names, plus the
    no-object text, and as many verb slots as their predicates; never fewer
    than `cfg`'s. The JAX CLI keeps the preset's slots, which a batch of
    VG images overflows (ROADMAP queue 3)."""
    objs = sorted((o for o, _ in item_sizes), reverse=True)[:batch_size]
    verbs = sorted((v for _, v in item_sizes), reverse=True)[:batch_size]
    return dataclasses.replace(cfg, max_obj_texts=max(cfg.max_obj_texts, sum(objs) + 1),
                               max_verb_texts=max(cfg.max_verb_texts, sum(verbs)))


def accumulation_steps(args) -> int:
    """Micro-batches an optimizer step accumulates: one per
    --iterative_paradigm entry for --dataset_file pretrain (JAX :264-270)."""
    paradigm = [int(d) for d in args.iterative_paradigm.split(",")]
    return len(paradigm) if args.dataset_file == "pretrain" and len(paradigm) > 1 else 1


def model_config(args, base=None):
    """`base` (default: the preset) with the flags' model overrides."""
    from rlipv2_tpu_torch.config import PRESETS

    cfg = base if base is not None else PRESETS[args.preset]()
    if args.variant:
        cfg = dataclasses.replace(cfg, variant=args.variant)
    if args.verb_tagger:  # tagger_losses reconstruct the subject classes too
        cfg = dataclasses.replace(cfg, subject_class=True)
    if args.pseudo_verb:
        cfg = dataclasses.replace(cfg, pseudo_verb=True, pseudo_verb_mode=args.pseudo_verb_mode)
    if args.verb_curing:
        cfg = dataclasses.replace(cfg, verb_curing=True)
    if args.masked_entity_modeling:  # its recon losses reconstruct the subject classes too (JAX :158-160)
        cfg = dataclasses.replace(cfg, masked_entity_modeling=True, subject_class=True)
    t = cfg.transformer
    if args.msda_impl:
        t = dataclasses.replace(t, msda_impl=args.msda_impl)
    if args.remat_encoder:
        t = dataclasses.replace(t, remat_encoder=True)
    if args.int8_dense:
        t = dataclasses.replace(t, int8_dense=True)
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, int8_dense=True))
    return dataclasses.replace(cfg, transformer=t)


def loss_config(args):
    """The criterion's LossConfig from the flags (JAX :212-223): RPL, the
    triplet filter, the exponential aux decay and the loss types given."""
    from rlipv2_tpu_torch.config import LossConfig

    types = {k: getattr(args, k) for k in ("verb_loss_type", "obj_loss_type") if getattr(args, k)}
    return LossConfig(giou_verb_label=args.giou_verb_label, triplet_filtering=args.triplet_filtering,
                      exponential_loss=args.exponential_loss, exponential_hyper=args.exponential_hyper, **types)


def freeze_regime(args) -> Optional[str]:
    """The train config's freeze_regime: the first freeze flag given, in
    the JAX CLI's order."""
    return next((f for f in ("frozen_vision", "unfrozen_params", "frozen_detection") if getattr(args, f)), None)


def build_everything(args, model_cfg=None, transforms: Optional[dict] = None, mesh=None) -> dict:
    """The run's parts: model (on `args.device`), criterion, datasets,
    optimizer, scheduler and train step, the cached label-text encoder and,
    for in-graph text training, the slot tokenizer. `model_cfg` replaces
    the preset (the tests pass a tiny config; the flags' model overrides
    apply to it, and pre-training sizes its text slots all the same);
    `transforms` ({"train": ..., "val": ...} HOITransforms) replaces the
    HICO augmentations (the tests pass small sizes). `mesh`, a
    DataParallel, makes the train step data-parallel."""
    from rlipv2_tpu_torch.config import TrainConfig
    from rlipv2_tpu_torch.data.transforms import HOITransform
    from rlipv2_tpu_torch.engine.loops import CachedTextEncoder
    from rlipv2_tpu_torch.engine.optim import build_optimizer
    from rlipv2_tpu_torch.engine.train import make_train_step
    from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
    from rlipv2_tpu_torch.models.factory import build_model

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, and torch sees no CUDA device (give --device cpu to run on the CPU)")
    cfg = model_config(args, model_cfg)
    tcfg = TrainConfig(
        lr=args.lr, lr_backbone=args.lr_backbone, lr_text_encoder=args.lr_text_encoder,
        epochs=args.epochs, lr_drop=args.lr_drop, schedule=args.schedule,
        batch_size=args.batch_size, ema=args.ema, seed=args.seed, freeze_regime=freeze_regime(args),
    )
    criterion = SetCriterionHOI(loss_config(args), subject_class=cfg.subject_class, pseudo_verb=cfg.pseudo_verb,
                                tagger=args.verb_tagger)

    transforms = transforms or {}
    train_tf = transforms.get("train") or HOITransform(train=True, rng=random.Random(args.seed))
    val_ds = train_ds = None
    sizes, k_steps = [], accumulation_steps(args)
    if args.dataset_file in PRETRAINING:
        train_ds, sizes = build_vg_data(args, cfg.num_queries, train_tf, device)
        cfg = text_slots(cfg, args.negative_text_sampling)
        if args.verb_tagger:
            cfg = batch_label_slots(cfg, train_ds.label_space_sizes(), args.batch_size)
    else:
        val_ds = build_finetune_data(args, "val", cfg.num_queries, transforms.get("val"), device)
        if not args.eval:
            train_ds = build_finetune_data(args, "train", cfg.num_queries, train_tf, device)
        cfg = text_slots(cfg, args.negative_text_sampling, len(val_ds.object_text), len(val_ds.verb_text))

    torch.manual_seed(args.seed)
    model = build_model(cfg, tagger=args.verb_tagger).to(device)
    if mesh is not None:  # one model on every rank, then each rank's own dropout masks
        torch.manual_seed(args.seed + mesh.rank)

    tokenizer = None
    if args.tokenizer_dir:
        from rlipv2_tpu_torch.utils.tokenizer import RobertaTokenizer

        tok_dir = Path(args.tokenizer_dir)
        tokenizer = RobertaTokenizer.from_files(tok_dir / "vocab.json", tok_dir / "merges.txt")
    text_tokens = tokenizer is not None and not args.freeze_text_encoder

    @torch.no_grad()
    def encode_fn(texts):
        """Pooled features of `texts` from the model's text encoder as it
        is now, in the model's current mode."""
        if tokenizer is None:
            raise RuntimeError("label-text encoding needs --tokenizer_dir with vocab.json + merges.txt")
        ids, mask = tokenizer.batch_encode(texts)
        ids, mask = (torch.from_numpy(a.astype(np.int64)).to(device) for a in (ids, mask))
        return model.encode_text(ids, mask).cpu().numpy()

    def tokenize_fn(texts):
        """Slot texts -> (ids, mask) of exactly `--text_token_len` tokens."""
        L = args.text_token_len
        ids, mask = tokenizer.batch_encode(texts, max_len=L)
        pad = L - ids.shape[1]
        return (np.pad(ids, ((0, 0), (0, pad)), constant_values=tokenizer.pad), np.pad(mask, ((0, 0), (0, pad))))

    optimizer = scheduler = train_step = None
    steps_per_epoch = 0
    if train_ds is not None:
        if args.dataset_file == "pretrain":
            steps_per_epoch = len(pretrain_batches(args, sizes, k_steps, epoch=0))
        else:
            steps_per_epoch = len(train_ds) // args.batch_size
        if args.max_steps is not None:
            steps_per_epoch = min(steps_per_epoch, args.max_steps)
        optimizer, scheduler = build_optimizer(model, tcfg, max(steps_per_epoch, 1),
                                               freeze_text_encoder=args.freeze_text_encoder)
        train_step = make_train_step(model, criterion, optimizer, scheduler, tcfg, accumulation_steps=k_steps,
                                     mesh=mesh, tagger=args.verb_tagger, box_noise_scale=args.box_noise_scale,
                                     label_noise_scale=args.label_noise_scale)
    return {
        "mesh": mesh,
        "cfg": cfg, "tcfg": tcfg, "model": model, "criterion": criterion, "device": device,
        "data_rng": None if train_ds is None else train_tf.rng,
        "sampler_rng": getattr(train_ds, "pair_rng", None),
        "optimizer": optimizer, "scheduler": scheduler, "train_step": train_step,
        "steps_per_epoch": steps_per_epoch, "train_ds": train_ds, "val_ds": val_ds,
        "dataset_sizes": sizes, "accumulation_steps": k_steps,
        "text_encoder": CachedTextEncoder(encode_fn),
        "tokenize_fn": tokenize_fn if text_tokens else None,
    }


def build_finetune_data(args, image_set: str, num_queries: int, transforms, device):
    """The train or val split of --dataset_file hico (with its zero-shot
    and few-shot settings), vcoco or oi_sgg under --hoi_path."""
    from rlipv2_tpu_torch.data.hico import build_hico
    from rlipv2_tpu_torch.data.oi_sgg import build_oi_sgg
    from rlipv2_tpu_torch.data.vcoco import build_vcoco

    kw = dict(device=device, transforms=transforms)
    if args.dataset_file == "vcoco":
        return build_vcoco(image_set, args.hoi_path, num_queries, **kw)
    if args.dataset_file == "oi_sgg":
        return build_oi_sgg(image_set, args.hoi_path, num_queries, **kw)
    return build_hico(image_set, args.hoi_path, num_queries, zero_shot_setting=args.zero_shot_setting,
                      few_shot_transfer=args.few_shot_transfer, **kw)


def build_vg_data(args, num_queries: int, transforms, device):
    """The training data of --dataset_file pretrain (one VGRelDataset per
    --pretrain_anno file, several end to end in a ConcatRelDataset) or vg
    (the one --pretrain_anno file over --vg_folder; a VGRelTaggerDataset
    with --verb_tagger), with the relation threshold and pair-overlap
    filters; and each file's dataset size."""
    from rlipv2_tpu_torch.data.vg import ConcatRelDataset, VGRelDataset, VGRelTaggerDataset

    if not args.pretrain_anno:
        raise ValueError(f"--dataset_file {args.dataset_file} reads its annotations from --pretrain_anno")
    if args.dataset_file == "vg":
        files, folders = [args.pretrain_anno], {"vg": args.vg_folder}
    else:
        files = [a for a in args.pretrain_anno.split(",") if a]
        folders = {"vg": args.vg_folder, "coco2017": args.coco2017_folder, "o365": args.o365_folder}
    kw = dict(num_queries=num_queries, transforms=transforms, relation_threshold=args.relation_threshold,
              pair_overlap=args.pair_overlap, device=device)
    if args.verb_tagger:
        ds = VGRelTaggerDataset(files[0], folders, seed=args.seed, **kw)
        return ds, [len(ds)]
    datasets = [VGRelDataset(f, folders, **kw) for f in files]
    return (datasets[0] if len(datasets) == 1 else ConcatRelDataset(datasets)), [len(d) for d in datasets]


def pretrain_batches(args, sizes, k_steps: int, epoch: int) -> list:
    """An epoch of --dataset_file pretrain: whole batches interleaved per
    --iterative_paradigm from the seed and the epoch alone (so a resumed
    run visits what a straight one does), full batches only; with
    k_steps > 1 grouped k_steps at a time, the groups that hold a short
    batch dropped (JAX run_pretrain)."""
    from rlipv2_tpu_torch.data.vg import batch_iterative_indices

    paradigm = [int(d) for d in args.iterative_paradigm.split(",")]
    if min(paradigm) < 0 or max(paradigm) >= len(sizes):
        raise ValueError(f"--iterative_paradigm {args.iterative_paradigm} names a file beyond the "
                         f"{len(sizes)} of --pretrain_anno")
    bs = args.batch_size
    batches = batch_iterative_indices(sizes, bs, paradigm, shuffle=True, seed=args.seed, epoch=epoch)
    if k_steps == 1:
        return [b for b in batches if len(b) == bs]
    groups = (batches[i : i + k_steps] for i in range(0, len(batches) - k_steps + 1, k_steps))
    return [g for g in groups if all(len(b) == bs for b in g)]


@dataclasses.dataclass
class RunResult:
    """What `main` returns: the run's state (model, optimizer, scheduler,
    EMA and last epoch), the last evaluation's stats, the checkpoint files
    written, after --resume where the run resumed (epoch, step and each
    parameter group's learning rate, as restored), and with
    --eval_uniformity the uniformity analysis."""

    state: object
    stats: Optional[dict]
    checkpoints: list
    resumed: Optional[dict] = None
    analysis: Optional[dict] = None  # --eval_uniformity's


# the stat each dataset's epoch line prints
HEADLINE_STAT = {"hico": "mAP", "vcoco": "mAP_all", "oi_sgg": "score_wtd (wmAP)"}


def _evaluate(args, ctx, model) -> Optional[dict]:
    """The dataset's evaluation of `model` on the val split: `evaluate_hoi`
    (with --use_nms_filter's triplet NMS), `evaluate_vcoco` (which has no
    NMS, as in the JAX package) or `evaluate_sgg` (with it). Data-parallel,
    `evaluate_hoi` is sharded over the ranks, `--batch_size / world` images
    a rank's batch, and every rank gets the stats; V-COCO and OI-SGG run on
    rank 0 (the others wait and get None)."""
    from rlipv2_tpu_torch.engine import loops
    from rlipv2_tpu_torch.parallel.dist_eval import default_gather

    model.eval()
    ctx["text_encoder"].clear()  # the text encoder may have trained since its features were cached
    run = (lambda m, *a: m(*a), model, ctx["val_ds"], ctx["cfg"], ctx["text_encoder"])
    mesh = ctx["mesh"]
    kw = dict(batch_size=args.batch_size, bucket=None)
    if args.dataset_file == "hico":
        if mesh is not None:
            kw.update(batch_size=args.batch_size // mesh.world, rank=mesh.rank, world=mesh.world,
                      gather_fn=functools.partial(default_gather, mesh=mesh))
        return loops.evaluate_hoi(*run, use_nms_filter=args.use_nms_filter, **kw)
    return _on_rank0(mesh, lambda: loops.evaluate_vcoco(*run, **kw) if args.dataset_file == "vcoco"
                     else loops.evaluate_sgg(*run, use_nms_filter=args.use_nms_filter, **kw))


def _on_rank0(mesh, fn):
    """fn() on rank 0 while the other ranks wait (they get None); fn() in
    one process. The JAX package has no sharded form of these
    evaluations."""
    if mesh is None:
        return fn()
    out = fn() if mesh.rank == 0 else None
    mesh.barrier()
    return out


UNIFORMITY_FILE = "verb_class_features.npz"


def _evaluate_uniformity(args, ctx, model, out_dir: Path) -> tuple:
    """--eval --eval_uniformity: `evaluate_hoi_matching_uniformity` of the
    val split, its per-verb features written to `out_dir` /
    UNIFORMITY_FILE (JAX :410-422). Returns (stats, analysis)."""
    from rlipv2_tpu_torch.engine import loops

    model.eval()
    ctx["text_encoder"].clear()
    out_dir.mkdir(parents=True, exist_ok=True)
    out = _on_rank0(ctx["mesh"], lambda: loops.evaluate_hoi_matching_uniformity(
        lambda m, *a: m(*a), model, ctx["val_ds"], ctx["cfg"], ctx["text_encoder"], batch_size=args.batch_size,
        bucket=None, use_nms_filter=args.use_nms_filter, save_path=str(out_dir / UNIFORMITY_FILE)))
    return (None, None) if out is None else out[:2]


def _cache_slot_texts(ctx, obj_texts, verb_texts) -> None:
    """Encode every text a slot can hold on this thread, in eval mode,
    before the loader's threads ask for them."""
    from rlipv2_tpu_torch.data.text import NO_OBJ_TEXT

    model = ctx["model"]
    was_training = model.training
    model.eval()
    ctx["text_encoder"].clear()
    ctx["text_encoder"](list(obj_texts) + [NO_OBJ_TEXT] + list(verb_texts) + ["."])
    model.train(was_training)


def _epoch_data(args, ctx, epoch: int) -> dict:
    """`train_one_epoch`'s data arguments for one epoch: the batches (an
    order from the seed and the epoch alone, so a resumed run visits the
    images as a straight one does), the label vocabularies and, for VG
    data, their frequencies."""
    ds = ctx["train_ds"]
    if args.dataset_file not in PRETRAINING:
        indices = list(range(len(ds)))
        random.Random(f"{args.seed}/{epoch}").shuffle(indices)
        return dict(indices=indices, obj_vocab=ds.object_text, verb_vocab=ds.verb_text)
    data = dict(obj_vocab=ds.object_names, verb_vocab=ds.relationship_names,
                obj_freqs=list(ds.object_freq.values()), verb_freqs=list(ds.relationship_freq.values()))
    if args.dataset_file == "vg":
        indices = list(range(len(ds)))
        random.Random(f"{args.seed}/{epoch}").shuffle(indices)
        if args.verb_tagger:  # the pair slots are the tagger's queries (JAX run_vg)
            data["max_triplets"] = ctx["cfg"].num_queries // 2
        return dict(indices=indices, **data)
    k_steps = ctx["accumulation_steps"]
    batches = pretrain_batches(args, ctx["dataset_sizes"], k_steps, epoch)
    return dict(indices=[], batch_lists=batches, accumulation_steps=k_steps, **data)


def main(argv=None, model_cfg=None, transforms: Optional[dict] = None) -> RunResult:
    """Parse `argv` (default sys.argv) and run: train with a checkpoint, an
    evaluation and a log line each epoch, or with --eval evaluate only."""
    args = get_parser().parse_args(argv)
    check_ported(args)
    if not (args.pretrained or args.resume):
        raise NotImplementedError(
            "a run starts from --pretrained or --resume: the reference's initialisation is not "
            "ported (ROADMAP queue 1 item 21)"
        )
    mesh, joined = distributed(args)
    try:
        ctx = build_everything(args, model_cfg, transforms, mesh=mesh)
        try:
            result = _run(args, ctx)
        finally:  # the image readers hold nvJPEG handles and states on the card
            for ds in (ctx["train_ds"], ctx["val_ds"]):
                if ds is not None:
                    ds.close()
        if mesh is not None:  # no rank leaves while another still talks to it
            mesh.barrier()
        return result
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def distributed(args) -> tuple:
    """Under torchrun's environment (or a process group the caller joined):
    the data axis, a DataParallel, and whether this call joined the group;
    (None, False) in a plain run. Raises ValueError where --batch_size does
    not divide by the world size."""
    import torch.distributed as dist

    from rlipv2_tpu_torch.engine.launch import init_distributed
    from rlipv2_tpu_torch.parallel.mesh import create_mesh

    had = dist.is_available() and dist.is_initialized()
    init_distributed(device=args.device, backend=args.dist_backend)
    if not (dist.is_available() and dist.is_initialized()):
        return None, False
    world = dist.get_world_size()
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} is the global batch: it must divide by the world size "
                         f"{world}")
    return create_mesh(), not had


def _run(args, ctx) -> RunResult:
    from rlipv2_tpu_torch.engine.checkpoint import CheckpointManager, TrainState, load_checkpoint
    from rlipv2_tpu_torch.engine.convert import load_reference_checkpoint
    from rlipv2_tpu_torch.engine.loops import train_one_epoch
    from rlipv2_tpu_torch.utils.logging import append_log_line

    model, cfg, step, mesh = ctx["model"], ctx["cfg"], ctx["train_step"], ctx["mesh"]
    lead = mesh is None or mesh.rank == 0
    say = functools.partial(print, flush=True) if lead else (lambda *_: None)
    state = TrainState(model, ctx["optimizer"], ctx["scheduler"], None if step is None else step.ema_params,
                       generator=None if step is None else step.generator, data_rng=ctx["data_rng"],
                       sampler_rng=ctx["sampler_rng"], mesh=mesh)
    if args.pretrained:
        initialised = load_reference_checkpoint(model, args.pretrained)["initialised"]
        heads = [k for k in initialised if k.startswith(getattr(model, "HEAD_PREFIXES", ()))]
        lacked = [f"{n} {kind} tensors it lacks keep their initial values"
                  for n, kind in ((len(initialised) - len(heads), "tagger"), (len(heads), "curing and recon")) if n]
        say(f"warm start from {args.pretrained}" + "".join(f"; {x}" for x in lacked))
    resumed = None
    if args.resume:
        resume = Path(args.resume)
        if resume.is_dir():
            if CheckpointManager(resume).restore(state) is None:
                raise FileNotFoundError(f"--resume {resume}: no checkpoint in the directory")
        else:
            load_checkpoint(state, resume)
        resumed = {"epoch": state.epoch}
        if state.lr_scheduler is not None:
            resumed["step"] = state.lr_scheduler.last_epoch
            resumed["lr"] = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
        say(f"resumed from {resume}: {resumed}")
        say("random states restored from the checkpoint" if state.rng_restored else
            f"the checkpoint holds no random states (of this world size): they stay as --seed {args.seed} set them")

    out_dir = Path(args.output_dir)
    if args.eval and args.eval_uniformity:
        stats, analysis = _evaluate_uniformity(args, ctx, model, out_dir)
        say(stats)
        say(analysis)
        return RunResult(state, stats, [], resumed, analysis)
    if args.eval:
        stats = _evaluate(args, ctx, model)
        say(stats)
        return RunResult(state, stats, [], resumed)

    mgr = CheckpointManager(out_dir / "ckpt")
    pretraining = args.dataset_file in PRETRAINING
    say(f"text slots: {cfg.max_obj_texts} object, {cfg.max_verb_texts} verb "
        f"(--negative_text_sampling {args.negative_text_sampling}); "
        f"{ctx['accumulation_steps']} micro-batches a step"
        + ("" if mesh is None else f"; {mesh.world} ranks, {args.batch_size // mesh.world} images a rank"))
    text_cache = ctx["tokenize_fn"] is None or (cfg.pseudo_verb and cfg.pseudo_verb_mode == "offline")
    stats, saved = None, []
    for epoch in range(state.epoch + 1, args.epochs):
        data = _epoch_data(args, ctx, epoch)
        if text_cache:
            _cache_slot_texts(ctx, data["obj_vocab"], data["verb_vocab"])
        t0 = time.time()
        model.train()
        _, train_stats = train_one_epoch(
            step, model, ctx["train_ds"], batch_size=args.batch_size, cfg=cfg, text_encoder=ctx["text_encoder"],
            epoch=epoch, negative_text_sampling=args.negative_text_sampling,
            sampling_strategy=args.sampling_strategy, print_freq=args.print_freq, max_steps=args.max_steps,
            num_workers=args.num_workers, tokenize_fn=ctx["tokenize_fn"], augment_rng=ctx["data_rng"], mesh=mesh,
            **data,
        )
        state.epoch = epoch
        saved.append(mgr.save(epoch, state, config=args))
        line = {"epoch": epoch, "train": train_stats,
                "text_slots": {"obj": cfg.max_obj_texts, "verb": cfg.max_verb_texts}}
        if pretraining:
            say(f"epoch {epoch}: loss {train_stats.get('loss', float('nan')):.4f}")
        else:
            stats = line["test"] = _evaluate(args, ctx, model)
            if lead:
                key = HEADLINE_STAT[args.dataset_file]
                say(f"epoch {epoch}: {key} {stats[key]:.4f}")
        if lead:
            append_log_line(out_dir, {**line, "epoch_time": time.time() - t0})
    return RunResult(state, stats, [p for p in saved if p is not None], resumed)


if __name__ == "__main__":
    main(sys.argv[1:])
