"""Command-line entry point of the port, `rlipv2-torch` (counterpart of
rlipv2_tpu/cli.py; reference main.py:494-807).

    rlipv2-torch --preset rlip_parseda_v2_r50 --dataset_file hico \\
        --hoi_path HICO_DIR --pretrained RLIPv2.pth --tokenizer_dir ROBERTA_DIR \\
        --giou_verb_label --pseudo_verb --negative_text_sampling 500 \\
        --use_nms_filter --output_dir out

The parser has every flag of the JAX CLI with its default, and `--device`
(default "cuda"; the tests give "cpu"). There is no fallback from the card
to the CPU: with device "cuda" and no card, or a JPEG on the CPU, the run
raises. `main` runs the HICO-DET fine-tune, resume and evaluation of the
R50 ParSeDA presets: a warm start from `--pretrained` (the JAX CLI parses
it and never reads it); each epoch trains, saves a checkpoint, evaluates
and appends a JSON line to `output_dir/log.txt`; `--resume` (a checkpoint
file or directory) continues from the saved epoch, step and learning rate;
`--eval` evaluates only. With `--tokenizer_dir` the RoBERTa text encoder
trains in the graph, unless `--freeze_text_encoder`; evaluation encodes the
label texts with the current text encoder (the JAX CLI scores with the
initial one's cached features).

Paths not ported raise NotImplementedError naming their ROADMAP item
(`check_ported`): other datasets, the R-Tagger, sharding, freeze regimes,
the Swin training step and the other model variants.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    return p


def check_ported(args) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for a path the
    port does not run yet; ValueError for options that cannot be combined."""
    from rlipv2_tpu_torch.config import PRESETS

    todo = []
    if args.dataset_file in ("vcoco", "oi_sgg"):
        todo.append(f"--dataset_file {args.dataset_file} (its evaluator: ROADMAP queue 1 item 20)")
    if args.dataset_file in ("vg", "pretrain"):
        todo.append(f"--dataset_file {args.dataset_file} (the pre-training slice: ROADMAP queue 1 item 24)")
    if args.verb_tagger:
        todo.append("--verb_tagger (the R-Tagger: ROADMAP queue 1 item 16)")
    if args.fsdp > 1:
        todo.append("--fsdp > 1 (sharded training: ROADMAP queue 1 item 18)")
    if args.remat_encoder:
        todo.append("--remat_encoder (ROADMAP queue 1 item 15; batch 8 fits 80 GB without it)")
    for flag in ("frozen_vision", "unfrozen_params", "frozen_detection"):
        if getattr(args, flag):
            todo.append(f"--{flag} (freeze regimes: ROADMAP queue 1 item 15.4)")
    if args.eval_uniformity:
        todo.append("--eval_uniformity (evaluate_hoi_matching_uniformity: ROADMAP queue 1 item 20)")
    for flag in ("verb_curing", "masked_entity_modeling"):
        if getattr(args, flag):
            todo.append(f"--{flag} (model options: ROADMAP queue 1 item 7)")
    if args.preset not in PRESETS:
        raise ValueError(f"unknown preset {args.preset!r}; known: {sorted(PRESETS)}")
    variant = args.variant or PRESETS[args.preset]().variant
    if variant != "rlip_parseda_v2":
        todo.append(f"variant {variant} (rlip_parsed_v2: ROADMAP queue 1 items 7 and 16; "
                    "the others: item 20)")
    if PRESETS[args.preset]().backbone.name.startswith("swin") and not args.eval:
        todo.append(f"training preset {args.preset} (the Swin training step: ROADMAP queue 1 item 19)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))
    if not args.eval and (args.int8_dense or args.msda_impl == "pallas_int8"):
        raise ValueError("--int8_dense and --msda_impl pallas_int8 are inference only: use them with --eval")


def model_config(args):
    """The preset with the flags' model overrides."""
    from rlipv2_tpu_torch.config import PRESETS

    cfg = PRESETS[args.preset]()
    if args.pseudo_verb:
        cfg = dataclasses.replace(cfg, pseudo_verb=True, pseudo_verb_mode=args.pseudo_verb_mode)
    t = cfg.transformer
    if args.msda_impl:
        t = dataclasses.replace(t, msda_impl=args.msda_impl)
    if args.int8_dense:
        t = dataclasses.replace(t, int8_dense=True)
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, int8_dense=True))
    return dataclasses.replace(cfg, transformer=t)


def build_everything(args, model_cfg=None, transforms: Optional[dict] = None) -> dict:
    """The run's parts: model (on `args.device`), criterion, datasets,
    optimizer, scheduler and train step, the cached label-text encoder and,
    for in-graph text training, the slot tokenizer. `model_cfg` replaces
    the preset (the tests pass a tiny config); `transforms` ({"train": ...,
    "val": ...} HOITransforms) replaces the HICO augmentations (the tests
    pass small sizes)."""
    from rlipv2_tpu_torch.config import LossConfig, TrainConfig
    from rlipv2_tpu_torch.data.hico import build_hico
    from rlipv2_tpu_torch.data.transforms import HOITransform
    from rlipv2_tpu_torch.engine.loops import CachedTextEncoder
    from rlipv2_tpu_torch.engine.optim import build_optimizer, freeze_backbone_stem_and_layer1
    from rlipv2_tpu_torch.engine.train import make_train_step
    from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
    from rlipv2_tpu_torch.models.parseda import RLIPParSeDA

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, and torch sees no CUDA device (give --device cpu to run on the CPU)")
    cfg = model_cfg if model_cfg is not None else model_config(args)
    tcfg = TrainConfig(
        lr=args.lr, lr_backbone=args.lr_backbone, lr_text_encoder=args.lr_text_encoder,
        epochs=args.epochs, lr_drop=args.lr_drop, schedule=args.schedule,
        batch_size=args.batch_size, ema=args.ema, seed=args.seed,
    )
    loss_overrides = {k: v for k, v in (("verb_loss_type", args.verb_loss_type),
                                        ("obj_loss_type", args.obj_loss_type)) if v}
    lcfg = LossConfig(giou_verb_label=args.giou_verb_label, triplet_filtering=args.triplet_filtering,
                      exponential_loss=args.exponential_loss, exponential_hyper=args.exponential_hyper,
                      **loss_overrides)
    criterion = SetCriterionHOI(lcfg, subject_class=cfg.subject_class, pseudo_verb=cfg.pseudo_verb)

    transforms = transforms or {}
    data = dict(zero_shot_setting=args.zero_shot_setting, few_shot_transfer=args.few_shot_transfer, device=device)
    val_ds = build_hico("val", args.hoi_path, cfg.num_queries, transforms=transforms.get("val"), **data)
    train_ds = None
    if not args.eval:
        train_tf = transforms.get("train") or HOITransform(train=True, rng=random.Random(args.seed))
        train_ds = build_hico("train", args.hoi_path, cfg.num_queries, transforms=train_tf, **data)

    torch.manual_seed(args.seed)
    model = RLIPParSeDA(cfg)
    freeze_backbone_stem_and_layer1(model)
    model = model.to(device)

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
        steps_per_epoch = len(train_ds) // args.batch_size
        if args.max_steps is not None:
            steps_per_epoch = min(steps_per_epoch, args.max_steps)
        optimizer, scheduler = build_optimizer(model, tcfg, max(steps_per_epoch, 1),
                                               freeze_text_encoder=args.freeze_text_encoder)
        train_step = make_train_step(model, criterion, optimizer, scheduler, tcfg)
    return {
        "cfg": cfg, "tcfg": tcfg, "model": model, "criterion": criterion, "device": device,
        "optimizer": optimizer, "scheduler": scheduler, "train_step": train_step,
        "steps_per_epoch": steps_per_epoch, "train_ds": train_ds, "val_ds": val_ds,
        "text_encoder": CachedTextEncoder(encode_fn),
        "tokenize_fn": tokenize_fn if text_tokens else None,
    }


@dataclasses.dataclass
class RunResult:
    """What `main` returns: the run's state (model, optimizer, scheduler,
    EMA and last epoch), the last evaluation's stats, the checkpoint files
    written and, after --resume, where the run resumed (epoch, step and
    each parameter group's learning rate, as restored)."""

    state: object
    stats: Optional[dict]
    checkpoints: list
    resumed: Optional[dict] = None


def _evaluate(args, ctx, model) -> dict:
    from rlipv2_tpu_torch.engine.loops import evaluate_hoi

    model.eval()
    ctx["text_encoder"].clear()  # the text encoder may have trained since its features were cached
    return evaluate_hoi(lambda m, *a: m(*a), model, ctx["val_ds"], ctx["cfg"], ctx["text_encoder"],
                        batch_size=args.batch_size, bucket=None, use_nms_filter=args.use_nms_filter)


def _cache_slot_texts(ctx, dataset) -> None:
    """Encode every text a HICO slot can hold on this thread, in eval mode,
    before the loader's threads ask for them."""
    from rlipv2_tpu_torch.data.text import NO_OBJ_TEXT

    model = ctx["model"]
    was_training = model.training
    model.eval()
    ctx["text_encoder"].clear()
    ctx["text_encoder"](list(dataset.object_text) + [NO_OBJ_TEXT] + list(dataset.verb_text) + ["."])
    model.train(was_training)


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
    ctx = build_everything(args, model_cfg, transforms)
    try:
        return _run(args, ctx)
    finally:  # the image readers hold nvJPEG handles and states on the card
        for ds in (ctx["train_ds"], ctx["val_ds"]):
            if ds is not None:
                ds.reader.close()


def _run(args, ctx) -> RunResult:
    from rlipv2_tpu_torch.engine.checkpoint import CheckpointManager, TrainState, load_checkpoint
    from rlipv2_tpu_torch.engine.convert import load_reference_checkpoint
    from rlipv2_tpu_torch.engine.loops import train_one_epoch
    from rlipv2_tpu_torch.utils.logging import append_log_line

    model, cfg, step = ctx["model"], ctx["cfg"], ctx["train_step"]
    state = TrainState(model, ctx["optimizer"], ctx["scheduler"], None if step is None else step.ema_params)
    if args.pretrained:
        load_reference_checkpoint(model, args.pretrained)
        print(f"warm start from {args.pretrained}", flush=True)
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
        print(f"resumed from {resume}: {resumed}", flush=True)

    out_dir = Path(args.output_dir)
    if args.eval:
        stats = _evaluate(args, ctx, model)
        print(stats, flush=True)
        return RunResult(state, stats, [], resumed)

    mgr = CheckpointManager(out_dir / "ckpt")
    train_ds = ctx["train_ds"]
    text_cache = ctx["tokenize_fn"] is None or (cfg.pseudo_verb and cfg.pseudo_verb_mode == "offline")
    stats, saved = None, []
    for epoch in range(state.epoch + 1, args.epochs):
        indices = list(range(len(train_ds)))
        # each epoch's order from the seed and the epoch alone: a resumed
        # run visits the images as a straight one does
        random.Random(f"{args.seed}/{epoch}").shuffle(indices)
        if text_cache:
            _cache_slot_texts(ctx, train_ds)
        t0 = time.time()
        model.train()
        _, train_stats = train_one_epoch(
            step, model, train_ds, indices, args.batch_size, cfg, ctx["text_encoder"], epoch=epoch,
            negative_text_sampling=args.negative_text_sampling, obj_vocab=train_ds.object_text,
            verb_vocab=train_ds.verb_text, sampling_strategy=args.sampling_strategy,
            print_freq=args.print_freq, max_steps=args.max_steps, num_workers=args.num_workers,
            tokenize_fn=ctx["tokenize_fn"],
        )
        state.epoch = epoch
        saved.append(mgr.save(epoch, state, config=args))
        stats = _evaluate(args, ctx, model)
        append_log_line(out_dir, {"epoch": epoch, "train": train_stats, "test": stats,
                                  "epoch_time": time.time() - t0})
        print(f"epoch {epoch}: mAP {stats['mAP']:.4f}", flush=True)
    return RunResult(state, stats, [p for p in saved if p is not None], resumed)


if __name__ == "__main__":
    main(sys.argv[1:])
