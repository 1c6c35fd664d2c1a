"""Step timing and device-time breakdown of a command-line training script
on one GPU: the HICO-DET fine-tune or the relational pre-training.

    python -m rlipv2_tpu_torch.tools.profile_finetune [--script finetune_hico|pretrain_mixed_vgcoco|vg|
        finetune_hico_swinL|pretrain_mixed_vgcocoo365_swinL|finetune_vcoco|finetune_oisgg|
        finetune_hico_parsed|tagger_train_vg|finetune_hico_rlip_parsed|finetune_hico_rlip_parse|
        finetune_hico_rlip_parse_v2|finetune_hico_heads|finetune_hico_matching] [--use_checkpoint]

Writes the script's inputs to a temporary directory, builds what `cli.main`
builds for it (`cli.build_everything`), warm-starts it from the seeded
pretrained.pth, and runs its train step through `train_one_epoch` on the
epoch's data from `cli._epoch_data`, as `cli.main` does:
  * finetune_hico (default), scripts/finetune_hico_parseda_r50.sh on
    `tools/main_path.py::main_finetune_tree` (a HICO tree over the JPEG
    fixture): preset rlip_parseda_v2_r50 with 96 + 160 text slots, RPL,
    pseudo verbs, 500 negative texts, in-graph RoBERTa training, batch 8;
  * pretrain_mixed_vgcoco, scripts/pretrain_mixed_vgcoco_parseda_r50.sh on
    `main_pretrain_tree` (VG and pseudo-labelled COCO files over the
    fixture): the same with 334 + 167 text slots, two micro-batches a
    step, the relation threshold, the overlap filter and the triplet
    filter;
  * vg, scripts/pretrain_vg_parseda_r50.sh on the VG file alone: one
    micro-batch a step, no threshold or overlap filter;
  * finetune_hico_swinL, scripts/finetune_hico_swinL.sh on the HICO tree:
    preset rlip_parseda_v2_swin_large (Swin-L, DropPath 0.2) with
    `--remat_encoder --ema`, RPL, in-graph RoBERTa training, batch 8;
  * pretrain_mixed_vgcocoo365_swinL, scripts/pretrain_mixed_vgcocoo365_swinL.sh
    on VG, COCO and O365 files: Swin-L, three micro-batches a step,
    `--remat_encoder --ema`, the filters as the mixed R50 script;
  * finetune_vcoco and finetune_oisgg, scripts/finetune_{vcoco,oisgg}_parseda_r50.sh
    on a V-COCO or Open Images v6 SGG tree over the fixture
    (`tools/vcoco_oisgg_tree.py`): R50, 500 negative texts (OI-SGG at 289 +
    160 slots), in-graph RoBERTa training, batch 8;
  * finetune_hico_parsed, scripts/finetune_hico_parsed_r50.sh on the HICO
    tree: preset rlip_parsed_v2_r50 (RLIP-ParSeD, 2-d reference points in
    the decoders), 500 negative texts, in-graph RoBERTa training, batch 8;
  * tagger_train_vg, scripts/tagger_train_vg.sh on the VG file: the
    R-Tagger (RLIP-ParSeD with its tagger parameters, the subject head,
    noised GT pairs through the DAB decoders, `tagger_losses` with BCE),
    its text slots sized to the batches' label spaces, batch 8;
  * finetune_hico_rlip_parsed, finetune_hico_rlip_parse and
    finetune_hico_rlip_parse_v2: finetune_hico_parsed's command with
    --variant: RLIP-ParSeD v1 (the plain deformable encoder), RLIP-ParSe
    (dense attention, decode-time fusion) and RLIP-ParSe v2 (the dense
    ALIF encoder), their weights in their own layouts;
  * finetune_hico_heads and finetune_hico_matching: finetune_hico's command
    with RLIP-ParSeDA's verb-curing and masked-entity heads and the
    exponential aux decay, and focal object CE with the asymmetric BCE verb
    loss, or the contrastive object and verb losses.
`--use_checkpoint` also rematerializes the Swin blocks
(`backbone.use_checkpoint`, which no script flag sets). All with 2 loader
threads, nvJPEG decode and the uint8 augmentations on the host. Then it
  1. times WARMUP + ITERS optimizer steps (host clock around each step,
     which ends in `torch.cuda.synchronize()`): p50 over all steps and by
     bucket, img/s, the loop's time between steps and peak device memory;
     and per micro-batch the host's time in the matcher: the copy of all
     layers' costs (`to_host`, which first waits for the forward), the
     Hungarian matchings (`assign`: one, or with the triplet filter two,
     on every valid GT and then on the kept ones) and the filter;
  2. times the step's text-encoder work alone with CUDA events: RoBERTa's
     forward and backward over one batch's slot tokens (the config's
     slots at `--text_token_len` 24), bf16 autocast as in the step;
  3. profiles PROFILED further steps with torch.profiler: device time a
     step by kernel family, the busy share, and the device time of window
     attention's backward (its profiler range).
Prints the card's name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

WARMUP, ITERS, PROFILED = 2, 10, 3
SCRIPTS = ("finetune_hico", "pretrain_mixed_vgcoco", "vg", "finetune_hico_swinL", "pretrain_mixed_vgcocoo365_swinL",
           "finetune_vcoco", "finetune_oisgg", "finetune_hico_parsed", "tagger_train_vg",
           "finetune_hico_rlip_parsed", "finetune_hico_rlip_parse", "finetune_hico_rlip_parse_v2",
           "finetune_hico_heads", "finetune_hico_matching")
HOST_TIMED = ("to_host", "assign", "triplet_filter")  # the criterion's host work


def _steps(data: dict, first: int, last: int) -> dict:
    """`data` (from `cli._epoch_data`) cut to optimizer steps [first, last)."""
    from rlipv2_tpu_torch.tools.main_path import BATCH

    if data.get("batch_lists") is not None:
        return {**data, "batch_lists": data["batch_lists"][first:last]}
    return {**data, "indices": data["indices"][BATCH * first : BATCH * last]}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Times and profiles a command-line training step.")
    parser.add_argument("--script", choices=SCRIPTS, default="finetune_hico")
    parser.add_argument("--use_checkpoint", action="store_true", help="rematerialize the Swin blocks")
    opts = parser.parse_args(argv)
    script = opts.script
    if opts.use_checkpoint and not script.endswith("swinL"):
        parser.error("--use_checkpoint rematerializes Swin blocks: it needs a Swin-L script")
    from rlipv2_tpu_torch import cli
    from rlipv2_tpu_torch.config import PRESETS
    from rlipv2_tpu_torch.engine.convert import load_reference_checkpoint
    from rlipv2_tpu_torch.engine.loops import train_one_epoch
    from rlipv2_tpu_torch.losses import criterion
    from rlipv2_tpu_torch.tools.device_profile import profile_breakdown
    from rlipv2_tpu_torch.ops.window_attention import BACKWARD_RANGE
    from rlipv2_tpu_torch.tools.main_path import (BATCH, FINETUNE_SCRIPTS, gpu_name_and_power_limit,
                                                  main_finetune_tree, main_pretrain_tree, with_swin_checkpoint)

    print(gpu_name_and_power_limit(), flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    n_steps = WARMUP + ITERS + PROFILED
    with tempfile.TemporaryDirectory(prefix="profile_") as tmp:
        if script in FINETUNE_SCRIPTS:
            flags, _ = main_finetune_tree(Path(tmp), BATCH * n_steps, BATCH, script)
        else:
            flags, _, _ = main_pretrain_tree(Path(tmp), script)
        args = cli.get_parser().parse_args(flags + ["--num_workers", "2", "--epochs", "1",
                                                    "--output_dir", str(Path(tmp) / "out")])
        cli.check_ported(args)
        ctx = cli.build_everything(args, with_swin_checkpoint(PRESETS[args.preset](), opts.use_checkpoint))
        model, step, ds, cfg = ctx["model"], ctx["train_step"], ctx["train_ds"], ctx["cfg"]
        k_steps = ctx["accumulation_steps"]
        load_reference_checkpoint(model, args.pretrained)
        model.train()
        data = cli._epoch_data(args, ctx, epoch=0)
        n_have = len(data["batch_lists"]) if data.get("batch_lists") is not None else len(data["indices"]) // BATCH
        if n_have < n_steps:
            raise SystemExit(f"{n_have} steps an epoch, fewer than {n_steps}")

        host = {name: [] for name in HOST_TIMED}
        originals = {name: getattr(criterion, name) for name in HOST_TIMED}

        def host_timed(name):
            def timed(*a, **k):
                t = time.perf_counter()
                out = originals[name](*a, **k)
                host[name].append(time.perf_counter() - t)
                return out

            return timed

        times, buckets, gaps = [], [], []

        def timed_step(batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if timed_step.end is not None:
                gaps.append(t - timed_step.end)
            metrics = step(batch)
            torch.cuda.synchronize()
            timed_step.end = time.perf_counter()
            times.append(timed_step.end - t)
            first = batch[0] if k_steps > 1 else batch  # a group of K micro-batches, or a TrainBatch
            buckets.append(tuple(first.pixels.shape[1:3]))
            if len(times) == WARMUP:
                torch.cuda.reset_peak_memory_stats()
                for v in host.values():
                    v.clear()
            return metrics

        timed_step.end = None
        kw = dict(batch_size=BATCH, cfg=cfg, text_encoder=ctx["text_encoder"],
                  negative_text_sampling=args.negative_text_sampling, sampling_strategy=args.sampling_strategy,
                  num_workers=2, tokenize_fn=ctx["tokenize_fn"])
        for name in HOST_TIMED:
            setattr(criterion, name, host_timed(name))
        try:
            _, stats = train_one_epoch(timed_step, model, ds, print_freq=5, **kw,
                                       **_steps(data, 0, WARMUP + ITERS))
        finally:
            for name, fn in originals.items():
                setattr(criterion, name, fn)
        steady, steady_buckets = times[WARMUP:], buckets[WARMUP:]
        by_bucket = {f"{h}x{w}": {"n": steady_buckets.count((h, w)),
                                  "p50_ms": 1e3 * float(np.median([t for t, b in zip(steady, steady_buckets)
                                                                   if b == (h, w)]))}
                     for h, w in sorted(set(steady_buckets))}
        micro = len(steady) * k_steps
        print(script, json.dumps({
            "backbone": cfg.backbone.name,
            "use_checkpoint": cfg.backbone.use_checkpoint,
            "remat_encoder": cfg.transformer.remat_encoder,
            "p50_ms": 1e3 * float(np.median(steady)),
            "p90_ms": 1e3 * float(np.percentile(steady, 90)),
            "img_per_s": BATCH * k_steps * len(steady) / sum(steady),
            "micro_batches_a_step": k_steps,
            "text_slots": [cfg.max_obj_texts, cfg.max_verb_texts],
            "by_bucket": by_bucket,
            "gap_between_steps_ms_p50": 1e3 * float(np.median(gaps[WARMUP - 1:])),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "matcher_host_ms_per_micro_batch": {k: 1e3 * sum(v) / micro for k, v in host.items()},
            "warmup_ms": [1e3 * t for t in times[:WARMUP]],
            "stats": stats,
        }), flush=True)

        slots = ((list(data["obj_vocab"]) + ["."] * cfg.max_obj_texts)[: cfg.max_obj_texts]
                 + (list(data["verb_vocab"]) + ["."] * cfg.max_verb_texts)[: cfg.max_verb_texts])
        ids, mask = (torch.from_numpy(a).to(ctx["device"]) for a in ctx["tokenize_fn"](slots))

        def text_fwd_bwd():
            model.encode_text(ids, mask).sum().backward()

        for _ in range(3):
            text_fwd_bwd()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            text_fwd_bwd()
        end.record()
        torch.cuda.synchronize()
        model.zero_grad(set_to_none=True)
        print("text_encoder", json.dumps({"tokens": list(ids.shape), "fwd_bwd_ms": start.elapsed_time(end) / 10}),
              flush=True)

        def profiled_steps():
            train_one_epoch(step, model, ds, print_freq=PROFILED, **kw, **_steps(data, WARMUP + ITERS, n_steps))

        profile_breakdown(profiled_steps, PROFILED, "step", ranges=(BACKWARD_RANGE,))
        ds.close()


if __name__ == "__main__":
    main()
