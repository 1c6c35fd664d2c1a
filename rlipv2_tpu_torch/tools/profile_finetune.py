"""Step timing and device-time breakdown of the command line's HICO-DET
fine-tune on one GPU.

    python -m rlipv2_tpu_torch.tools.profile_finetune

Writes the fine-tune's inputs to a temporary directory
(`tools/main_path.py::main_finetune_tree`: a HICO tree over the JPEG
fixture, a tokenizer learned from the label texts, the main path's seeded
weights as pretrained.pth), builds what `cli.main` builds for
scripts/finetune_hico_parseda_r50.sh (`cli.build_everything`: preset
rlip_parseda_v2_r50, RPL, pseudo verbs, 500 negative texts, in-graph
RoBERTa training, batch 8, 2 loader threads; nvJPEG decode and the uint8
augmentations on the host), warm-starts it, and runs its train step
through `train_one_epoch`, as `cli.main` does, then
  1. times WARMUP + ITERS steps (host clock around each step, which ends in
     `torch.cuda.synchronize()`): p50 over all steps and by bucket, img/s,
     the loop's time between steps and peak device memory;
  2. times the step's text-encoder work alone with CUDA events: RoBERTa's
     forward and backward over one batch's slot tokens (the preset's 96 +
     160 slots at `--text_token_len` 24), bf16 autocast as in the step;
  3. profiles PROFILED further steps with torch.profiler: device time a
     step by kernel family and the busy share.
Prints the card's name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

WARMUP, ITERS, PROFILED = 2, 12, 3


def main() -> None:
    from rlipv2_tpu_torch import cli
    from rlipv2_tpu_torch.engine.convert import load_reference_checkpoint
    from rlipv2_tpu_torch.engine.loops import train_one_epoch
    from rlipv2_tpu_torch.tools.device_profile import profile_breakdown
    from rlipv2_tpu_torch.tools.main_path import BATCH, gpu_name_and_power_limit, main_finetune_tree

    print(gpu_name_and_power_limit(), flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    n_steps = WARMUP + ITERS + PROFILED
    with tempfile.TemporaryDirectory(prefix="profile_finetune_") as tmp:
        flags, _ = main_finetune_tree(Path(tmp), BATCH * n_steps, BATCH)
        args = cli.get_parser().parse_args(flags + ["--num_workers", "2", "--epochs", "1",
                                                    "--output_dir", str(Path(tmp) / "out")])
        cli.check_ported(args)
        ctx = cli.build_everything(args)
        model, step, ds = ctx["model"], ctx["train_step"], ctx["train_ds"]
        load_reference_checkpoint(model, args.pretrained)
        model.train()
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
            buckets.append(tuple(batch.pixels.shape[1:3]))
            if len(times) == WARMUP:
                torch.cuda.reset_peak_memory_stats()
            return metrics

        timed_step.end = None
        kw = dict(negative_text_sampling=args.negative_text_sampling, obj_vocab=ds.object_text,
                  verb_vocab=ds.verb_text, sampling_strategy=args.sampling_strategy, num_workers=2,
                  tokenize_fn=ctx["tokenize_fn"], print_freq=5)
        indices = list(range(len(ds)))
        _, stats = train_one_epoch(timed_step, model, ds, indices[: BATCH * (WARMUP + ITERS)], BATCH,
                                   ctx["cfg"], ctx["text_encoder"], **kw)
        steady, steady_buckets = times[WARMUP:], buckets[WARMUP:]
        by_bucket = {f"{h}x{w}": {"n": steady_buckets.count((h, w)),
                                  "p50_ms": 1e3 * float(np.median([t for t, b in zip(steady, steady_buckets)
                                                                   if b == (h, w)]))}
                     for h, w in sorted(set(steady_buckets))}
        print("finetune", json.dumps({
            "p50_ms": 1e3 * float(np.median(steady)),
            "p90_ms": 1e3 * float(np.percentile(steady, 90)),
            "img_per_s": BATCH * len(steady) / sum(steady),
            "by_bucket": by_bucket,
            "gap_between_steps_ms_p50": 1e3 * float(np.median(gaps[WARMUP - 1:])),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "warmup_ms": [1e3 * t for t in times[:WARMUP]],
            "stats": stats,
        }), flush=True)

        ids, mask = (torch.from_numpy(a).to(ctx["device"]) for a in ctx["tokenize_fn"](
            list(ds.object_text) + ["."] * (ctx["cfg"].max_obj_texts - len(ds.object_text))
            + list(ds.verb_text) + ["."] * (ctx["cfg"].max_verb_texts - len(ds.verb_text))))

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
            train_one_epoch(step, model, ds, indices[BATCH * (WARMUP + ITERS):], BATCH, ctx["cfg"],
                            ctx["text_encoder"], **{**kw, "print_freq": PROFILED})

        profile_breakdown(profiled_steps, PROFILED, "step")


if __name__ == "__main__":
    main()
