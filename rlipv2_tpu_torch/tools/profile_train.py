"""Train-step timing and device-time breakdown of the main path on one GPU.

    python -m rlipv2_tpu_torch.tools.profile_train [--model r50|swin_l]

Builds the main path's train step (`tools/main_path.py::main_train_step`:
preset rlip_parseda_v2_r50, or rlip_parseda_v2_swin_l with `--model swin_l`
(DropPath 0.2, its blocks and the encoder's layers rematerialized), at
full width, HICO text slots 81 + 117,
RoBERTa-base 12 layers with its text features cached and frozen, seeded
random weights, default LossConfig and TrainConfig, bf16 autocast, dropout
on) over the seeded synthetic train split at batch 8 in the 832x1344
bucket, and runs it through the port's `train_one_epoch`, then
  1. times WARMUP + ITERS steps (host clock around each step, which ends in
     `torch.cuda.synchronize()`): p50, p90, img/s and peak device memory,
     the warm-up steps excluded;
  2. profiles PROFILED further steps of the same loop with torch.profiler
     and prints the device time per step by kernel and by kernel family,
     window attention's backward, and the busy share of the profiled wall
     time.
Prints the card's name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

WARMUP, ITERS, PROFILED = 2, 10, 3


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Times and profiles the main path's train step.")
    parser.add_argument("--model", choices=("r50", "swin_l"), default="r50")
    opts = parser.parse_args(argv)
    from rlipv2_tpu_torch.engine.loops import train_one_epoch
    from rlipv2_tpu_torch.ops.window_attention import BACKWARD_RANGE
    from rlipv2_tpu_torch.tools.device_profile import profile_breakdown
    from rlipv2_tpu_torch.tools.main_path import (
        BATCH, gpu_name_and_power_limit, main_train_data, main_train_step,
    )

    print(gpu_name_and_power_limit(), flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    cfg, model, train_step = main_train_step("cuda", swin=opts.model == "swin_l")
    n_steps = WARMUP + ITERS + PROFILED
    dataset, text_encoder = main_train_data(cfg, model, BATCH * n_steps)

    times = []

    def timed_step(batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if len(times) == WARMUP:
            torch.cuda.reset_peak_memory_stats()
        return metrics

    indices = list(range(len(dataset)))
    _, stats = train_one_epoch(
        timed_step, model, dataset, indices[: BATCH * (WARMUP + ITERS)], BATCH, cfg,
        text_encoder, num_workers=2, print_freq=5,
    )
    steady = times[WARMUP:]
    print("train", json.dumps({
        "model": opts.model,
        "use_checkpoint": cfg.backbone.use_checkpoint,
        "remat_encoder": cfg.transformer.remat_encoder,
        "p50_ms": 1e3 * float(np.median(steady)),
        "p90_ms": 1e3 * float(np.percentile(steady, 90)),
        "img_per_s": BATCH * len(steady) / sum(steady),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "warmup_ms": [1e3 * t for t in times[:WARMUP]],
        "stats": stats,
    }), flush=True)

    def profiled_steps():
        train_one_epoch(train_step, model, dataset, indices[BATCH * (WARMUP + ITERS):], BATCH,
                        cfg, text_encoder, num_workers=2, print_freq=PROFILED)

    profile_breakdown(profiled_steps, PROFILED, "step", ranges=(BACKWARD_RANGE,))


if __name__ == "__main__":
    main()
