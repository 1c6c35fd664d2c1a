"""Forward timing and device-time breakdown of the main path on one GPU.

    python -m rlipv2_tpu_torch.tools.profile_forward

Builds the main path's model (`tools/main_path.py`: preset
rlip_parseda_v2_r50 at full width, HICO text slots 81 + 117, RoBERTa-base
12 layers, seeded random weights) and one padded batch of 8 images at
832x1344, then
  1. times the bf16 forward with the MSDA CUDA kernel and with the plain
     PyTorch MSDA version, in turns (kernel, plain, plain, kernel) of
     ITERS forwards each: p50, p90, img/s and peak device memory;
  2. profiles three kernel-path forwards with torch.profiler and prints the
     device time per forward by kernel and by kernel family, and the busy
     share of the profiled wall time.
Prints the card's name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

ITERS = 20


def build(device):
    from rlipv2_tpu_torch.tools.main_path import BATCH, BUCKET, main_path_model

    cfg, model = main_path_model(device)
    B, (H, W), T = BATCH, BUCKET, cfg.max_obj_texts + cfg.max_verb_texts
    rng = np.random.RandomState(0)
    pixels = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)).to(device)
    valid = torch.ones(B, H, W, dtype=torch.bool, device=device)
    for b in range(B):  # val images are up to 800 x 1333 after resizing
        valid[b, 800 - 20 * (b % 3):, :] = False
        valid[b, :, 1333 - 100 * (b % 4):] = False
    text = torch.from_numpy(rng.randn(B, T, 768).astype(np.float32)).to(device)
    text_valid = torch.ones(B, T, dtype=torch.bool, device=device)

    @torch.no_grad()
    def forward():
        return model(pixels, valid, text, text_valid, cfg.max_obj_texts)

    return forward, B


def main() -> None:
    from rlipv2_tpu_torch.models import layers
    from rlipv2_tpu_torch.tools.device_profile import profile_breakdown
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain
    from rlipv2_tpu_torch.tools.main_path import gpu_name_and_power_limit

    print(gpu_name_and_power_limit(), flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    forward, B = build(torch.device("cuda"))

    for impl in ("kernel", "plain", "plain", "kernel"):
        layers.ms_deform_attn = ms_deform_attn if impl == "kernel" else ms_deform_attn_plain
        forward()
        forward()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(ITERS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        print(impl, json.dumps({
            "p50_ms": 1e3 * float(np.median(times)),
            "p90_ms": 1e3 * float(np.percentile(times, 90)),
            "img_per_s": B * len(times) / sum(times),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }), flush=True)
    layers.ms_deform_attn = ms_deform_attn

    profile_breakdown(lambda: [forward() for _ in range(3)], 3, "forward")


if __name__ == "__main__":
    main()
