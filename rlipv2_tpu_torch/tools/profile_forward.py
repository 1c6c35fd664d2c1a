"""Forward timing and device-time breakdown of a main path on one GPU.

    python -m rlipv2_tpu_torch.tools.profile_forward [--model r50|swin_l] [--int8 none|msda|full]
        [--variant VARIANT|detector]

Builds the main path's model (`tools/main_path.py`: preset
rlip_parseda_v2_r50, or rlip_parseda_v2_swin_l with `--model swin_l`, at
full width, HICO text slots 81 + 117, RoBERTa-base 12 layers, seeded random
weights; with `--int8 msda` the R50 model on the int8 MSDA path, with
`--int8 full` also with the W8A8 projections, `main_path_int8_model`; with
`--variant` another variant of the factory at the R50 preset's widths, a
closed-vocabulary one (the zoo, `parse_dab_detr`) through
`main_path_zoo_model` and the others through `main_path_rlipv1_model`, or
with `--variant detector` the COCO `DETRDetector`, `main_path_detector_model`)
and one padded batch of 8 images at 832x1344, then
  1. times the bf16 forward with the CUDA kernels and with their plain
     PyTorch versions (MSDA, the int8 MSDA on the int8 paths, and window
     attention in the Swin backbone), in turns (kernel, plain, plain,
     kernel) of ITERS forwards each: p50, p90, img/s and peak device memory;
  2. profiles three kernel-path forwards with torch.profiler and prints the
     device time per forward by kernel and by kernel family, and the busy
     share of the profiled wall time.
Prints the card's name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

ITERS = 20


def build(device, name: str, int8: str = "none", variant: str | None = None):
    from rlipv2_tpu_torch.models.factory import CLOSED_VOCAB_VARIANTS
    from rlipv2_tpu_torch.tools.main_path import (
        BATCH, BUCKET, main_path_detector_model, main_path_int8_model, main_path_model, main_path_rlipv1_model,
        main_path_swin_model, main_path_zoo_model)

    if (int8 != "none" or variant) and name != "r50":
        raise SystemExit("--int8 and --variant are for --model r50")
    images_only = variant == "detector" or variant in CLOSED_VOCAB_VARIANTS + ("parse_dab_detr",)
    if variant == "detector":
        cfg, model = main_path_detector_model(device)
    elif variant:
        cfg, model = (main_path_zoo_model if images_only else main_path_rlipv1_model)(device, variant)
    elif int8 == "none":
        cfg, model = {"r50": main_path_model, "swin_l": main_path_swin_model}[name](device)
    else:
        cfg, model = main_path_int8_model(device, dense=int8 == "full")
    B, (H, W), T = BATCH, BUCKET, cfg.max_obj_texts + cfg.max_verb_texts
    rng = np.random.RandomState(0)
    pixels = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)).to(device)
    valid = torch.ones(B, H, W, dtype=torch.bool, device=device)
    for b in range(B):  # val images are up to 800 x 1333 after resizing
        valid[b, 800 - 20 * (b % 3):, :] = False
        valid[b, :, 1333 - 100 * (b % 4):] = False
    text = torch.from_numpy(rng.randn(B, T, cfg.text_encoder.hidden_size).astype(np.float32)).to(device)
    text_valid = torch.ones(B, T, dtype=torch.bool, device=device)

    @torch.no_grad()
    def forward():
        if images_only:
            return model(pixels, valid)
        return model(pixels, valid, text, text_valid, cfg.max_obj_texts)

    return forward, B


def main() -> None:
    from rlipv2_tpu_torch.models import layers, swin
    from rlipv2_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn, ms_deform_attn_int8_plain, ms_deform_attn_plain)
    from rlipv2_tpu_torch.ops.window_attention import window_attention, window_attention_plain
    from rlipv2_tpu_torch.tools.device_profile import profile_breakdown
    from rlipv2_tpu_torch.tools.main_path import gpu_name_and_power_limit

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=("r50", "swin_l"), default="r50")
    parser.add_argument("--int8", choices=("none", "msda", "full"), default="none")
    parser.add_argument("--variant", default=None, help="a variant of models/factory.py, or detector")
    args = parser.parse_args()
    print(gpu_name_and_power_limit(), flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    forward, B = build(torch.device("cuda"), args.model, args.int8, args.variant)

    def msda_plain(value, spatial_shapes, loc, attn, impl="auto"):
        fn = ms_deform_attn_int8_plain if impl == "pallas_int8" else ms_deform_attn_plain
        return fn(value, spatial_shapes, loc, attn)

    for impl in ("kernel", "plain", "plain", "kernel"):
        layers.ms_deform_attn = ms_deform_attn if impl == "kernel" else msda_plain
        swin.window_attention = window_attention if impl == "kernel" else window_attention_plain
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
    swin.window_attention = window_attention

    profile_breakdown(lambda: [forward() for _ in range(3)], 3, "forward")


if __name__ == "__main__":
    main()
