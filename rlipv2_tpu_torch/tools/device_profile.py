"""Device-time breakdown with torch.profiler, shared by the profile tools.

`profile_breakdown(run, n, unit, ranges)` runs `run()`, which does n units
of work (forwards, train steps), under torch.profiler (CPU and CUDA
activities), then prints the device time per unit, the busy share of the
profiled wall time, the device time per kernel family, the device time of
the kernels launched inside each named profiler range of `ranges`, and the
25 largest kernels, and returns the family totals. Kernel names are put in
families by the first matching key of FAMILIES.
"""

from __future__ import annotations

import json
import time

import torch

FAMILIES = (  # first match wins; matched against the lower-cased kernel name
    ("window_attn_kernel", ("window_attn",)),
    ("msda_bwd_kernel", ("msda_bwd",)),
    ("msda_int8_kernel", ("msda_int8",)),
    ("msda_fwd_kernel", ("msda_fwd",)),
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn")),  # before gemm: cuDNN's are *_implicit_gemm
    ("int8 gemm", ("gemm_s8",)),  # torch._int_mm's cutlass_80_tensorop_i16832gemm_s8_*
    ("gemm", ("nvjet", "gemm", "cublas")),
    ("optimizer", ("adam",)),
    ("layer/group norm", ("layer_norm", "group_norm", "groupnorm")),
    ("softmax", ("softmax",)),
    ("relu/clamp", ("clamp", "threshold")),
    ("index/scatter/gather", ("index", "scatter", "gather")),
    ("reduce", ("reduce",)),
    ("cast/copy/cat", ("copy", "memcpy", "memset", "catarray", "fill")),
    ("add", ("functor_add",)),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other elementwise"


def profile_breakdown(run, n: int, unit: str, ranges: tuple = ()) -> dict[str, float]:
    """Profile run(), n units of work; returns {family: device ms per unit}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    print(f"profiled: wall {1e3 * wall / n:.3f} ms/{unit}, device {total / 1e3 / n:.3f} ms/{unit}, "
          f"busy share {total / 1e6 / wall:.4f}", flush=True)
    fams: dict[str, float] = {}
    for e in events:
        fams[family(e.key)] = fams.get(family(e.key), 0.0) + e.self_device_time_total / 1e3 / n
    fams = dict(sorted(fams.items(), key=lambda kv: -kv[1]))
    print(f"families ms/{unit}:", json.dumps(fams), flush=True)
    if ranges:
        inside = {r: {"device_ms": 0.0, "calls": 0} for r in ranges}
        for e in prof.key_averages():
            if e.key in inside:
                inside[e.key] = {"device_ms": e.device_time_total / 1e3 / n, "calls": e.count // n}
        print(f"ranges per {unit}:", json.dumps(inside), flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"{e.self_device_time_total / 1e3 / n:9.3f} ms {e.count // n:5d}x  {e.key[:100]}", flush=True)
    return fams
