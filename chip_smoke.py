"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without printing
a result; no phase catches its own failure):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; exits non-zero when torch sees no CUDA device;
  2. build: compiles the MSDA forward and backward kernels, the window
     attention kernel and the int8 MSDA forward kernel from the checkout's
     sources, one nvcc each, all started together;
  3. kernel vs plain: the kernel against `ms_deform_attn_plain` at the
     main path's encoder shape (832x1344: 4 levels, Q = S = 23205, B = 8,
     H = 8, D = 32), its decoder shape (Q = 200, 4-d anchors) and an
     out-of-bounds case (locations in [-0.2, 1.2]);
     float32 within 1e-5 and bfloat16 value within 2e-2 of the plain version
     computed in float32 from the same bf16 values; both timed with CUDA
     events. Every case (D = 32) must take the kernel's D = 32 gather
     design. Beside the HBM bound it prints the L2-side byte count (every
     sample's four corner rows, as the gather reads them, plus loc, attn and
     the output) and the time it takes at the L2 read rate measured here
     (a reduction over an L2-resident 16 MB buffer);
  3c. int8 MSDA vs plain: the int8 kernel (impl "pallas_int8") against
     `ms_deform_attn_int8_plain` at the shapes of phase 3, float32 within
     1e-5 and bf16 value within 1e-2 of max|plain| (the same codes; one
     bf16 rounding); and against the exact `ms_deform_attn_plain` within
     2e-2 of max|exact| and not equal to it (the JAX package's bound). At
     B = 8, the encoder shape and bf16, CUDA events time the kernel alone
     on ready codes, `quantize_value_int8`, the whole int8 path, the plain
     int8 version and the exact kernel;
  3b. window attention vs plain: the kernel against `window_attention_plain`
     at the four Swin-L stage shapes of the main path (832x1344, batch 8,
     window 12: N = 144, head dim 32, 6-48 heads) and at N = 49, with the
     stage's real shift mask and without; float32 within 2e-5 and bf16 qkv
     within 2e-2 of the plain version computed in float32 from the same
     bf16 values; kernel, plain and `scaled_dot_product_attention` (the
     library yardstick, on q, k, v already laid out as (nWB, h, N, d))
     timed with CUDA events at bf16 (bf16 takes the kernel's tensor-core
     tiles, float32 its SIMT design); every Swin-L stage must have the main
     path's 144 tokens a window; at the stage-3 shape the gradient through
     the kernel's autograd.Function against autograd of the plain version;
  4. the golden pack: the reference-layout weights and inputs of
     tests/fixtures/golden_pack.npz through the port on the card (float32,
     TF32 off), within 2e-3 of the frozen reference outputs;
  5. the main path: `tools/main_path.py::main_path_model` (preset
     rlip_parseda_v2_r50 with HICO-size text slots, 81 object and 117
     verb, 12-layer RoBERTa-base, seeded random weights), bf16 autocast, through the port's `evaluate_hoi` at batch 8
     and bucket (832, 1344) over a seeded synthetic dataset of 5 batches
     (the first is warm-up). Checks finite outputs, boxes in (0, 1), 12
     MSDA and no window-attention or int8 launches per forward, no
     backward launches and HICO stats in [0, 1]; prints img/s, p50 forward
     latency and peak device memory;
  5c. the quantized main path `eval_r50_int8`: the same through
     `tools/main_path.py::main_path_int8_model` (msda_impl "pallas_int8",
     the same seeded weights): 12 int8 MSDA launches and no exact ones per
     forward;
  5d. `eval_r50_int8_full`: `main_path_int8_model(dense=True)`, the W8A8
     projections on too: as 5c, and every int8 projection of the model
     called once per forward;
  5e. int8 fidelity, printed and not gated: the exact, int8-MSDA and
     full-int8 R50 forwards on one batch: max |delta| of the verb logits
     and boxes, the canned-GT mAP delta of `eval/int8_gate.py` against the
     exact path, its 1 % score-jitter control and the p90 relative
     verb-score error (the protocol of the JAX package's benchmark; with
     random weights the mAP is noise-bound);
  5b. the Swin-L main path: the same as 5 through
     `tools/main_path.py::main_path_swin_model` (preset
     rlip_parseda_v2_swin_l, `swin_large_384`), built after the R50 models
     are dropped; 24 window-attention and 12 MSDA launches per forward;
  6. backward kernel vs plain: dvalue, dloc and dattn of the kernel against
     autograd of `ms_deform_attn_plain` at the encoder shape with B = 2 (the
     plain oracle holds a (B, Q, H, 64, D) float32 gather and its gradient),
     the decoder shape and the out-of-bounds case; float32 within 1e-4 and
     bfloat16 value and cotangent within 2e-2 of max|ref| per tensor, the
     reference computed in float32 from the same bf16 values (the reasons:
     the order of the atomic adds into dvalue changes from run to run, and
     bf16 rounds the inputs). Forward plus backward of kernel and plain are
     timed with CUDA events, and each backward alone at the encoder shape
     with B = 8;
  7. the train path: `tools/main_path.py::main_train_step` (the same model
     in train mode, dropout on, backbone stem and layer1 frozen, default
     LossConfig and TrainConfig, bf16 autocast) through the port's
     `train_one_epoch` over the synthetic train split: TRAIN_STEPS steps at
     batch 8 in the (832, 1344) bucket, the first one warm-up. Checks finite
     losses and grad norms, `nonfinite` 0, 12 forward and 12 backward kernel
     launches per step, frozen parameters and FrozenBN buffers bit-identical
     and every trainable group moved; prints step p50, img/s and peak device
     memory.

Before the main path of phases 5, 5c, 5d, 5b and 7 every launch count is
set to 0, and each is read just after; every MSDA forward launch there must
have taken the D = 32 gather, and every window-attention launch must have
had bf16 qkv with N = 144 (the tensor-core tiles). The kernel phases print
the two redesigned kernels' earlier per-call times as a line of its own,
quoted from PERF.md and not measured in the run. The line before the last
two is the card's name and power limit, the second-to-last a JSON object
{"kernels": [...]} with each kernel's launches (in all, and by path), error
against its plain version, times, bound and library time, and the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ENC_SHAPES = ((104, 168), (52, 84), (26, 42), (13, 21))  # 832x1344 at strides 8-64
N_BATCHES = 5
MSDA_PER_FORWARD = 12  # 6 encoder + 3 ho-decoder + 3 verb-decoder layers
WINDOW_PER_FORWARD = 24  # Swin-L blocks: 2 + 2 + 18 + 2
TRAIN_STEPS = 6
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "ms_deform_attn_fwd": ("rlipv2_tpu_torch/ops/csrc/ms_deform_attn_fwd.cu",
                           "rlipv2_tpu/ops/ms_deform_attn_v4.py:87"),
    "ms_deform_attn_bwd": ("rlipv2_tpu_torch/ops/csrc/ms_deform_attn_bwd.cu",
                           "rlipv2_tpu/ops/ms_deform_attn_v4.py:267"),
    "window_attention_fwd": ("rlipv2_tpu_torch/ops/csrc/window_attention_fwd.cu",
                             "rlipv2_tpu/ops/window_attention.py:56"),
    "ms_deform_attn_int8_fwd": ("rlipv2_tpu_torch/ops/csrc/ms_deform_attn_int8_fwd.cu",
                                "rlipv2_tpu/ops/ms_deform_attn_v4.py:843"),
}
# NVIDIA H100 SXM data sheet at 700 W: HBM bandwidth; the float32 rate
# outside the tensor cores (the MSDA kernels do scalar float32 arithmetic);
# the dense bf16 tensor-core rate (window attention's work is two matrix
# products a window and head)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_TENSOR_OPS_PER_S = 989e12
RATE_NAMES = {PEAK_F32_OPS_PER_S: "float32 non-tensor 67 TFLOP/s",
              PEAK_BF16_TENSOR_OPS_PER_S: "bf16 tensor core 989 TFLOP/s"}
# the MSDA forward design the main paths must take (the wrapper counts
# launches by design); window attention's design follows qkv's dtype, and
# the main paths must launch it on bf16 windows of 144 tokens
MSDA_MAIN_DESIGN = "gather_d32"
WINDOW_MAIN_LAUNCH = "bfloat16/N144"
# the per-call times of the designs the two redesigned kernels replaced, at
# the shapes of their kernels-line rows (MSDA: the encoder shape, B 8, bf16;
# window attention: Swin-L stage 0 with the shift mask, bf16), quoted from
# PERF.md section 6 (NVIDIA H100 80GB HBM3, 700 W); those designs are no
# longer in the tree, so this run cannot measure them and prints them apart
# from the kernels line
QUOTED_EARLIER_MS = {"ms_deform_attn_fwd": 3.888, "window_attention_fwd": 7.098}


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase() -> str:
    from rlipv2_tpu_torch.tools.main_path import gpu_name_and_power_limit

    smi = gpu_name_and_power_limit()
    log(f"[device] {smi}")
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    return smi


def build_phase() -> None:
    from rlipv2_tpu_torch.ops.cuda_build import build

    t0 = time.perf_counter()
    sources = [src.rsplit("/", 1)[1] for src, _ in KERNELS.values()]
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(lambda src: build(src, verbose=True), sources))
    log(f"[build] {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s")


def _cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _msda_inputs(shapes, B, Q, H, D, P, lo, hi, gen, dev):
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, H, D, generator=gen, device=dev)
    loc = lo + (hi - lo) * torch.rand(B, Q, H, L, P, 2, generator=gen, device=dev)
    attn = torch.softmax(torch.randn(B, Q, H, L * P, generator=gen, device=dev), -1)
    return value, loc, attn.view(B, Q, H, L, P)


def _decoder_locations(B, Q, gen, dev):
    """4-d anchors: loc = centre + offset / P * wh * 0.5, as the decoder forms them."""
    anchors = torch.rand(B, Q, 1, 1, 1, 4, generator=gen, device=dev)
    offsets = torch.randn(B, Q, 8, 4, 4, 2, generator=gen, device=dev)
    return anchors[..., :2] + offsets / 4 * anchors[..., 2:] * 0.5


def _valid_corners(shapes, loc) -> int:
    """Bilinear corners inside their level: the samples this data needs."""
    n = 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(loc[..., lvl, :, 0] * w - 0.5)
        y0 = torch.floor(loc[..., lvl, :, 1] * h - 0.5)
        vx = [(x0 + i >= 0) & (x0 + i <= w - 1) for i in (0, 1)]
        vy = [(y0 + i >= 0) & (y0 + i <= h - 1) for i in (0, 1)]
        n += sum(int((a & b).sum()) for a in vx for b in vy)
    return n


def _bound(n_bytes: int, n_ops: int, ops_per_s: float = PEAK_F32_OPS_PER_S) -> dict:
    """Least time on the card: bytes over HBM bandwidth or operations over
    `ops_per_s` (by default the float32 non-tensor-core rate), whichever is
    larger."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * n_ops / ops_per_s
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops, "bound_rate": RATE_NAMES[ops_per_s]}


def _design_delta(counter: dict, before: dict) -> dict:
    return {k: v - before[k] for k, v in counter.items() if v != before[k]}


def l2_read_rate() -> float:
    """Bytes/s at which a float32 row sum reads a 16 MB buffer that stays in
    the 50 MB L2, 64 times in one launch (a stride-0 view): the L2 read rate
    a PyTorch reduction reaches here (L1 hits, if any, count in it)."""
    x = torch.ones(4 << 20, device="cuda")
    rows = x.expand(64, -1)
    ms = _cuda_ms(lambda: rows.sum(dim=1), 50)
    rate = rows.numel() * 4 / (ms * 1e-3)
    log(f"[kernel] L2 read rate: {rate / 1e12:.3f} TB/s (64 row sums over one 16 MB L2-resident buffer, "
        f"{ms:.5f} ms)")
    return rate


def kernel_phase() -> list[dict]:
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain
    from rlipv2_tpu_torch.tools.main_path import BATCH

    l2_rate = l2_read_rate()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    S = sum(h * w for h, w in ENC_SHAPES)
    cases = [
        ("encoder", dict(B=BATCH, Q=S, lo=0.0, hi=1.0)),
        ("decoder_q200", dict(B=BATCH, Q=200, lo=0.0, hi=1.0)),
        ("out_of_bounds", dict(B=2, Q=4096, lo=-0.2, hi=1.2)),
    ]
    results = []
    for name, c in cases:
        value, loc, attn = _msda_inputs(ENC_SHAPES, c["B"], c["Q"], 8, 32, 4, c["lo"], c["hi"], gen, dev)
        if name == "decoder_q200":
            loc = _decoder_locations(c["B"], c["Q"], gen, dev)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            v = value.to(dtype)
            before = dict(ms_deform_attn.designs)
            got = ms_deform_attn(v, ENC_SHAPES, loc, attn)
            designs = _design_delta(ms_deform_attn.designs, before)
            if designs != {MSDA_MAIN_DESIGN: 1}:
                raise AssertionError(f"{name} at D = 32 took the designs {designs}, not {MSDA_MAIN_DESIGN}")
            want = ms_deform_attn_plain(v.float(), ENC_SHAPES, loc, attn)
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            iters = 20 if c["Q"] > 1000 else 200
            ms = _cuda_ms(lambda: ms_deform_attn(v, ENC_SHAPES, loc, attn), iters)
            plain_ms = _cuda_ms(lambda: ms_deform_attn_plain(v, ENC_SHAPES, loc, attn), iters)
            row = {"case": f"{name}/{str(dtype).replace('torch.', '')}", "Q": c["Q"], "B": c["B"],
                   "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                   # each input read once, the output written once; 2 operations
                   # (multiply, add) per valid corner and channel
                   **_bound(sum(t.numel() * t.element_size() for t in (v, loc, attn, got)),
                            2 * 32 * _valid_corners(ENC_SHAPES, loc))}
            # the L2 side: four corner rows of D values for every sample, as
            # the gather reads them (an invalid corner reads a clamped row),
            # plus loc, attn and the output once
            row["design"] = MSDA_MAIN_DESIGN
            row["l2_bytes"] = (attn.numel() * 4 * 32 * v.element_size()
                               + sum(t.numel() * t.element_size() for t in (loc, attn, got)))
            row["l2_read_rate"] = l2_rate
            row["l2_ms"] = 1e3 * row["l2_bytes"] / l2_rate
            log(f"[kernel] {json.dumps(row)}")
            if not err <= tol:
                raise AssertionError(f"kernel disagrees with plain version: {row}")
            results.append(row)
    return results


def int8_kernel_phase() -> tuple[list[dict], dict]:
    """The int8 MSDA kernel against `ms_deform_attn_int8_plain` (the same
    codes) and against the exact `ms_deform_attn_plain` (fidelity), at the
    shapes of phase 3. Returns the case rows and the timing row: at B = 8,
    the encoder shape and bf16, the kernel alone on ready codes, the
    quantize pass, the whole int8 path, its plain version and the exact
    kernel."""
    from rlipv2_tpu_torch.ops.ms_deform_attn import (
        launch_int8_kernel, ms_deform_attn, ms_deform_attn_int8_plain, ms_deform_attn_plain,
        quantize_value_int8)
    from rlipv2_tpu_torch.tools.main_path import BATCH

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    S = sum(h * w for h, w in ENC_SHAPES)
    cases = [
        ("encoder", dict(B=BATCH, Q=S, lo=0.0, hi=1.0)),
        ("decoder_q200", dict(B=BATCH, Q=200, lo=0.0, hi=1.0)),
        ("out_of_bounds", dict(B=2, Q=4096, lo=-0.2, hi=1.2)),
    ]
    rows, timing = [], None
    for name, c in cases:
        value, loc, attn = _msda_inputs(ENC_SHAPES, c["B"], c["Q"], 8, 32, 4, c["lo"], c["hi"], gen, dev)
        if name == "decoder_q200":
            loc = _decoder_locations(c["B"], c["Q"], gen, dev)
        # float32 within 1e-5 of max|plain| (the same codes, sums in another
        # order); bf16 within 1e-2 (one bf16 rounding of the float32 sum)
        for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            v = value.to(dtype)
            with torch.no_grad():
                got = ms_deform_attn(v, ENC_SHAPES, loc, attn, impl="pallas_int8").float()
                want = ms_deform_attn_int8_plain(v, ENC_SHAPES, loc, attn).float()
                exact = ms_deform_attn_plain(v.float(), ENC_SHAPES, loc, attn)
            torch.cuda.synchronize()
            scale, exact_scale = float(want.abs().max()), float(exact.abs().max())
            row = {"case": f"{name}/{str(dtype).replace('torch.', '')}", "Q": c["Q"], "B": c["B"],
                   "max_abs_err": float((got - want).abs().max()), "max_abs_plain": scale, "rel_tol": rel,
                   # fidelity: the JAX package's bound on the int8 path
                   "max_abs_err_vs_exact": float((got - exact).abs().max()), "max_abs_exact": exact_scale}
            log(f"[int8] {json.dumps(row)}")
            if not row["max_abs_err"] <= rel * scale:
                raise AssertionError(f"int8 kernel disagrees with its plain version: {row}")
            if not 0.0 < row["max_abs_err_vs_exact"] <= 2e-2 * exact_scale:
                raise AssertionError(f"int8 kernel outside 2e-2 of the exact function, or equal to it: {row}")
            rows.append(row)
            del got, want, exact
            if name == "encoder" and dtype == torch.bfloat16:
                q8, scales = quantize_value_int8(v, ENC_SHAPES)
                out = launch_int8_kernel(q8, scales, ENC_SHAPES, loc, attn, dtype)
                iters = 20
                with torch.no_grad():
                    timing = {
                        "case": row["case"], "B": c["B"], "Q": c["Q"], "max_abs_err": row["max_abs_err"],
                        "ms": _cuda_ms(lambda: launch_int8_kernel(q8, scales, ENC_SHAPES, loc, attn, dtype), iters),
                        "quantize_ms": _cuda_ms(lambda: quantize_value_int8(v, ENC_SHAPES), iters),
                        "int8_path_ms": _cuda_ms(
                            lambda: ms_deform_attn(v, ENC_SHAPES, loc, attn, impl="pallas_int8"), iters),
                        "plain_ms": _cuda_ms(lambda: ms_deform_attn_int8_plain(v, ENC_SHAPES, loc, attn), 3),
                        "exact_kernel_ms": _cuda_ms(lambda: ms_deform_attn(v, ENC_SHAPES, loc, attn), iters),
                    }
                # the kernel: the int8 codes, the scales, loc and attn read once,
                # the output written once; 2 operations (the integer multiply and
                # add) per valid corner and channel
                timing.update(_bound(sum(t.numel() * t.element_size() for t in (q8, scales, loc, attn, out)),
                                     2 * 32 * _valid_corners(ENC_SHAPES, loc)))
                # the quantize pass: the value read once, codes and scales written
                # once; its time adds to the kernel's on the main path
                qb = _bound(sum(t.numel() * t.element_size() for t in (v, q8, scales)), 0)
                timing["quantize_bound_ms"], timing["quantize_bound_bytes"] = qb["bound_ms"], qb["bound_bytes"]
                log(f"[int8] timing: {json.dumps(timing)}")
                del q8, scales, out
        del value, loc, attn, v
        torch.cuda.empty_cache()
    return rows, timing


def _swin_stage_grids(spec, bucket, batch) -> list[tuple[int, int, int]]:
    """(Hp, Wp, nWB) of each stage of a Swin backbone at `bucket`, padded
    as the backbone pads: patch grid ceil(side / 4), padded to window
    multiples at each stage, halved (rounding up) by each PatchMerging."""
    ws = spec.window_size
    H, W = -(-bucket[0] // 4), -(-bucket[1] // 4)
    grids = []
    for _ in spec.depths:
        Hp, Wp = H + (-H) % ws, W + (-W) % ws
        grids.append((Hp, Wp, batch * (Hp // ws) * (Wp // ws)))
        H, W = -(-H // 2), -(-W // 2)
    return grids


def window_phase() -> tuple[list[dict], dict, dict]:
    """The window-attention kernel against `window_attention_plain` at the
    Swin-L stage shapes of the main path and at N = 49. Returns the case
    rows, the per-forward totals at bf16, and the gradient check."""
    import torch.nn.functional as F

    from rlipv2_tpu_torch.models.swin import SWIN_SPECS, shifted_window_mask
    from rlipv2_tpu_torch.ops.window_attention import window_attention, window_attention_plain
    from rlipv2_tpu_torch.tools.main_path import BATCH, BUCKET

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    spec = SWIN_SPECS["swin_large_384"]
    d = 32
    # (name, window, padded grid, windows, heads, blocks a forward)
    cases = [(f"stage{s}", spec.window_size, Hp, Wp, nWB, spec.num_heads[s], spec.depths[s])
             for s, (Hp, Wp, nWB) in enumerate(_swin_stage_grids(spec, BUCKET, BATCH))]
    cases.append(("n49", 7, 28, 28, 2 * 16, 6, 0))  # window 7: two images of 4 x 4 windows
    rows = []
    per_forward = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "calls": 0}
    grad_check = {}
    for name, ws, Hp, Wp, nWB, h, depth in cases:
        N, C = ws * ws, h * d
        if name.startswith("stage") and N != 144:
            raise AssertionError(f"Swin-L {name} has {N} tokens a window, not the main path's 144")
        qkv = torch.randn(nWB, N, 3 * C, generator=gen, device=dev)
        bias = torch.randn(h, N, N, generator=gen, device=dev)
        shift_mask = shifted_window_mask(Hp, Wp, ws, ws // 2, dev)
        n_shifted = depth // 2 if min(Hp, Wp) > ws else 0  # the odd blocks shift
        for masked in (False, True):
            mask = shift_mask if masked else None
            calls = n_shifted if masked else depth - n_shifted
            for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
                x = qkv.to(dtype)
                before = window_attention.launches
                got = window_attention(x, bias, mask, h)
                if window_attention.launches != before + 1:
                    raise AssertionError(f"{name} {dtype} did not launch the kernel")
                want = window_attention_plain(x.float(), bias, mask, h)
                torch.cuda.synchronize()
                err = float((got.float() - want).abs().max())
                row = {"case": f"{name}/{'masked' if masked else 'unmasked'}/{str(dtype).replace('torch.', '')}",
                       "nWB": nWB, "N": N, "h": h, "max_abs_err": err, "tol": tol}
                if dtype == torch.bfloat16:  # the main path's dtype: time it
                    q, k, v = x.view(nWB, N, 3, h, d).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
                    am = bias[None] if mask is None else (bias[None] + mask[:, None]).repeat(
                        nWB // mask.shape[0], 1, 1, 1)
                    am = am.to(dtype)

                    def sdpa():
                        return F.scaled_dot_product_attention(q, k, v, attn_mask=am)

                    lib = sdpa().permute(0, 2, 1, 3).reshape(nWB, N, C)
                    row["library_max_abs_err"] = float((lib.float() - want).abs().max())
                    del lib
                    row["ms"] = _cuda_ms(lambda: window_attention(x, bias, mask, h), 10)
                    row["plain_ms"] = _cuda_ms(lambda: window_attention_plain(x, bias, mask, h), 10)
                    row["library_ms"] = _cuda_ms(sdpa, 10)
                    # each input read once (qkv, bias, the mask), the output
                    # written once; 4 operations per (window, head, query,
                    # key, channel): the multiply-adds of Q K^T and of P V
                    n_bytes = sum(t.numel() * t.element_size() for t in (x, bias, got))
                    n_bytes += 0 if mask is None else mask.numel() * mask.element_size()
                    row.update(_bound(n_bytes, 4 * nWB * h * N * N * d, PEAK_BF16_TENSOR_OPS_PER_S))
                    row["calls_per_forward"] = calls
                    for k_ in ("ms", "plain_ms", "library_ms", "bound_ms"):
                        per_forward[k_] += calls * row[k_]
                    per_forward["calls"] += calls
                    del q, k, v, am
                log(f"[window] {json.dumps(row)}")
                if not err <= tol:
                    raise AssertionError(f"window attention kernel disagrees with plain version: {row}")
                rows.append(row)
                if name == "stage3" and masked:
                    grad_check[row["case"]] = _window_grad_check(x, bias, mask, h, gen)
                del x, got, want
        del qkv, bias, shift_mask
        torch.cuda.empty_cache()
    if per_forward["calls"] != WINDOW_PER_FORWARD:
        raise AssertionError(
            f"{per_forward['calls']} window-attention calls a forward, expected {WINDOW_PER_FORWARD}")
    log(f"[window] per forward at bf16: {json.dumps(per_forward)}")
    log(f"[window] gradient through the kernel's autograd.Function: {json.dumps(grad_check)}")
    return rows, per_forward, grad_check


def _window_grad_check(x, bias, mask, h, gen) -> dict:
    """d(qkv, bias) through the kernel's autograd.Function against autograd
    of the plain version on the same inputs: its backward is that same
    autograd, recomputed, so within 1e-5 of max|ref| per tensor."""
    from rlipv2_tpu_torch.ops.window_attention import window_attention, window_attention_plain

    xs, bs = x.detach().requires_grad_(), bias.detach().requires_grad_()
    cot = torch.randn(x.shape[0], x.shape[1], x.shape[2] // 3, generator=gen, device=x.device).to(x.dtype)
    before = window_attention.launches
    got = torch.autograd.grad(window_attention(xs, bs, mask, h), (xs, bs), cot)
    if window_attention.launches != before + 1:
        raise AssertionError("the gradient check did not launch the kernel")
    want = torch.autograd.grad(window_attention_plain(xs, bs, mask, h), (xs, bs), cot)
    torch.cuda.synchronize()
    out = {}
    for name, g, w in zip(("dqkv", "dbias"), got, want):
        err, ref = float((g.float() - w.float()).abs().max()), float(w.float().abs().max())
        out[name] = {"max_abs_err": err, "max_abs_ref": ref}
        if not err <= 1e-5 * ref:
            raise AssertionError(f"window attention gradient disagrees on {name}: {out}")
    return out


def _grads(fn, v, loc, attn, cot):
    out = fn(v, ENC_SHAPES, loc, attn)
    return torch.autograd.grad(out, (v, loc, attn), cot)


def backward_phase() -> tuple[list[dict], dict]:
    """The backward kernel against autograd of the plain version. Returns
    the per-case rows and the timing row at the encoder shape, B = 8."""
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain
    from rlipv2_tpu_torch.tools.main_path import BATCH

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    S = sum(h * w for h, w in ENC_SHAPES)
    cases = [
        ("encoder", dict(B=2, Q=S, lo=0.0, hi=1.0)),
        ("decoder_q200", dict(B=BATCH, Q=200, lo=0.0, hi=1.0)),
        ("out_of_bounds", dict(B=2, Q=4096, lo=-0.2, hi=1.2)),
    ]
    rows = []
    for name, c in cases:
        value, loc, attn = _msda_inputs(ENC_SHAPES, c["B"], c["Q"], 8, 32, 4, c["lo"], c["hi"], gen, dev)
        if name == "decoder_q200":
            loc = _decoder_locations(c["B"], c["Q"], gen, dev)
        loc.requires_grad_()
        attn.requires_grad_()
        cot32 = torch.randn(c["B"], c["Q"], 8 * 32, generator=gen, device=dev)
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            v, cot = value.to(dtype).detach().requires_grad_(), cot32.to(dtype)
            got = _grads(ms_deform_attn, v, loc, attn, cot)
            v32 = v.detach().float().requires_grad_()
            want = _grads(ms_deform_attn_plain, v32, loc, attn, cot.float())
            torch.cuda.synchronize()
            errs = {k: float((g.float() - w).abs().max()) for k, g, w in zip(("dvalue", "dloc", "dattn"), got, want)}
            scale = {k: float(w.abs().max()) for k, w in zip(("dvalue", "dloc", "dattn"), want)}
            del got, want
            iters = 5 if c["Q"] > 1000 else 50
            ms = _cuda_ms(lambda: _grads(ms_deform_attn, v, loc, attn, cot), iters)
            plain_ms = _cuda_ms(lambda: _grads(ms_deform_attn_plain, v, loc, attn, cot), iters)
            row = {"case": f"{name}/{str(dtype).replace('torch.', '')}", "Q": c["Q"], "B": c["B"],
                   "max_abs_err": errs, "max_abs_ref": scale, "rel_tol": rel,
                   "fwd_bwd_ms": ms, "plain_fwd_bwd_ms": plain_ms}
            log(f"[backward] {json.dumps(row)}")
            for k in errs:
                if not errs[k] <= rel * scale[k]:
                    raise AssertionError(f"backward kernel disagrees with plain version on {k}: {row}")
            rows.append(row)
        del value, loc, attn, cot32, v, cot
        torch.cuda.empty_cache()

    # the backward alone at the main path's encoder shape, batch 8, bf16
    value, loc, attn = _msda_inputs(ENC_SHAPES, BATCH, S, 8, 32, 4, 0.0, 1.0, gen, dev)
    v = value.bfloat16().requires_grad_()
    loc.requires_grad_()
    attn.requires_grad_()
    cot = torch.randn(BATCH, S, 8 * 32, generator=gen, device=dev).bfloat16()
    out_k = ms_deform_attn(v, ENC_SHAPES, loc, attn)
    got = torch.autograd.grad(out_k, (v, loc, attn), cot, retain_graph=True)
    ms = _cuda_ms(lambda: torch.autograd.grad(out_k, (v, loc, attn), cot, retain_graph=True), 10)
    out_p = ms_deform_attn_plain(v, ENC_SHAPES, loc, attn)
    want = torch.autograd.grad(out_p, (v, loc, attn), cot, retain_graph=True)
    plain_ms = _cuda_ms(lambda: torch.autograd.grad(out_p, (v, loc, attn), cot, retain_graph=True), 3)
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    # each input read once (value, loc, attn, grad_out) and each output written
    # once (dvalue in the value dtype, dloc, dattn); per valid corner and
    # channel 4 operations: the product with the cotangent and its sum, the
    # scaled cotangent and its add into dvalue
    n_bytes = sum(t.numel() * t.element_size() for t in (v, loc, attn, cot, *got))
    timing = {"case": "encoder/bfloat16", "B": BATCH, "Q": S, "ms": ms, "plain_ms": plain_ms,
              "max_abs_err": err, **_bound(n_bytes, 4 * 32 * _valid_corners(ENC_SHAPES, loc))}
    log(f"[backward] alone: {json.dumps(timing)}")
    del out_k, out_p, got, want, value, loc, attn, v, cot
    torch.cuda.empty_cache()
    return rows, timing


def train_phase() -> dict:
    from rlipv2_tpu_torch.engine.loops import train_one_epoch
    from rlipv2_tpu_torch.engine.optim import param_group_name
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rlipv2_tpu_torch.ops.window_attention import window_attention
    from rlipv2_tpu_torch.tools.main_path import BATCH, BUCKET, main_train_data, main_train_step

    t0 = time.perf_counter()
    cfg, model, train_step = main_train_step("cuda")
    dataset, text_encoder = main_train_data(cfg, model, BATCH * TRAIN_STEPS)
    frozen = {k: t.detach().clone() for k, t in model.named_buffers()}
    frozen.update({k: p.detach().clone() for k, p in model.named_parameters() if not p.requires_grad})
    trainable = {k: p.detach().clone() for k, p in model.named_parameters() if p.requires_grad}
    log(f"[train] model, data and text cache ready in {time.perf_counter() - t0:.1f} s; "
        f"{len(trainable)} trainable, {len(frozen)} frozen tensors")

    steps = []

    def step_fn(batch):
        if tuple(batch.pixels.shape[1:3]) != BUCKET:
            raise AssertionError(f"train batch in bucket {tuple(batch.pixels.shape[1:3])}, not {BUCKET}")
        before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step_fn.train_step(batch)
        torch.cuda.synchronize()
        steps.append({
            "s": time.perf_counter() - t,
            "fwd": ms_deform_attn.launches - before[0],
            "bwd": ms_deform_attn.backward_launches - before[1],
            **{k: float(metrics[k]) for k in ("loss", "grad_norm", "nonfinite")},
        })
        for k, v in metrics.items():
            if not math.isfinite(float(v)):
                raise AssertionError(f"train step {len(steps)}: non-finite {k}")
        return metrics

    step_fn.train_step = train_step
    torch.cuda.reset_peak_memory_stats()
    ms_deform_attn.launches = ms_deform_attn.backward_launches = ms_deform_attn.int8_launches = 0
    window_attention.launches = 0
    _zero_msda_designs()
    t0 = time.perf_counter()
    _, stats = train_one_epoch(step_fn, model, dataset, list(range(len(dataset))), BATCH, cfg,
                               text_encoder, num_workers=2, print_freq=1)
    wall = time.perf_counter() - t0
    launches = {"fwd": ms_deform_attn.launches, "bwd": ms_deform_attn.backward_launches,
                "window": window_attention.launches, "int8": ms_deform_attn.int8_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    designs = _check_designs("train", launches["fwd"], {})

    if len(steps) != TRAIN_STEPS:
        raise AssertionError(f"{len(steps)} train steps, expected {TRAIN_STEPS}")
    per_step = [(s["fwd"], s["bwd"]) for s in steps]
    if per_step != [(MSDA_PER_FORWARD, MSDA_PER_FORWARD)] * TRAIN_STEPS or launches != {
            "fwd": MSDA_PER_FORWARD * TRAIN_STEPS, "bwd": MSDA_PER_FORWARD * TRAIN_STEPS, "window": 0, "int8": 0}:
        raise AssertionError(f"kernel launches per step {per_step}, total {launches}")
    if any(s["nonfinite"] != 0.0 for s in steps):
        raise AssertionError(f"a step skipped its update: {steps}")
    state = model.state_dict()
    changed = [k for k, v in frozen.items() if not torch.equal(state[k], v)]
    if changed:
        raise AssertionError(f"frozen tensors changed: {changed[:5]}")
    moved = {}
    for k, p in model.named_parameters():
        if p.requires_grad:
            g = param_group_name(k)
            moved[g] = moved.get(g, False) or not torch.equal(p.detach(), trainable[k])
    # the text encoder group moves only when its features are computed in
    # the graph; with cached text features it gets no gradient
    expected = {"model": True, "backbone": True, "text_encoder": False}
    if moved != expected:
        raise AssertionError(f"groups moved {moved}, expected {expected}")
    steady = [s["s"] for s in steps[1:]]  # the first step is warm-up
    result = {
        "step_p50_ms": 1000 * float(np.median(steady)),
        "img_per_s": BATCH * len(steady) / sum(steady),
        "warmup_ms": 1000 * steps[0]["s"],
        "peak_mem_gb": peak_gb,
        "train_wall_s": wall,
        "launches": launches,
        "designs": designs,
        "losses": [s["loss"] for s in steps],
        "grad_norms": [s["grad_norm"] for s in steps],
        "stats": stats,
        "groups_moved": moved,
    }
    log(f"[train] {json.dumps(result)}")
    return result


def _zero_msda_designs() -> None:
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn

    ms_deform_attn.designs.update(dict.fromkeys(ms_deform_attn.designs, 0))


@contextlib.contextmanager
def _window_launch_shapes():
    """Counts the window-attention kernel's launches inside the block by
    qkv dtype and tokens a window ("bfloat16/N144"): the kernel takes its
    tensor-core tiles for bf16 and its SIMT design for float32. Wraps the
    wrapper's launch function and counts each call of it."""
    module = importlib.import_module("rlipv2_tpu_torch.ops.window_attention")
    launch, seen = module._launch_kernel, {}

    def counted(qkv, bias, mask, h):
        key = f"{str(qkv.dtype).replace('torch.', '')}/N{qkv.shape[1]}"
        seen[key] = seen.get(key, 0) + 1
        return launch(qkv, bias, mask, h)

    module._launch_kernel = counted
    try:
        yield seen
    finally:
        module._launch_kernel = launch


def _check_designs(tag: str, msda_fwd: int, window_shapes: dict) -> dict:
    """The designs a main path's launches took, read just after it: every
    MSDA forward launch the D = 32 gather, every window-attention launch on
    bf16 windows of 144 tokens (the tensor-core tiles)."""
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn

    designs = {"msda_fwd": dict(ms_deform_attn.designs), "window": dict(window_shapes)}
    want = {"msda_fwd": {k: msda_fwd if k == MSDA_MAIN_DESIGN else 0 for k in designs["msda_fwd"]},
            "window": {k: v for k, v in window_shapes.items() if k == WINDOW_MAIN_LAUNCH}}
    if designs != want:
        raise AssertionError(f"[{tag}] kernel designs {designs}, expected {want}")
    return designs


def golden_pack_phase() -> None:
    from rlipv2_tpu_torch.tools.golden_pack import check_pack

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = check_pack(device="cuda")
    log(f"[golden] max abs delta {max(report.values()):.3g} over {len(report)} outputs (limit 2e-3)")


def main_path_phase(tag: str, builder: str, per_forward_expected: dict, **builder_kwargs):
    """`evaluate_hoi` of the model that `tools/main_path.py::<builder>`
    builds; `tag` names the path in the log and the kernels line. Every
    forward must launch the kernels `per_forward_expected` gives
    (msda_fwd, msda_int8, window) and call each int8 projection of the
    model once. Returns (result, cfg, model)."""
    from rlipv2_tpu_torch.data.synthetic import SyntheticHICODataset, hash_tokenize
    from rlipv2_tpu_torch.engine.loops import CachedTextEncoder, evaluate_hoi
    from rlipv2_tpu_torch.ops.int8_dense import Int8Linear
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rlipv2_tpu_torch.ops.window_attention import window_attention
    from rlipv2_tpu_torch.tools import main_path
    from rlipv2_tpu_torch.tools.main_path import BATCH, BUCKET

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, model = getattr(main_path, builder)(dev, **builder_kwargs)
    n_params = sum(p.numel() for p in model.parameters())
    n_int8 = sum(isinstance(m, Int8Linear) for m in model.modules())
    log(f"[{tag}] {cfg.backbone.name} model {n_params / 1e6:.1f}M params, msda_impl {cfg.transformer.msda_impl!r}, "
        f"{n_int8} int8 projections, ready in {time.perf_counter() - t0:.1f} s")
    expected = {**per_forward_expected, "int8_linear": n_int8}

    dataset = SyntheticHICODataset(BATCH * N_BATCHES, seed=0)

    def encode_fn(texts):
        ids, mask = hash_tokenize(texts, cfg.text_encoder.vocab_size, maxlen=16)
        pooled = model.encode_text(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
        return pooled.cpu().numpy()

    latencies, per_forward = [], []

    def counts():
        return {"msda_fwd": ms_deform_attn.launches, "msda_int8": ms_deform_attn.int8_launches,
                "window": window_attention.launches, "int8_linear": Int8Linear.calls}

    def apply_fn(m, pixels, valid, text_emb, text_valid, n_obj):
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = m(pixels, valid, text_emb, text_valid, n_obj)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t)
        per_forward.append({k: v - before[k] for k, v in counts().items()})
        B = pixels.shape[0]
        if tuple(out["pred_verb_logits"].shape) != (B, cfg.num_queries // 2, cfg.max_verb_texts):
            raise AssertionError(f"verb logits shape {tuple(out['pred_verb_logits'].shape)}")
        for k in ("pred_obj_logits", "pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes"):
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"non-finite {k}")
        for k in ("pred_sub_boxes", "pred_obj_boxes"):
            if not (bool((out[k] > 0).all()) and bool((out[k] < 1).all())):
                raise AssertionError(f"{k} outside (0, 1)")
        return out

    torch.cuda.reset_peak_memory_stats()
    ms_deform_attn.launches = ms_deform_attn.backward_launches = ms_deform_attn.int8_launches = 0
    window_attention.launches = Int8Linear.calls = 0
    _zero_msda_designs()
    t0 = time.perf_counter()
    with _window_launch_shapes() as window_shapes:
        stats = evaluate_hoi(apply_fn, model, dataset, cfg, CachedTextEncoder(encode_fn),
                             batch_size=BATCH, bucket=BUCKET)
    wall = time.perf_counter() - t0
    launches = {**counts(), "msda_bwd": ms_deform_attn.backward_launches}
    designs = _check_designs(tag, launches["msda_fwd"], window_shapes)
    if sum(window_shapes.values()) != launches["window"]:
        raise AssertionError(f"[{tag}] window launches {window_shapes} against the count {launches['window']}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if launches["msda_bwd"] != 0:
        raise AssertionError(f"{launches['msda_bwd']} backward launches in evaluation")
    if per_forward != [expected] * N_BATCHES or launches != {
            **{k: v * N_BATCHES for k, v in expected.items()}, "msda_bwd": 0}:
        raise AssertionError(f"launches per forward {per_forward} (expected {expected}), total {launches}")
    for k, v in stats.items():
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"HICO stat {k} = {v}")
    steady = latencies[1:]  # the first batch is warm-up
    result = {
        "backbone": cfg.backbone.name,
        "msda_impl": cfg.transformer.msda_impl,
        "int8_dense": cfg.transformer.int8_dense,
        "img_per_s": BATCH * len(steady) / sum(steady),
        "p50_ms": 1000 * float(np.median(steady)),
        "warmup_ms": 1000 * latencies[0],
        "peak_mem_gb": peak_gb,
        "eval_wall_s": wall,
        "launches": launches,
        "designs": designs,
        "per_forward": expected,
        "stats": stats,
    }
    log(f"[{tag}] {json.dumps(result)}")
    return result, cfg, model


def int8_fidelity_phase(cfg, models: dict) -> dict:
    """The exact, int8-MSDA and full-int8 R50 forwards (the same seeded
    weights) on one batch at 832x1344: max |delta| of the verb logits and
    boxes, and the canned-GT mAP protocol of `eval/int8_gate.py` as the JAX
    package's benchmark runs it (exact against each int8 path, the 1 %
    score-jitter control, the p90 relative verb-score error). Printed, not
    gated: with random weights the canned-GT mAP is noise-bound, so a
    degenerate fixture is reported, not raised."""
    from rlipv2_tpu_torch.engine.loops import SUBJECT_CATEGORY_ID
    from rlipv2_tpu_torch.eval.int8_gate import map_delta_points
    from rlipv2_tpu_torch.eval.postprocess import postprocess_hoi, to_image_results
    from rlipv2_tpu_torch.tools.main_path import BATCH, BUCKET

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    B, (H, W), T = BATCH, BUCKET, cfg.max_obj_texts + cfg.max_verb_texts
    pixels = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev)
    valid = torch.ones(B, H, W, dtype=torch.bool, device=dev)
    valid[:, 800:, :] = False
    valid[:, :, 1292:] = False
    text = torch.from_numpy(rng.randn(B, T, cfg.text_encoder.hidden_size).astype(np.float32)).to(dev)
    text_valid = torch.ones(B, T, dtype=torch.bool, device=dev)
    orig = torch.tensor([[800.0, 1292.0]] * B, device=dev)
    outs, results = {}, {}
    with torch.no_grad():
        for name, model in models.items():
            outs[name] = model(pixels, valid, text, text_valid, cfg.max_obj_texts)
            results[name] = to_image_results(postprocess_hoi(outs[name], orig), SUBJECT_CATEGORY_ID)
    nv, no = cfg.max_verb_texts, cfg.max_obj_texts

    def protocol(res):
        try:
            delta, m_e, m_q = map_delta_points(results["exact"], res, nv, no)
            return {"map_delta_points": delta, "exact_map": m_e, "quant_map": m_q}
        except AssertionError as e:  # the protocol's own degenerate-fixture check
            return {"not_measured": str(e)}

    out = {}
    jr = np.random.RandomState(5)
    jittered = [{**r, "verb_scores": np.asarray(r["verb_scores"]) * (1.0 + 0.01 * jr.randn(
        *np.asarray(r["verb_scores"]).shape))} for r in results["exact"]]
    out["score_jitter_1pct_control"] = protocol(jittered)
    for name in ("int8", "full"):
        d = {k: float((outs[name][k].float() - outs["exact"][k].float()).abs().max())
             for k in ("pred_verb_logits", "pred_sub_boxes", "pred_obj_boxes")}
        rels = np.concatenate([
            (np.abs(np.asarray(a["verb_scores"], np.float64) - np.asarray(b["verb_scores"], np.float64))
             / np.maximum(np.asarray(a["verb_scores"], np.float64), 1e-9)).ravel()
            for a, b in zip(results["exact"], results[name])])
        out[name] = {"max_abs_delta": d, "verb_score_rel_err_p90": float(np.percentile(rels, 90)),
                     **protocol(results[name])}
    log(f"[fidelity] {json.dumps(out)}")
    return out


def main() -> None:
    smi = device_phase()
    build_phase()
    cases = kernel_phase()
    int8_cases, int8_timing = int8_kernel_phase()
    window_cases, window_fwd, window_grads = window_phase()
    log(f"[quoted, not measured in this run] earlier designs' ms per call, PERF.md section 6: "
        f"{json.dumps(QUOTED_EARLIER_MS)}")
    golden_pack_phase()
    exact = {"msda_fwd": MSDA_PER_FORWARD, "msda_int8": 0, "window": 0}
    int8 = {"msda_fwd": 0, "msda_int8": MSDA_PER_FORWARD, "window": 0}
    runs, models = {}, {}
    runs["eval_r50"], cfg, models["exact"] = main_path_phase("eval_r50", "main_path_model", exact)
    runs["eval_r50_int8"], _, models["int8"] = main_path_phase("eval_r50_int8", "main_path_int8_model", int8)
    runs["eval_r50_int8_full"], _, models["full"] = main_path_phase(
        "eval_r50_int8_full", "main_path_int8_model", int8, dense=True)
    if runs["eval_r50_int8_full"]["per_forward"]["int8_linear"] == 0:
        raise AssertionError("the full int8 model has no int8 projection")
    fidelity = int8_fidelity_phase(cfg, models)
    del models
    gc.collect()  # the R50 models go before the Swin-L one is built
    torch.cuda.empty_cache()
    runs["eval_swin_l"], _, _ = main_path_phase(
        "eval_swin_l", "main_path_swin_model", {**exact, "window": WINDOW_PER_FORWARD})
    gc.collect()
    torch.cuda.empty_cache()
    bwd_cases, bwd = backward_phase()
    train = train_phase()
    enc = next(r for r in cases if r["case"] == "encoder/bfloat16")
    big = next(r for r in window_cases if r["case"] == "stage0/masked/bfloat16")

    def by_path(eval_key, train_key):
        return {**{path: run["launches"][eval_key] for path, run in runs.items()},
                "train": train["launches"][train_key]}

    # no single PyTorch call computes MSDA (grid_sample covers one level)
    rows = {
        "ms_deform_attn_fwd": dict(
            launches_by_path=by_path("msda_fwd", "fwd"), max_abs_err=enc["max_abs_err"], ms=enc["ms"],
            design=MSDA_MAIN_DESIGN,
            plain_ms=enc["plain_ms"], bound_ms=enc["bound_ms"], bound_by=enc["bound_by"],
            bound_rate=enc["bound_rate"], l2_bytes=enc["l2_bytes"], l2_ms=enc["l2_ms"],
            l2_read_rate=enc["l2_read_rate"], library_ms=None, cases=cases),
        "ms_deform_attn_bwd": dict(
            launches_by_path=by_path("msda_bwd", "bwd"), max_abs_err=bwd["max_abs_err"], ms=bwd["ms"],
            plain_ms=bwd["plain_ms"], bound_ms=bwd["bound_ms"], bound_by=bwd["bound_by"],
            bound_rate=bwd["bound_rate"], library_ms=None, cases=bwd_cases),
        # one call at the largest shape, Swin-L stage 0 with the shift mask,
        # bf16; the totals of a forward's 24 calls under per_forward
        "window_attention_fwd": dict(
            launches_by_path=by_path("window", "window"), max_abs_err=big["max_abs_err"], ms=big["ms"],
            plain_ms=big["plain_ms"], bound_ms=big["bound_ms"], bound_by=big["bound_by"],
            bound_rate=big["bound_rate"], library_ms=big["library_ms"],
            library="torch.nn.functional.scaled_dot_product_attention", per_forward=window_fwd,
            grad_check=window_grads, cases=window_cases),
        # the kernel alone on ready codes at the encoder shape, bf16; the
        # quantize pass and the whole int8 path beside it
        "ms_deform_attn_int8_fwd": dict(
            launches_by_path=by_path("msda_int8", "int8"), max_abs_err=int8_timing["max_abs_err"],
            ms=int8_timing["ms"], plain_ms=int8_timing["plain_ms"], bound_ms=int8_timing["bound_ms"],
            bound_by=int8_timing["bound_by"], bound_rate=int8_timing["bound_rate"], library_ms=None,
            quantize_ms=int8_timing["quantize_ms"], quantize_bound_ms=int8_timing["quantize_bound_ms"],
            int8_path_ms=int8_timing["int8_path_ms"], exact_kernel_ms=int8_timing["exact_kernel_ms"],
            fidelity=fidelity, cases=int8_cases),
    }
    kernels = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sum(rows[name]["launches_by_path"].values()), **rows[name]}
        for name, (src, replaces) in KERNELS.items()
    ]}
    log(smi)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
