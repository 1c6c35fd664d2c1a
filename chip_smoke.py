"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without printing
a result; no phase catches its own failure):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; exits non-zero when torch sees no CUDA device;
  2. build: compiles the MSDA forward and backward kernels from the
     checkout's sources, one nvcc each, both started together;
  3. kernel vs plain: the kernel against `ms_deform_attn_plain` at the
     main path's encoder shape (832x1344: 4 levels, Q = S = 23205, B = 8,
     H = 8, D = 32), its decoder shape (Q = 200, 4-d anchors) and an
     out-of-bounds case (locations in [-0.2, 1.2]);
     float32 within 1e-5 and bfloat16 value within 2e-2 of the plain version
     computed in float32 from the same bf16 values; both timed with CUDA
     events;
  4. the golden pack: the reference-layout weights and inputs of
     tests/fixtures/golden_pack.npz through the port on the card (float32,
     TF32 off), within 2e-3 of the frozen reference outputs;
  5. the main path: `tools/main_path.py::main_path_model` (preset
     rlip_parseda_v2_r50 with HICO-size text slots, 81 object and 117
     verb, 12-layer RoBERTa-base, seeded random weights), bf16 autocast, through the port's `evaluate_hoi` at batch 8
     and bucket (832, 1344) over a seeded synthetic dataset of 5 batches
     (the first is warm-up). Checks finite outputs, boxes in (0, 1), 12
     kernel launches per forward and HICO stats in [0, 1]; prints img/s and
     p50 forward latency;
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

Before the main path of phase 5 and of phase 7 every launch count is set to
0, and each is read just after. The line before the last two is the card's
name and power limit, the second-to-last a JSON object {"kernels": [...]}
with each kernel's launches, error against its plain version, times and
bound, and the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
TRAIN_STEPS = 6
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "ms_deform_attn_fwd": ("rlipv2_tpu_torch/ops/csrc/ms_deform_attn_fwd.cu",
                           "rlipv2_tpu/ops/ms_deform_attn_v4.py:87"),
    "ms_deform_attn_bwd": ("rlipv2_tpu_torch/ops/csrc/ms_deform_attn_bwd.cu",
                           "rlipv2_tpu/ops/ms_deform_attn_v4.py:267"),
}
# NVIDIA H100 SXM data sheet at 700 W: HBM bandwidth, and the float32 rate
# outside the tensor cores (the MSDA kernels do scalar float32 arithmetic)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


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


def _bound(n_bytes: int, n_ops: int) -> dict:
    """Least time on the card: bytes over HBM bandwidth or float32
    operations over the non-tensor-core rate, whichever is larger."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * n_ops / PEAK_F32_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def kernel_phase() -> list[dict]:
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain
    from rlipv2_tpu_torch.tools.main_path import BATCH

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
            got = ms_deform_attn(v, ENC_SHAPES, loc, attn)
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
            log(f"[kernel] {json.dumps(row)}")
            if not err <= tol:
                raise AssertionError(f"kernel disagrees with plain version: {row}")
            results.append(row)
    return results


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
    ms_deform_attn.launches = ms_deform_attn.backward_launches = 0
    t0 = time.perf_counter()
    _, stats = train_one_epoch(step_fn, model, dataset, list(range(len(dataset))), BATCH, cfg,
                               text_encoder, num_workers=2, print_freq=1)
    wall = time.perf_counter() - t0
    launches = {"fwd": ms_deform_attn.launches, "bwd": ms_deform_attn.backward_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if len(steps) != TRAIN_STEPS:
        raise AssertionError(f"{len(steps)} train steps, expected {TRAIN_STEPS}")
    per_step = [(s["fwd"], s["bwd"]) for s in steps]
    if per_step != [(MSDA_PER_FORWARD, MSDA_PER_FORWARD)] * TRAIN_STEPS or launches != {
        "fwd": MSDA_PER_FORWARD * TRAIN_STEPS, "bwd": MSDA_PER_FORWARD * TRAIN_STEPS}:
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
        "losses": [s["loss"] for s in steps],
        "grad_norms": [s["grad_norm"] for s in steps],
        "stats": stats,
        "groups_moved": moved,
    }
    log(f"[train] {json.dumps(result)}")
    return result


def golden_pack_phase() -> None:
    from rlipv2_tpu_torch.tools.golden_pack import check_pack

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = check_pack(device="cuda")
    log(f"[golden] max abs delta {max(report.values()):.3g} over {len(report)} outputs (limit 2e-3)")


def main_path_phase() -> dict:
    from rlipv2_tpu_torch.data.synthetic import SyntheticHICODataset, hash_tokenize
    from rlipv2_tpu_torch.engine.loops import CachedTextEncoder, evaluate_hoi
    from rlipv2_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rlipv2_tpu_torch.tools.main_path import BATCH, BUCKET, main_path_model

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, model = main_path_model(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[main] model {n_params / 1e6:.1f}M params ready in {time.perf_counter() - t0:.1f} s")

    dataset = SyntheticHICODataset(BATCH * N_BATCHES, seed=0)

    def encode_fn(texts):
        ids, mask = hash_tokenize(texts, cfg.text_encoder.vocab_size, maxlen=16)
        pooled = model.encode_text(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
        return pooled.cpu().numpy()

    latencies, per_forward = [], []

    def apply_fn(m, pixels, valid, text_emb, text_valid, n_obj):
        before = ms_deform_attn.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = m(pixels, valid, text_emb, text_valid, n_obj)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t)
        per_forward.append(ms_deform_attn.launches - before)
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

    ms_deform_attn.launches = ms_deform_attn.backward_launches = 0
    t0 = time.perf_counter()
    stats = evaluate_hoi(apply_fn, model, dataset, cfg, CachedTextEncoder(encode_fn),
                         batch_size=BATCH, bucket=BUCKET)
    wall = time.perf_counter() - t0
    launches = ms_deform_attn.launches
    if ms_deform_attn.backward_launches != 0:
        raise AssertionError(f"{ms_deform_attn.backward_launches} backward launches in evaluation")

    if per_forward != [MSDA_PER_FORWARD] * N_BATCHES or launches != MSDA_PER_FORWARD * N_BATCHES:
        raise AssertionError(f"kernel launches per forward {per_forward}, total {launches}")
    for k, v in stats.items():
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"HICO stat {k} = {v}")
    steady = latencies[1:]  # the first batch is warm-up
    result = {
        "img_per_s": BATCH * len(steady) / sum(steady),
        "p50_ms": 1000 * float(np.median(steady)),
        "warmup_ms": 1000 * latencies[0],
        "eval_wall_s": wall,
        "launches": launches,
        "stats": stats,
    }
    log(f"[main] {json.dumps(result)}")
    return result


def main() -> None:
    smi = device_phase()
    build_phase()
    cases = kernel_phase()
    golden_pack_phase()
    run = main_path_phase()
    bwd_cases, bwd = backward_phase()
    train = train_phase()
    enc = next(r for r in cases if r["case"] == "encoder/bfloat16")
    rows = {
        "ms_deform_attn_fwd": dict(
            launches=train["launches"]["fwd"], launches_by_path={"eval": run["launches"], "train": train["launches"]["fwd"]},
            max_abs_err=enc["max_abs_err"], ms=enc["ms"], plain_ms=enc["plain_ms"],
            bound_ms=enc["bound_ms"], bound_by=enc["bound_by"], cases=cases),
        "ms_deform_attn_bwd": dict(
            launches=train["launches"]["bwd"], launches_by_path={"eval": 0, "train": train["launches"]["bwd"]},
            max_abs_err=bwd["max_abs_err"], ms=bwd["ms"], plain_ms=bwd["plain_ms"],
            bound_ms=bwd["bound_ms"], bound_by=bwd["bound_by"], cases=bwd_cases),
    }
    # no single PyTorch call computes MSDA (grid_sample covers one level)
    kernels = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces, "library_ms": None, **rows[name]}
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
