"""Kernel-only times of the MSDA backward and int8 forward at three sampling spreads, on one GPU.

    python -m rlipv2_tpu_torch.tools.msda_kernel_times [--iters 20]

At the main path's encoder shape (832x1344: 4 levels, Q = S = 23205,
batch 8, 8 heads, D = 32, 4 points, bf16) and at each spread of
`tools/msda_locations.py` (uniform, init_grid: a trained model's, tight:
the main paths' seeded random weights'), it launches each kernel straight
through the library that the wrapper loads (no wrapper, no launch count, no
autograd, no zero fill or cast) ITERS times between CUDA events:
  * backward: the D = 32 design, and the channel loop, which the library
    launches for a value that is not 16-byte aligned (a view 2 bytes into
    its buffer);
  * int8 forward: the D = 32 design, and the channel loop, for codes that
    are not 8-byte aligned.
Then both D = 32 designs at the decoder shape (Q = 200 queries around 4-d
anchors), the kernel time of the other 6 of the 12 launches a train step or
forward. Prints the card's name and power limit, then one JSON line a
spread and one for the decoder shape. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

ENC_SHAPES = ((104, 168), (52, 84), (26, 42), (13, 21))  # 832x1344 at strides 8-64


def _events_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    from rlipv2_tpu_torch.ops.ms_deform_attn import (
        _DTYPE_CODE, BWD_DESIGNS, INT8_DESIGNS, _level_geom, _load_int8_kernel, _load_kernels, quantize_value_int8)
    from rlipv2_tpu_torch.tools.main_path import gpu_name_and_power_limit
    from rlipv2_tpu_torch.tools.msda_locations import SPREADS, decoder_locations, encoder_locations

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    print(gpu_name_and_power_limit(), flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    _, bwd = _load_kernels()
    int8 = _load_int8_kernel()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, D, P = 8, 8, 32, 4
    L, S = len(ENC_SHAPES), sum(h * w for h, w in ENC_SHAPES)
    geom = _level_geom(ENC_SHAPES)
    bf16 = _DTYPE_CODE[torch.bfloat16]
    n = B * S * H * D
    # value and codes in buffers 8 elements long, so that a view 1 element in
    # is misaligned and takes the channel loop
    vbuf = torch.randn(n + 8, generator=gen, device=dev).bfloat16()
    value, value_mis = vbuf[:n].view(B, S, H, D), vbuf[1:n + 1].view(B, S, H, D)
    q8, scales = quantize_value_int8(value, ENC_SHAPES)
    qbuf = torch.empty(n + 8, dtype=torch.int8, device=dev)
    qbuf[1:n + 1] = q8.reshape(-1)
    q8_mis = qbuf[1:n + 1].view(B, S, H, D)
    attn = torch.softmax(torch.randn(B, S, H, L * P, generator=gen, device=dev), -1).view(B, S, H, L, P)
    cot = torch.randn(B, S, H * D, generator=gen, device=dev).bfloat16()
    dvalue = torch.zeros(B, S, H, D, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def bwd_launch(v, loc, attn, cot):
        """One launch of the backward; Q from loc."""
        dloc, dattn = torch.empty_like(loc), torch.empty_like(attn)

        def run():
            err = bwd.msda_bwd(v.data_ptr(), loc.data_ptr(), attn.data_ptr(), cot.data_ptr(), dvalue.data_ptr(),
                               dloc.data_ptr(), dattn.data_ptr(), bf16, B, S, loc.shape[1], H, D, L, P, geom, stream)
            if err != 0:
                raise RuntimeError(f"msda_bwd launch failed: {bwd.msda_bwd_error_string(err).decode()}")
        return run

    def int8_launch(q, loc, attn):
        out = torch.empty(B, loc.shape[1], H * D, dtype=torch.bfloat16, device=dev)

        def run():
            err = int8.msda_int8_fwd(q.data_ptr(), scales.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                                     out.data_ptr(), bf16, B, S, loc.shape[1], H, D, L, P, geom, stream)
            if err != 0:
                raise RuntimeError(f"msda_int8_fwd launch failed: {int8.msda_int8_error_string(err).decode()}")
        return run

    bwd_designs = {BWD_DESIGNS[bwd.msda_bwd_design(D, v.data_ptr(), cot.data_ptr(), dvalue.data_ptr())]: v
                   for v in (value, value_mis)}
    int8_designs = {INT8_DESIGNS[int8.msda_int8_fwd_design(D, q.data_ptr())]: q for q in (q8, q8_mis)}
    for spread in SPREADS:
        loc = encoder_locations(spread, ENC_SHAPES, B, H, P, gen).contiguous()
        row = {"spread": spread, "shape": "encoder B 8 bf16", "iters": args.iters,
               "backward_ms": {k: _events_ms(bwd_launch(v, loc, attn, cot), args.iters)
                               for k, v in bwd_designs.items()},
               "int8_ms": {k: _events_ms(int8_launch(q, loc, attn), args.iters) for k, q in int8_designs.items()}}
        print(json.dumps(row), flush=True)
        del loc

    Qd = 200
    loc = decoder_locations(B, Qd, H, L, P, gen).contiguous()
    attn, cot = attn[:, :Qd].contiguous(), cot[:, :Qd].contiguous()
    iters = 10 * args.iters
    print(json.dumps({"spread": "decoder_q200", "shape": "decoder B 8 Q 200 bf16", "iters": iters,
                      "backward_ms": {BWD_DESIGNS[1]: _events_ms(bwd_launch(value, loc, attn, cot), iters)},
                      "int8_ms": {INT8_DESIGNS[1]: _events_ms(int8_launch(q8, loc, attn), iters)}}),
          flush=True)


if __name__ == "__main__":
    main()
