"""Float64 witness of the tiny model's train gradients in a padded bucket.

    python tests/padded_bucket_witness.py resnet_test|swin_test [--bucket 512x512] [--jax_two_pass]
        [--torch_group_norm]

Builds the tiny model of `test_torch_parseda._tiny_pair` with the backbone
named (seeded `random_params` weights, dropout off) and the train batch of
`test_torch_swin_train.py` (two 61 x 83-sized images in the bucket, by
default the CPU's 512 x 512 one, which they fill to less than 2 %), then
computes the loss's gradients three ways on the CPU:
  * the port in float32, with `--torch_group_norm` its input projections'
    GroupNorms on PyTorch's own `group_norm` (uncentred);
  * the port in float64 (default dtype float64 and `Tensor.float` taken as
    `Tensor.double` while it runs, so the model's float32 casts keep
    float64): the witness;
  * the JAX model in float32, with `--jax_two_pass` its input projections'
    GroupNorms on flax's two-pass variance (`use_fast_variance=False`).
Prints the error of the first input projection's GroupNorm on this
batch's float32 input (channels-last, as the convolution gives it) against
float64: PyTorch's `group_norm` as given and on a contiguous copy, and the
port's centred `GroupNorm`. Then the losses, and for the parameters whose
gradients part most the
error of each run against the others, each relative to the other's max|g|,
and the largest of each over all parameters whose float64 max|g| exceeds
1e-6. A departure that the float64 run shares is the function's; one that
only a float32 run shows is that run's rounding.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import random
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]  # the tests' helpers and the repository

import numpy as np  # noqa: E402
import torch  # noqa: E402


@contextlib.contextmanager
def float64_torch():
    float_, default = torch.Tensor.float, torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda self, memory_format=torch.preserve_format: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = float_
        torch.set_default_dtype(default)


def port_grads(model, arrays, dtype):
    from rlipv2_tpu_torch.config import LossConfig
    from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
    from test_torch_train import torch_batch

    model = model.to(dtype).eval()
    model.zero_grad(set_to_none=True)
    cast = {k: v.astype(np.float64) if dtype == torch.float64 and v.dtype == np.float32 else v
            for k, v in arrays.items()}
    b = torch_batch(cast)
    n = model.cfg.max_obj_texts
    crit = SetCriterionHOI(LossConfig())
    out = model(b.pixels, b.pixel_valid, b.text_emb, b.text_valid, n)
    total = crit.weighted_total(crit(out, b.targets, b.text_valid[:, :n], b.text_valid[:, n:]))
    total.backward()
    return float(total.detach()), {k: p.grad.double().numpy() for k, p in model.named_parameters()
                                   if p.grad is not None}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("backbone", choices=("resnet_test", "swin_test"))
    parser.add_argument("--bucket", default="512x512")
    parser.add_argument("--jax_two_pass", action="store_true")
    parser.add_argument("--torch_group_norm", action="store_true")
    parser.add_argument("--top", type=int, default=12)
    opts = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from rlipv2_tpu_torch.data.pipeline import build_train_batch
    from rlipv2_tpu_torch.engine.convert import state_dict_from_jax
    from test_torch_parseda import _tiny_pair
    from test_torch_train import BATCH, M, SEED, jax_loss_and_grads, train_dataset

    cfg, jm, params, _, model = _tiny_pair(opts.backbone)
    rng = np.random.RandomState(SEED)
    T = cfg.max_obj_texts + cfg.max_verb_texts
    ds = train_dataset()
    bucket = tuple(int(v) for v in opts.bucket.split("x"))
    arrays, _, _ = build_train_batch([ds[i] for i in range(BATCH)], cfg.max_obj_texts, cfg.max_verb_texts, M,
                                     rng=random.Random(SEED), bucket=bucket)
    arrays["text_emb"] = rng.randn(BATCH, T, cfg.text_encoder.hidden_size).astype(np.float32)
    arrays["text_valid"] = np.concatenate([arrays["obj_text_valid"], arrays["verb_text_valid"]], 1)
    print("bucket", arrays["pixels"].shape[1:3], "valid share", float(arrays["pixel_valid"].mean()))

    (jax_loss, _), jax_g = jax_loss_and_grads(cfg, jm, params, arrays, two_pass_group_norm=opts.jax_two_pass)
    runs = {"jax32": {k: np.asarray(v, np.float64) for k, v in state_dict_from_jax(jax_g, cfg).items()}}
    losses = {"jax32": float(jax_loss)}
    model64 = copy.deepcopy(model)
    norm, seen = model.input_proj[0][1], {}
    hook = norm.register_forward_hook(lambda m, args, out: seen.__setitem__("x", args[0].detach()))
    with contextlib.ExitStack() as stack:
        if opts.torch_group_norm:
            from rlipv2_tpu_torch.models import layers

            stack.callback(setattr, layers.GroupNorm, "forward", layers.GroupNorm.forward)
            layers.GroupNorm.forward = torch.nn.GroupNorm.forward
        losses["port32"], runs["port32"] = port_grads(model, arrays, torch.float32)
    hook.remove()
    with float64_torch():
        losses["port64"], runs["port64"] = port_grads(model64, arrays, torch.float64)
    x = seen["x"]
    w, b = norm.weight.detach(), norm.bias.detach()
    exact = torch.nn.functional.group_norm(x.double(), norm.num_groups, w.double(), b.double(), norm.eps)
    with torch.no_grad():
        for name, y in (("group_norm", torch.nn.functional.group_norm(x, norm.num_groups, w, b, norm.eps)),
                        ("group_norm on a contiguous copy",
                         torch.nn.functional.group_norm(x.contiguous(), norm.num_groups, w, b, norm.eps)),
                        ("the port's GroupNorm", norm(x))):
            err = float((y.double() - exact).abs().max() / exact.abs().max())
            print(f"input_proj.0.1 {name} (channels-last input: {x.is_contiguous(memory_format=torch.channels_last)})"
                  f": {err:.2e} of the float64 output's max")
    print("losses", losses)

    pairs = (("port32", "port64"), ("jax32", "port64"), ("port32", "jax32"))
    rows = []
    for k, w in runs["port64"].items():
        if np.abs(w).max() <= 1e-6:
            continue  # a gradient that is zero but for rounding (attention's key bias)
        rows.append((k, {f"{a}-{b}": float(np.abs(runs[a][k] - runs[b][k]).max() / np.abs(runs[b][k]).max())
                         for a, b in pairs}))
    rows.sort(key=lambda r: -max(r[1].values()))
    for k, errs in rows[:opts.top]:
        print(f"{k:64s}", "  ".join(f"{n} {v:.2e}" for n, v in errs.items()))
    for n in rows[0][1]:
        k, errs = max(rows, key=lambda r: r[1][n])
        print(f"max {n}: {errs[n]:.3e} ({k})")


if __name__ == "__main__":
    main()
