"""The Swin training path against the JAX package, float32 on the CPU.

  * The train step of the tiny model with the `swin_test` backbone (its
    blocks and PatchMerging in the graph, seeded params from
    `random_params`, dropout and DropPath off) in the CPU's default 512 x
    512 bucket, which these images fill to less than 2 %: the port's
    `make_train_step` gives the loss of `jax.value_and_grad` of the JAX
    model within rtol 1e-4 and leaves in every trainable parameter's
    `.grad` the JAX gradient, within 1e-3 * max|g| + 1e-6 (the R50 tests'
    limits and their two-pass JAX GroupNorm, `test_torch_train.py`).
  * The freeze rules: for the tiny R50 and Swin models and each
    `freeze_regime` (none, frozen_vision, unfrozen_params,
    frozen_detection), the parameters the port trains and each one's group
    (backbone / text_encoder / model) equal the labels of the JAX
    `build_optimizer`, read from one update of it (ones for gradients, a
    learning rate of its own for each group, no weight decay: a frozen leaf
    moves 0, every other one its group's learning rate) mapped through
    `state_dict_from_jax`. One difference is known and asserted exactly:
    the JAX rule also freezes `conv1` of ResNet blocks 0-9 of layers 2-4
    (ROADMAP queue 3), which the reference and the port train.
"""

import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlipv2_tpu.config import TrainConfig as JaxTrainConfig
from rlipv2_tpu.engine.optim import build_optimizer as jax_build_optimizer
from rlipv2_tpu_torch.config import LossConfig, TrainConfig
from rlipv2_tpu_torch.engine.convert import state_dict_from_jax
from rlipv2_tpu_torch.engine.optim import FREEZE_REGIMES, build_optimizer, freeze_parameters
from rlipv2_tpu_torch.engine.train import make_train_step
from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
from rlipv2_tpu_torch.data.pipeline import build_train_batch
from test_parseda_forward import tiny_config
from test_torch_parseda import _tiny_pair
from test_torch_train import BATCH, M, SEED, jax_loss_and_grads, torch_batch, train_dataset

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

LRS = {"model": 1e-4, "backbone": 2e-5, "text_encoder": 3e-5}
REGIMES = (None,) + FREEZE_REGIMES
# the JAX `_param_group` also freezes conv1 of the first ten blocks of
# ResNet layers 2-4 ("conv1" within 20 characters of "backbone")
JAX_ONLY_FROZEN = re.compile(r"backbone\.0\.body\.layer[234]\.\d\.conv1\.weight")


@pytest.fixture(scope="module", params=["resnet_test", "swin_test"])
def jax_updates(request):
    """(cfg, {regime: the JAX update as a reference-key state dict}) for
    the tiny model with one backbone; one jitted call for the four."""
    cfg, _, params, _, _ = _tiny_pair(request.param)
    p = params["params"]
    txs = [jax_build_optimizer(JaxTrainConfig(lr=LRS["model"], lr_backbone=LRS["backbone"],
                                              lr_text_encoder=LRS["text_encoder"], weight_decay=0.0,
                                              freeze_regime=regime), p) for regime in REGIMES]
    ones = jax.tree_util.tree_map(jnp.ones_like, p)
    updates = jax.jit(lambda g, q: [tx.update(g, tx.init(q), q)[0] for tx in txs])(ones, p)
    return cfg, {regime: state_dict_from_jax(u, cfg) for regime, u in zip(REGIMES, updates)}


@pytest.fixture(scope="module")
def swin_pair():
    return _tiny_pair("swin_test")


def test_swin_train_step_matches_jax(swin_pair):
    cfg, jm, params, _, model = swin_pair
    rng = np.random.RandomState(SEED)
    T = cfg.max_obj_texts + cfg.max_verb_texts
    ds = train_dataset()
    arrays, _, _ = build_train_batch([ds[i] for i in range(BATCH)], cfg.max_obj_texts, cfg.max_verb_texts, M,
                                     rng=random.Random(SEED))
    assert arrays["pixels"].shape[1:3] == (512, 512) and arrays["pixel_valid"].mean() < 0.02
    arrays["text_emb"] = rng.randn(BATCH, T, cfg.text_encoder.hidden_size).astype(np.float32)
    arrays["text_valid"] = np.concatenate([arrays["obj_text_valid"], arrays["verb_text_valid"]], 1)
    (want_total, _), jax_grads = jax_loss_and_grads(cfg, jm, params, arrays)
    want = state_dict_from_jax(jax_grads, cfg)

    tcfg = TrainConfig(clip_max_norm=1e9)
    opt, sched = build_optimizer(model, tcfg)
    step = make_train_step(model.eval(), SetCriterionHOI(LossConfig()), opt, sched, tcfg)
    got = step(torch_batch(arrays))
    assert float(got["nonfinite"]) == 0.0
    np.testing.assert_allclose(float(got["loss"]), float(want_total), rtol=1e-4, atol=0)
    checked = 0
    for name, p in model.named_parameters():
        assert p.requires_grad, name  # nothing of a Swin backbone is frozen
        w = want[name]
        if p.grad is None:  # the text encoder on the cached-text path, the verb decoder's box heads
            assert not np.any(w), name
            continue
        tol = 1e-3 * float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(p.grad.numpy(), w, atol=tol, rtol=0, err_msg=name)
        checked += name.startswith("backbone.")
    assert checked == sum(1 for k, _ in model.named_parameters() if k.startswith("backbone."))


@pytest.mark.parametrize("regime", REGIMES)
def test_trainable_parameters_and_groups_match_jax(jax_updates, regime):
    cfg, all_updates = jax_updates
    updates = all_updates[regime]
    by_lr = {lr: group for group, lr in LRS.items()}

    def jax_label(name):
        u = -updates[name]
        if not np.any(u):
            return "frozen"
        lr = min(LRS.values(), key=lambda v: abs(v - float(u.mean())))
        np.testing.assert_allclose(u, lr, rtol=1e-3, err_msg=name)
        return by_lr[lr]

    model = RLIPParSeDA(cfg)
    opt, _ = build_optimizer(model, TrainConfig(freeze_regime=regime))
    group_of = {id(q): g["name"] for g in opt.param_groups for q in g["params"]}
    got = {k: group_of.get(id(q), "frozen") for k, q in model.named_parameters()}
    assert all((got[k] == "frozen") == (not q.requires_grad) for k, q in model.named_parameters())
    want = {k: jax_label(k) for k in got}
    differ = {k for k in got if got[k] != want[k]}
    if cfg.backbone.name.startswith("resnet"):
        known = {k for k in got if JAX_ONLY_FROZEN.fullmatch(k) and got[k] == "backbone"}
        assert all(want[k] == "frozen" for k in known)
        assert known or regime in ("unfrozen_params", "frozen_detection")
    else:
        known = set()
    assert differ == known, {k: (got[k], want[k]) for k in differ}
    assert {"backbone", "model", "text_encoder", "frozen"} >= set(got.values())
    if regime == "unfrozen_params":
        assert {g for k, g in got.items()} == {"text_encoder", "frozen"}


def test_freeze_parameters_rejects_an_unknown_regime():
    model = RLIPParSeDA(tiny_config())
    with pytest.raises(ValueError, match="freeze_regime"):
        freeze_parameters(model, "frozen_everything")
