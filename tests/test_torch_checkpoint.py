"""Checkpoints and warm starts of the port, on the CPU: a save and restore
is bit-exact (model, AdamW moments, scheduler, EMA, epoch, random states),
the manager keeps the last N on its interval, two steps + save + restore +
one step equal three straight steps, also with dropout and DropPath on
(the random states travel in the checkpoint), a checkpoint without random
states still loads, `filter_query_embeddings` equals the JAX function, and
`load_reference_checkpoint` fits the query embeddings of a
reference-layout file and loads it strictly."""

import argparse
import dataclasses
import random

import numpy as np
import pytest
import torch

from rlipv2_tpu.engine.convert import filter_query_embeddings as jax_filter_query_embeddings
from rlipv2_tpu_torch.config import (BackboneConfig, FusionConfig, LossConfig, ModelConfig, TextEncoderConfig,
                                     TrainConfig, TransformerConfig)
from rlipv2_tpu_torch.data.pipeline import build_train_batch
from rlipv2_tpu_torch.data.synthetic import SyntheticHICODataset
from rlipv2_tpu_torch.engine.checkpoint import CheckpointManager, TrainState, load_checkpoint
from rlipv2_tpu_torch.engine.convert import filter_query_embeddings, load_reference_checkpoint
from rlipv2_tpu_torch.engine.optim import build_optimizer, freeze_parameters
from rlipv2_tpu_torch.engine.train import TrainBatch, make_train_step
from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
from rlipv2_tpu_torch.models.parsed import RLIPParSeD
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
from rlipv2_tpu_torch.structures import HOITargets
from rlipv2_tpu_torch.tools.main_path import random_state_dict

torch.set_num_threads(2)  # the test workers share the host's cores

CFG = ModelConfig(
    backbone=BackboneConfig(name="resnet_test", num_outputs=3),
    text_encoder=TextEncoderConfig(vocab_size=128, hidden_size=32, num_layers=1, num_heads=4,
                                   intermediate_size=64, max_position_embeddings=64),
    transformer=TransformerConfig(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=64,
                                  fusion=FusionConfig(embed_dim=64, num_heads=4)),
    num_queries=8, max_obj_texts=5, max_verb_texts=4, dtype="float32")


def batches(n, seed=0):
    ds = SyntheticHICODataset(2 * n, min_size=(40, 50), max_size=(60, 90), n_obj_classes=4, n_verb_classes=4,
                              seed=seed, image_set="train")
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        a, _, _ = build_train_batch([ds[2 * i], ds[2 * i + 1]], CFG.max_obj_texts, CFG.max_verb_texts, 4,
                                    rng=random.Random(i), bucket=(64, 96))
        t = {k: torch.from_numpy(v) for k, v in a.items()}
        text = torch.from_numpy(rng.randn(2, 9, 32).astype(np.float32))
        out.append(TrainBatch(t["pixels"], t["pixel_valid"], text,
                              torch.cat([t["obj_text_valid"], t["verb_text_valid"]], 1),
                              HOITargets(t["obj_labels"], t["sub_labels"], t["verb_labels"], t["sub_boxes"],
                                         t["obj_boxes"], t["triplet_valid"])))
    return out


def new_run(weights, ema=True):
    """A TrainState and its step over the tiny model (eval mode: no dropout)."""
    model = RLIPParSeDA(CFG)
    model.load_state_dict(weights, strict=True)
    freeze_parameters(model)
    tcfg = TrainConfig(ema=ema, ema_decay=0.5, lr_drop=1)
    opt, sched = build_optimizer(model, tcfg, steps_per_epoch=2)
    step = make_train_step(model.eval(), SetCriterionHOI(LossConfig(giou_verb_label=True)), opt, sched, tcfg)
    return TrainState(model, opt, sched, step.ema_params), step


@pytest.fixture(scope="module")
def weights():
    return random_state_dict(RLIPParSeDA(CFG))


def flat(state: dict) -> dict:
    """Every tensor and number of a nested state dict, by its path."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}/{i}", v)
        else:
            out[prefix] = x

    walk("", state)
    return out


def assert_same(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_round_trip_is_bit_exact(tmp_path, weights):
    state, step = new_run(weights)
    step(batches(1)[0])
    state.epoch = 3
    path = CheckpointManager(tmp_path).save(3, state, config=argparse.Namespace(lr=1e-4, hoi_path="x"))
    saved = torch.load(path, weights_only=True)
    assert set(saved) == {"model", "optimizer", "lr_scheduler", "epoch", "ema", "args", "rng"}
    assert saved["args"] == {"lr": 1e-4, "hoi_path": "x"} and saved["epoch"] == 3
    other, _ = new_run(weights)
    assert CheckpointManager(tmp_path).restore(other) is other
    assert_same(other.state_dict(), state.state_dict())
    assert other.epoch == 3 and other.lr_scheduler.last_epoch == 1


def test_keeps_the_last_n_on_its_interval(tmp_path, weights):
    state, _ = new_run(weights, ema=False)
    mgr = CheckpointManager(tmp_path, keep=3, save_interval=2)
    assert mgr.latest_step() is None and mgr.restore(state) is None
    written = [mgr.save(s, state) for s in range(9)]
    assert [w is not None for w in written] == [s % 2 == 0 for s in range(9)]
    assert mgr.steps() == [4, 6, 8] and mgr.latest_step() == 8
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"checkpoint000{s}.pth" for s in (4, 6, 8)]


def test_resume_equals_straight_steps(tmp_path, weights):
    """Two steps, a save, a restore into fresh objects and one more step
    give the weights, moments, EMA and learning rates of three straight
    steps, bit for bit (the learning rate drops after step 2)."""
    data = batches(3)
    straight, step = new_run(weights)
    for b in data:
        step(b)
    first, step = new_run(weights)
    for b in data[:2]:
        step(b)
    first.epoch = 0
    path = CheckpointManager(tmp_path).save(0, first)
    resumed, step = new_run(weights)
    load_checkpoint(resumed, path)
    assert resumed.lr_scheduler.last_epoch == 2
    step(data[2])
    assert_same({k: v for k, v in resumed.state_dict().items() if k != "epoch"},
                {k: v for k, v in straight.state_dict().items() if k != "epoch"})
    assert [g["lr"] for g in resumed.optimizer.param_groups] != [1e-4, 1e-5, 1e-5]


SWIN_CFG = dataclasses.replace(CFG, backbone=BackboneConfig(name="swin_test", num_outputs=3, drop_path_rate=0.2))


@pytest.fixture(scope="module")
def swin_weights():
    return random_state_dict(RLIPParSeDA(SWIN_CFG))


def new_train_run(weights):
    """A run as the command line starts one: the global generator seeded,
    the tiny Swin model (DropPath 0.2, dropout 0.1) in train mode, its step
    with its DropPath generator, and the augmentations' random.Random."""
    torch.manual_seed(0)
    model = RLIPParSeDA(SWIN_CFG)
    model.load_state_dict(weights, strict=True)
    tcfg = TrainConfig(ema=True, ema_decay=0.5, lr_drop=1, seed=3)
    opt, sched = build_optimizer(model, tcfg, steps_per_epoch=2)
    step = make_train_step(model.train(), SetCriterionHOI(LossConfig(giou_verb_label=True)), opt, sched, tcfg)
    return TrainState(model, opt, sched, step.ema_params, generator=step.generator, data_rng=random.Random(9)), step


def test_resume_keeps_the_random_streams(tmp_path, swin_weights):
    """With dropout and DropPath on, two steps, a save, a fresh start that
    restores the file and one more step give the weights, moments, EMA and
    random states of three straight steps, bit for bit; each step also
    draws from the augmentations' random.Random, as the loader does."""
    assert SWIN_CFG.transformer.dropout > 0
    data = batches(3)

    def step_and_draw(state, step, batch):
        step(batch)
        state.data_rng.random()

    straight, step = new_train_run(swin_weights)
    for b in data:
        step_and_draw(straight, step, b)
    first, step = new_train_run(swin_weights)
    for b in data[:2]:
        step_and_draw(first, step, b)
    first.epoch = 0
    path = CheckpointManager(tmp_path).save(0, first)
    resumed, step = new_train_run(swin_weights)
    load_checkpoint(resumed, path)
    assert resumed.rng_restored
    step_and_draw(resumed, step, data[2])
    assert_same({k: v for k, v in resumed.state_dict().items() if k != "epoch"},
                {k: v for k, v in straight.state_dict().items() if k != "epoch"})


TAGGER_CFG = dataclasses.replace(CFG, variant="rlip_parsed_v2", subject_class=True)


def new_tagger_run(weights):
    """An R-Tagger run as `rlipv2-torch --verb_tagger` starts one: the tiny
    RLIP-ParSeD with its tagger parameters in train mode (dropout 0.1), the
    step's generator drawing the box and label noise, the augmentations'
    random.Random and the tagger dataset's pair sampler."""
    torch.manual_seed(0)
    model = RLIPParSeD(TAGGER_CFG, tagger=True)
    model.load_state_dict(weights, strict=True)
    tcfg = TrainConfig(lr_drop=1, seed=5)
    opt, sched = build_optimizer(model, tcfg, steps_per_epoch=2)
    step = make_train_step(model.train(), SetCriterionHOI(LossConfig(verb_loss_type="bce"), subject_class=True,
                                                          tagger=True), opt, sched, tcfg, tagger=True,
                           box_noise_scale=0.6, label_noise_scale=0.3)
    return TrainState(model, opt, sched, generator=step.generator, data_rng=random.Random(9),
                      sampler_rng=random.Random(11)), step


def test_tagger_resume_equals_a_straight_run(tmp_path):
    """A tagger step, a save, a fresh start that restores the file and one
    more step give the weights, moments and random states (the noise
    generator, the augmentations' and the pair sampler's) of two straight
    steps, bit for bit; each step also draws from both random.Randoms, as
    the loader and the dataset do."""
    weights = random_state_dict(RLIPParSeD(TAGGER_CFG, tagger=True))
    data = batches(2)

    def step_and_draw(state, step, batch):
        step(batch)
        state.data_rng.random()
        state.sampler_rng.sample(range(10), 3)

    straight, step = new_tagger_run(weights)
    for b in data:
        step_and_draw(straight, step, b)
    first, step = new_tagger_run(weights)
    seeded = first.generator.get_state()
    step_and_draw(first, step, data[0])
    assert not torch.equal(first.generator.get_state(), seeded)  # the noise drew from the step's generator
    first.epoch = 0
    path = CheckpointManager(tmp_path).save(0, first)
    assert torch.load(path, weights_only=True)["rng"]["sampler"] == first.sampler_rng.getstate()
    resumed, step = new_tagger_run(weights)
    load_checkpoint(resumed, path)
    assert resumed.rng_restored and resumed.lr_scheduler.last_epoch == 1
    step_and_draw(resumed, step, data[1])
    assert_same({k: v for k, v in resumed.state_dict().items() if k != "epoch"},
                {k: v for k, v in straight.state_dict().items() if k != "epoch"})


def test_a_checkpoint_without_random_states_still_loads(tmp_path, swin_weights):
    """A file written before the random states were saved loads; the run
    keeps the states it was seeded with and says so in `rng_restored`."""
    first, step = new_train_run(swin_weights)
    step(batches(1)[0])
    state = first.state_dict()
    del state["rng"]
    torch.save(state, tmp_path / "old.pth")
    resumed, _ = new_train_run(swin_weights)
    seeded = resumed.generator.get_state()
    load_checkpoint(resumed, tmp_path / "old.pth")
    assert resumed.rng_restored is False and torch.equal(resumed.generator.get_state(), seeded)
    assert_same(resumed.model.state_dict(), first.model.state_dict())


def test_eval_restore_loads_the_model_only(tmp_path, weights):
    """An evaluation's state holds the model alone and takes it from a
    training checkpoint; a run with an EMA the file lacks raises."""
    state, step = new_run(weights, ema=False)
    step(batches(1)[0])
    path = CheckpointManager(tmp_path).save(0, state)
    model = RLIPParSeDA(CFG)
    load_checkpoint(TrainState(model), path)
    assert_same(model.state_dict(), state.model.state_dict())
    with pytest.raises(ValueError, match="EMA"):
        load_checkpoint(new_run(weights, ema=True)[0], path)


@pytest.mark.parametrize("n,num_queries", [(12, 8), (3, 8), (8, 8), (100, 200)])
def test_filter_query_embeddings_matches_jax(n, num_queries):
    rng = np.random.RandomState(n)
    tgt, ref = rng.randn(n, 6).astype(np.float32), rng.randn(n, 4).astype(np.float32)
    for got, want in zip(filter_query_embeddings(tgt, ref, num_queries),
                         jax_filter_query_embeddings(tgt, ref, num_queries)):
        assert got.shape == (num_queries, want.shape[1])
        np.testing.assert_array_equal(got, want)


def test_load_reference_checkpoint_tiles_the_queries(tmp_path, weights):
    """A reference-layout file with 4 of the model's 8 queries, its args an
    argparse Namespace as the reference pickles them: the queries are
    tiled, every other tensor loads as it is, and a stray key raises."""
    small = {k: (v[:4] if k in ("tgt_embed.weight", "verb_tgt_embed.weight", "refpoint_embed.weight") else v)
             for k, v in weights.items()}
    torch.save({"model": small, "args": argparse.Namespace(num_queries=4), "epoch": 9}, tmp_path / "ref.pth")
    model = RLIPParSeDA(CFG)
    rest = load_reference_checkpoint(model, tmp_path / "ref.pth")
    assert rest["epoch"] == 9
    got = model.state_dict()
    for k in ("tgt_embed.weight", "verb_tgt_embed.weight", "refpoint_embed.weight"):
        assert torch.equal(got[k], torch.cat([small[k], small[k]])), k
    assert torch.equal(got["bias_obj_a"], weights["bias_obj_a"])
    torch.save({"model": {**small, "stray.weight": torch.zeros(1)}}, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="stray"):
        load_reference_checkpoint(RLIPParSeDA(dataclasses.replace(CFG)), tmp_path / "bad.pth")
