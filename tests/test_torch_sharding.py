"""The port's model axis of sharded training against the JAX package:
  * the placement plans (`engine/train.py::fsdp_state_sharding`,
    `tp_state_sharding`, `hybrid_state_sharding`) against the JAX
    NamedSharding specs, leaf for leaf, on the tiny config with the ResNet
    and the Swin backbone, at model sizes 2 and 4, with min_size 1 << 10
    and the default. Each JAX leaf is mapped to the port tensors it
    becomes through `engine/convert.py::state_dict_from_jax`: a tree whose
    leaves hold their own flat indices, and one whose leaves hold their
    number, are converted, and the port dimension along which a JAX
    dimension's index moves is the one that JAX dimension became;
  * the sharded step: one spawn of 4 gloo ranks (data 2 x model 2) runs the
    FSDP, TP and hybrid steps (EMA on) in turn, each against the JAX
    global batch's loss and terms and against the port's 1-D data-parallel
    step on the same batch (parameters, moments and EMA gathered whole).
"""

import dataclasses
import functools
import random
from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlipv2_tpu.config import BackboneConfig
from rlipv2_tpu.config import LossConfig as JaxLossConfig
from rlipv2_tpu.config import TrainConfig as JaxTrainConfig
from rlipv2_tpu.engine.train import create_train_state
from rlipv2_tpu.engine.train import fsdp_state_sharding as jax_fsdp
from rlipv2_tpu.engine.train import hybrid_state_sharding as jax_hybrid
from rlipv2_tpu.engine.train import tp_state_sharding as jax_tp
from rlipv2_tpu.losses.criterion import SetCriterionHOI as JaxCriterion
from rlipv2_tpu.models.parseda import RLIPParSeDA as JaxRLIPParSeDA
from rlipv2_tpu.models.parseda import init_model_params
from rlipv2_tpu.parallel import create_mesh as jax_create_mesh
from rlipv2_tpu.structures import HOITargets as JaxTargets
from rlipv2_tpu_torch.data.pipeline import build_train_batch
from rlipv2_tpu_torch.engine.convert import state_dict_from_jax
from rlipv2_tpu_torch.engine.train import fsdp_state_sharding, hybrid_state_sharding, tp_state_sharding
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
from test_parseda_forward import tiny_config
from test_torch_parseda import random_params
from test_torch_train import BATCH, M, SEED, TARGET_KEYS, train_dataset
from torch_dp_ranks import PLANS, port_config, sharded_step_rank, spawn_ranks

torch.set_num_threads(2)

# port tensors the converter builds from several JAX leaves: a
# MultiheadAttention's in_proj joins the query, key and value kernels (and
# biases), which share one shape and so one JAX placement; the port splits
# the joined tensor on the dimension that placement maps to
JOINED = ("self_attn.in_proj_weight", "self_attn.in_proj_bias")


def tiny(backbone: str):
    return dataclasses.replace(tiny_config(), backbone=BackboneConfig(name=backbone, num_outputs=3))


@pytest.fixture(scope="module", params=["resnet_test", "swin_test"])
def layout(request):
    """(cfg, the port model, the JAX param shapes and train state, and for
    every converted name the (leaf number, JAX flat index) of each
    element). `jax.eval_shape` traces the init and compiles nothing."""
    cfg = tiny(request.param)
    jm = JaxRLIPParSeDA(cfg)
    T = cfg.max_obj_texts + cfg.max_verb_texts
    shapes = jax.eval_shape(lambda: init_model_params(
        jm, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 64, 64), bool),
        jnp.zeros((1, T, cfg.text_encoder.hidden_size)), jnp.ones((1, T), bool), cfg.max_obj_texts,
        jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32)))
    state = jax.eval_shape(lambda p: create_train_state(p, JaxTrainConfig(ema=True), 10)[0], shapes)
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    number = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes), [np.full(s.shape, i, np.float32) for i, (_, s) in enumerate(leaves)])
    index = jax.tree_util.tree_map(lambda s: np.arange(int(np.prod(s.shape)), dtype=np.float32).reshape(s.shape),
                                   shapes)
    by_number = state_dict_from_jax(number, cfg)
    by_index = state_dict_from_jax(index, cfg)
    moves = {k: port_dims(by_number[k].astype(np.int64), by_index[k].astype(np.int64), leaves) for k in by_number}
    return cfg, RLIPParSeDA(port_config(cfg)), leaves, state, moves


def port_dims(number, index, leaves) -> dict:
    """{leaf: [the port dimensions along which its JAX dimension j moves,
    for each j]} of one converted tensor, among the leaf's own elements."""
    out = {}
    for leaf in np.unique(number):
        mine = number == leaf
        coords = np.unravel_index(index, leaves[leaf][1].shape)
        pairs = [np.logical_and(np.delete(mine, 0, d), np.delete(mine, -1, d)) for d in range(index.ndim)]
        out[int(leaf)] = [{d for d in range(index.ndim) if np.any(np.diff(c, axis=d)[pairs[d]] != 0)}
                          for c in coords]
    return out


def path_name(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def state_shape(tree, path) -> tuple:
    """The shape of the leaf of `tree` at `path`."""
    for p, leaf in jax.tree_util.tree_leaves_with_path(tree):
        if p == path:
            return tuple(leaf.shape)
    raise KeyError(path)


def split_dim(spec):
    """The JAX dimension a spec splits over `model`, or None."""
    dims = [d for d, axis in enumerate(spec) if axis == "model"]
    assert len(dims) <= 1
    return dims[0] if dims else None


def expected_plan(specs, moves, params) -> dict:
    """{port parameter name: the dimension the JAX specs split, mapped
    through the converter}, every leaf of a tensor agreeing."""
    want = {}
    for name in params:
        got = set()
        for leaf, dims in moves[name].items():
            jdim = split_dim(specs[leaf])
            assert jdim is None or len(dims[jdim]) <= 1, (name, dims)
            # a split on a scan's layer axis (constant in the port tensor) keeps it whole
            got.add(min(dims[jdim]) if jdim is not None and dims[jdim] else None)
        assert len(got) == 1, (name, got)
        want[name] = got.pop()
    return want


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("min_size", [1 << 10, 1 << 17])
def test_plans_equal_the_jax_specs(layout, n, min_size):
    """The three port plans equal the JAX NamedSharding specs leaf for leaf
    through the converter. Every JAX leaf lands in a port parameter, except
    the ResNet's FrozenAffine scale and bias, which the port holds as
    FrozenBN buffers (outside the optimizer, whole); only the in_proj
    tensors join several leaves. The embedding tables stay whole, hybrid is
    TP where TP splits and FSDP elsewhere, the JAX AdamW moments and EMA
    follow their parameters, and the TP quirk is kept: out_v_proj and
    out_l_proj (and their biases) split column-wise."""
    cfg, model, leaves, state, moves = layout
    mesh = jax_create_mesh(8, axis_names=("data", "model"), shape=(8 // n, n))
    params = dict(model.named_parameters(remove_duplicate=False))
    assert set(params) <= set(moves)
    buffers = set(moves) - set(params)
    assert buffers == {k for k in dict(model.named_buffers()) if k in moves}
    assert all(k.startswith("backbone.0.body.") and ".bn" in k or "downsample.1." in k for k in buffers)
    joined = {k for k in params if len(moves[k]) > 1}
    assert joined and all(k.endswith(JOINED) for k in joined)
    assert {leaf for k in moves for leaf in moves[k]} == set(range(len(leaves)))

    plans = {"fsdp": (jax_fsdp(mesh, state, min_size=min_size), fsdp_state_sharding(model, n, min_size)),
             "tp": (jax_tp(mesh, state), tp_state_sharding(model, n)),
             "hybrid": (jax_hybrid(mesh, state, min_size=min_size), hybrid_state_sharding(model, n, min_size))}
    names = [path_name(p) for p, _ in leaves]
    for kind, (jax_state, port) in plans.items():
        specs = [s.spec for s in jax.tree_util.tree_leaves(jax_state.params)]
        assert set(port) == set(params), kind
        want = expected_plan(specs, moves, params)
        assert port == want, (kind, {k: (port[k], want[k]) for k in port if port[k] != want[k]})
        # the EMA follows its parameters; the JAX AdamW keeps its moments as
        # one flat vector a parameter group (optax.flatten), which the rule
        # splits on its one dimension where it can, where the port's moments
        # follow their parameters' shards (the sharded step's test)
        assert [s.spec for s in jax.tree_util.tree_leaves(jax_state.ema_params)] == specs, kind
        for path, s in jax.tree_util.tree_leaves_with_path(jax_state.opt_state):
            name, shape = path_name(path), state_shape(state.opt_state, path)
            if name.endswith(("mu", "nu")) and kind != "tp" and shape[0] >= min_size and shape[0] % n == 0:
                assert tuple(s.spec) == ("model",), (kind, name)
    fsdp, tp, hybrid = (plans[k][1] for k in ("fsdp", "tp", "hybrid"))
    assert hybrid == {k: fsdp[k] if tp[k] is None else tp[k] for k in tp}
    embeddings = [k for k in params if k.endswith("embeddings.weight")]
    assert len(embeddings) == 3 and all(fsdp[k] is None for k in embeddings)
    if min_size == 1 << 10:
        assert any(v is not None for v in fsdp.values())
    quirk = [k for k in params if ".out_v_proj." in k or ".out_l_proj." in k]
    assert quirk and all(tp[k] == 0 for k in quirk)
    tp_specs = [s.spec for s in jax.tree_util.tree_leaves(plans["tp"][0].params)]
    assert all(spec[-1] == "model" for name, spec in zip(names, tp_specs) if "/out_v_proj/" in name
               or "/out_l_proj/" in name)


# ---------------------------------------------------------------- the sharded step


def jax_losses(cfg, jm, params, arrays) -> dict:
    """The JAX loss terms and weighted total ("loss") over the batch, the
    input projections' GroupNorms taking flax's two-pass variance as
    `test_torch_train.jax_loss_and_grads` does (a forward alone: no
    gradient is compared here)."""
    crit = JaxCriterion(JaxLossConfig())
    n = cfg.max_obj_texts
    a = {k: jnp.asarray(arrays[k]) for k in ("pixels", "pixel_valid", "text_emb", "text_valid", *TARGET_KEYS)}

    def loss_fn(p, a):
        out = jm.apply(p, a["pixels"], a["pixel_valid"], a["text_emb"], a["text_valid"], n, deterministic=True)
        tv = a["text_valid"]
        losses = crit(out, JaxTargets(*(a[k] for k in TARGET_KEYS)), tv[:, :n], tv[:, n:])
        return {"loss": crit.weighted_total(losses), **losses}

    two_pass = functools.partial(flax.linen.GroupNorm, use_fast_variance=False)
    with mock.patch.object(flax.linen, "GroupNorm", two_pass):  # traced under the patch
        return {k: float(v) for k, v in jax.jit(loss_fn)(params, a).items()}


def test_sharded_steps_equal_the_data_parallel_step_and_jax(tmp_path):
    """Four gloo ranks on a (2, 2) mesh (data index r // 2, model index
    r % 2), a global batch of 2, one image a data index: the FSDP (min_size
    1 << 10, so that the tiny model splits), TP and hybrid steps, EMA on,
    clipping at the default norm. Each step's loss and every term equal the
    JAX loss over the global batch at the data-parallel test's tolerances
    (1e-4 relative); every rank reports the same metrics, the grad norm
    the 1-D data-parallel step's; the parameters, AdamW moments and EMA,
    gathered whole, equal the data-parallel step's within 1e-5 of each
    tensor's largest value (the sharded step sums each gradient twice over
    the world and halves it, the data-parallel step once: their float32
    sums round apart). On every rank each split parameter's moments and EMA
    have the shard's shape, and the optimizer holds no state of the whole
    parameter."""
    # the ranks start up while this process makes the payload, then the
    # JAX side runs while they step
    with spawn_ranks(sharded_step_rank, 4, (4, str(tmp_path)), deadline_s=150):
        cfg = tiny_config()
        jm = JaxRLIPParSeDA(cfg)
        T = cfg.max_obj_texts + cfg.max_verb_texts
        params = random_params(lambda: init_model_params(
            jm, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 64, 64), bool),
            jnp.zeros((1, T, cfg.text_encoder.hidden_size)), jnp.ones((1, T), bool), cfg.max_obj_texts,
            jnp.ones((2, 6), jnp.int32), jnp.ones((2, 6), jnp.int32)), SEED)
        ds = train_dataset()
        arrays, _, _ = build_train_batch([ds[i] for i in range(BATCH)], cfg.max_obj_texts, cfg.max_verb_texts, M,
                                         rng=random.Random(SEED))
        rng = np.random.RandomState(SEED)
        arrays["text_emb"] = rng.randn(BATCH, T, cfg.text_encoder.hidden_size).astype(np.float32)
        arrays["text_valid"] = np.concatenate([arrays["obj_text_valid"], arrays["verb_text_valid"]], 1)
        state = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state_dict_from_jax(params, cfg).items()}
        torch.save({"cfg": port_config(cfg), "state": state, "batch": arrays}, tmp_path / "payload.tmp")
        (tmp_path / "payload.tmp").rename(tmp_path / "payload.pt")
        want = jax_losses(cfg, jm, params, arrays)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(4)]
    for r, got in enumerate(ranks):
        assert got["groups"] == {"data": (r // 2, 2), "model": (r % 2, 2), "world": (r, 4), "shape": (2, 2)}
    for kind in PLANS:
        for r, got in enumerate(ranks):
            run = got[kind]
            assert run["metrics"] == ranks[0][kind]["metrics"], (kind, r)
            for k, v in want.items():
                np.testing.assert_allclose(run["metrics"][k], v, rtol=1e-4, atol=1e-6, err_msg=f"{kind} {k}")
            np.testing.assert_allclose(run["metrics"]["grad_norm"], got["dp"]["metrics"]["grad_norm"], rtol=1e-6)
            split = {k: v for k, v in run["plan"].items() if v is not None}
            assert set(run["held"]) == {k for k in run["trainable"] if k in split}
            assert len(run["held"]) > 20, kind
            for name, held in run["held"].items():
                whole = list(run["shapes"][name])
                whole[split[name]] //= 2
                assert held["shard"] == held["ema"] == tuple(whole) and not held["whole_state"], (kind, name)
                # (the verb decoder's box heads get no gradient, and so no moments)
                assert held["moments"] in ([], [tuple(whole)] * 2), (kind, name)
            assert run["keys"], kind
            assert set(run["errors"]) == {"params", "ema", "exp_avg", "exp_avg_sq"}
            for part, (err, name) in run["errors"].items():
                assert err <= 1e-5, (kind, part, name, err)

