"""The port's sharded evaluation against the JAX package's protocol
(`rlipv2_tpu/parallel/dist_eval.py`): the wrap-padded strided shards, the
buffer's gather and dedupe with an injected gather, the padded GT arrays;
the data axis' batch slices (`parallel/mesh.py::shard_batch`);
then two real gloo processes running the port's sharded `evaluate_hoi`
over an image count that is not a multiple of world x batch, against the
port's one-process evaluation."""

import numpy as np
import pytest
import torch

from rlipv2_tpu.parallel.dist_eval import DistEvalBuffer as JaxDistEvalBuffer
from rlipv2_tpu.parallel.dist_eval import pad_gt_arrays as jax_pad_gt_arrays
from rlipv2_tpu.parallel.dist_eval import shard_indices as jax_shard_indices
from rlipv2_tpu.parallel.dist_eval import unpack_gt_arrays as jax_unpack_gt_arrays
from rlipv2_tpu_torch.data.synthetic import SyntheticHICODataset
from rlipv2_tpu_torch.engine import loops
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
from rlipv2_tpu_torch.engine.train import TrainBatch
from rlipv2_tpu_torch.parallel import (DataParallel, DistEvalBuffer, create_mesh, pad_gt_arrays, shard_batch,
                                     shard_indices, unpack_gt_arrays)
from rlipv2_tpu_torch.structures import HOITargets
from rlipv2_tpu_torch.tools.main_path import random_state_dict
from test_parseda_forward import tiny_config
from torch_dp_ranks import eval_rank, port_config, spawn_ranks

torch.set_num_threads(2)


@pytest.mark.parametrize("n,world", [(1, 1), (7, 1), (7, 2), (8, 2), (5, 4), (3, 4), (10, 3), (16, 8)])
def test_shard_indices_match_jax(n, world):
    shards = [shard_indices(n, r, world) for r in range(world)]
    assert shards == [jax_shard_indices(n, r, world) for r in range(world)]
    assert len({len(s) for s in shards}) == 1  # one length on every rank
    assert sorted(set(i for s in shards for i in s)) == list(range(n))  # every image, wrap-padded


def _rank_trees(n, world, batch):
    """Each rank's batches of fixed-shape arrays, as the sharded loop adds
    them, with a value per image that the dedupe must keep."""
    out = []
    for r in range(world):
        idx = shard_indices(n, r, world)
        idx = [idx[j % len(idx)] for j in range(-(-len(idx) // batch) * batch)]
        out.append([(np.asarray(idx[s : s + batch]),
                     {"score": np.tile(2 * np.asarray(idx[s : s + batch], np.float32)[:, None], (1, 3)),
                      "boxes": np.tile(np.asarray(idx[s : s + batch], np.float32)[:, None, None], (1, 4, 4))})
                    for s in range(0, len(idx), batch)])
    return out


@pytest.mark.parametrize("n,world,batch", [(7, 2, 3), (9, 4, 2), (6, 3, 2)])
def test_buffer_gather_and_dedupe_match_jax(n, world, batch):
    """Every rank's buffer gathered through an injected gather (the ranks'
    local arrays stacked): the same ids and arrays as the JAX buffer's,
    every image once, in image order."""
    ranks = _rank_trees(n, world, batch)
    bufs, jax_bufs = [DistEvalBuffer() for _ in ranks], [JaxDistEvalBuffer() for _ in ranks]
    for buf, jbuf, batches in zip(bufs, jax_bufs, ranks):
        for ids, tree in batches:
            buf.add(ids, tree)
            jbuf.add(ids, tree)
    local = [b._local() for b in bufs]

    def gather(tree):
        return {k: np.stack([{"_ids": ids, **t}[k] for ids, t in local]) for k in tree}

    ids, tree = bufs[0].gather_and_dedupe(gather)
    want_ids, want = jax_bufs[0].gather_and_dedupe(gather)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(ids, np.arange(n))
    assert set(tree) == set(want)
    for k in want:
        np.testing.assert_array_equal(tree[k], want[k], err_msg=k)
    np.testing.assert_array_equal(tree["score"][:, 0], 2 * np.arange(n))


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_shard_batch_takes_the_ranks_slice(rank):
    """`shard_batch`: the rank's contiguous slice of every per-image array
    (`P("data")`), of the axis after the micro-batch axis with `axis=1`
    (`P(None, "data")`), the slot tokens whole; a batch that does not
    divide over the ranks and a model axis raise."""
    mesh = DataParallel(rank, 3)
    t = torch.arange(6 * 4).reshape(6, 4)
    batch = TrainBatch(t, t, None, t, HOITargets(t, t, t, t, t, t), torch.ones(5, 7), torch.ones(5, 7))
    got = shard_batch(mesh, batch)
    assert torch.equal(got.pixels, t[2 * rank : 2 * rank + 2]) and got.text_emb is None
    assert torch.equal(got.targets.valid, t[2 * rank : 2 * rank + 2])
    assert got.token_ids.shape == got.token_mask.shape == (5, 7)
    grouped = shard_batch(mesh, {"pixels": t.reshape(2, 3, 4)}, axis=1)["pixels"]
    assert torch.equal(grouped, t.reshape(2, 3, 4)[:, rank : rank + 1])
    with pytest.raises(ValueError, match="does not divide over 3"):
        shard_batch(mesh, {"pixels": t[:4]})
    with pytest.raises(NotImplementedError, match="item 18.2"):
        create_mesh(axis_names=("data", "model"))


def test_pad_and_unpack_gt_arrays_match_jax():
    rs = np.random.RandomState(1)
    targets = [{"boxes": rs.rand(nb, 4).astype(np.float32), "labels": rs.randint(0, 80, nb),
                "hois": rs.randint(0, 5, (nh, 3))} for nb, nh in ((3, 2), (0, 0), (7, 9), (5, 1))]
    got = pad_gt_arrays(targets, max_boxes=6, max_hois=8)
    want = jax_pad_gt_arrays(targets, max_boxes=6, max_hois=8)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for g, w in zip(unpack_gt_arrays(got), jax_unpack_gt_arrays(want)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_sharded_evaluate_hoi_equals_one_process(tmp_path):
    """Two gloo ranks run the port's `evaluate_hoi(rank=, world=2)` over 7
    images in batches of 3 (each rank scores 4 images, wrap-padded to 6):
    each rank reads its strided shard, and both get the stats and the
    per-image top scores of the one-process evaluation."""
    cfg = port_config(tiny_config())
    torch.manual_seed(0)
    model = RLIPParSeDA(cfg)
    state = random_state_dict(model)
    model.load_state_dict(state)
    dataset = dict(n_images=7, min_size=(40, 50), max_size=(60, 90), n_obj_classes=4, n_verb_classes=7, seed=5)
    val = SyntheticHICODataset(**dataset)
    rs = np.random.RandomState(0)
    texts = list(val.object_text) + ["no objects"] + list(val.verb_text)
    features = {t: rs.randn(cfg.text_encoder.hidden_size).astype(np.float32) for t in texts}
    eval_kw = dict(batch_size=3, bucket=(64, 96))
    torch.save({"cfg": cfg, "state": state, "dataset": dataset, "features": features, "eval_kw": eval_kw},
               tmp_path / "payload.pt")
    top, evaluator = [], loops._run_hico_evaluator

    def recorded(ds, preds, gts, *a):
        top.extend(float(p["verb_scores"].max()) for p in preds)
        return evaluator(ds, preds, gts, *a)

    text = loops.CachedTextEncoder(lambda ts: np.stack([features[t] for t in ts]))
    with spawn_ranks(eval_rank, 2, (2, str(tmp_path)), deadline_s=120):  # the one-process run meanwhile
        try:
            loops._run_hico_evaluator = recorded
            want = loops.evaluate_hoi(lambda m, *a: m(*a), model.eval(), val, cfg, text, **eval_kw)
        finally:
            loops._run_hico_evaluator = evaluator
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        # (two loader threads read the batches, so in no fixed order)
        assert sorted(got["read"]) == sorted(shard_indices(7, r, 2)[j % 4] for j in range(6))
        assert set(got["stats"]) == set(want)
        for k in want:
            np.testing.assert_allclose(got["stats"][k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(got["top_scores"], top, rtol=1e-5, atol=0)
