"""The port's launch helpers against `tests/test_launch.py`'s cases (the
single-process fallback, requeue with resume, the restart budget, a bug
that propagates at once), plus a kernel's RuntimeError propagating without
a retry; a data-parallel epoch: two gloo ranks' slices of every batch
(augmented items, per-item label texts, accumulation, loader threads)
equal to the one-process batches; and `cli.main` on two gloo ranks
against one process: the first step's metrics, the sharded evaluation,
and only rank 0 writing."""

import dataclasses

import numpy as np
import pytest
import torch

from rlipv2_tpu_torch.data.collate import pick_bucket
from rlipv2_tpu_torch.engine.launch import init_distributed, run_with_requeue
from test_parseda_forward import tiny_config
from rlipv2_tpu_torch.data.image_io import encode_png
from rlipv2_tpu_torch.data.text import NO_OBJ_TEXT
from rlipv2_tpu_torch.data.vocab import HICO_OBJECT_NAMES, HICO_VERB_NAMES
from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
from rlipv2_tpu_torch.tools.hico_tree import write_hico_tree, write_label_tokenizer
from rlipv2_tpu_torch.tools.main_path import random_state_dict
from torch_dp_ranks import launch_rank, loop_run, port_config, run_cli, spawn_ranks

torch.set_num_threads(2)


def test_init_distributed_single_process(monkeypatch):
    for var in ["RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"]:
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()


def test_requeue_resumes_after_failures():
    calls = []

    class Preempted(OSError):
        pass

    def train_fn(resume):
        calls.append(resume)
        if len(calls) < 3:
            raise Preempted("worker preempted")
        return "done"

    logs = []
    out = run_with_requeue(train_fn, max_restarts=5, backoff_seconds=0.0, logger=logs.append)
    assert out == "done"
    assert calls == [False, True, True]  # requeues resume from checkpoint
    assert len(logs) == 2


def test_requeue_budget_exhausted():
    def train_fn(resume):
        raise OSError("always down")

    with pytest.raises(OSError):
        run_with_requeue(train_fn, max_restarts=2, backoff_seconds=0.0, logger=lambda m: None)


def test_non_infra_errors_propagate_immediately():
    calls = []

    def train_fn(resume):
        calls.append(resume)
        raise ValueError("a bug, not an outage")

    with pytest.raises(ValueError):
        run_with_requeue(train_fn, backoff_seconds=0.0, logger=lambda m: None)
    assert calls == [False]


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("ms_deform_attn_fwd: kernel launch failed"),
])
def test_kernel_runtime_error_is_not_retried(error):
    """A plain RuntimeError (a kernel's, a CUDA launch failure) propagates
    at once; torch.distributed's DistError, a RuntimeError too, is
    retried."""
    calls = []

    def train_fn(resume):
        calls.append(resume)
        raise error

    with pytest.raises(RuntimeError, match=str(error)):
        run_with_requeue(train_fn, backoff_seconds=0.0, logger=lambda m: None)
    assert calls == [False]

    def store_lost(resume):
        calls.append(resume)
        if len(calls) < 3:
            raise torch.distributed.DistError("the store went away")
        return "done"

    assert run_with_requeue(store_lost, backoff_seconds=0.0, logger=lambda m: None) == "done"


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two gloo ranks (`torch_dp_ranks.launch_rank`): the
    loop's epochs, then `cli.main` on a HICO tree of PNGs; the same
    one-process runs meanwhile. Returns the directory of their outputs."""
    tmp = tmp_path_factory.mktemp("launch")
    cfg = port_config(dataclasses.replace(tiny_config(), max_obj_texts=9, max_verb_texts=6))
    runs = [dict(indices=list(range(8)), batch_size=4, num_workers=2, negative_text_sampling=6, epoch=1),
            dict(indices=[], batch_size=4, batch_lists=[[[0, 3, 5, 1], [2, 7, 4, 6]]], accumulation_steps=2,
                 negative_text_sampling=6, epoch=2)]
    torch.save({"cfg": cfg, "n": 8, "runs": runs}, tmp / "loop.pt")

    rs = np.random.RandomState(0)
    images = []
    for i, (h, w) in enumerate([(48, 64), (64, 48), (40, 60), (56, 72)]):
        (tmp / f"img{i}.png").write_bytes(encode_png(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)))
        images.append((tmp / f"img{i}.png", h, w))
    write_hico_tree(tmp / "hico", images * 2, images[:3], seed=0)
    write_label_tokenizer(tmp / "tok", list(HICO_OBJECT_NAMES) + [NO_OBJ_TEXT] + list(HICO_VERB_NAMES) + ["."])
    tiny = port_config(tiny_config())
    cli_cfg = dataclasses.replace(tiny, num_queries=8, max_obj_texts=81, max_verb_texts=117,
                                  text_encoder=dataclasses.replace(tiny.text_encoder, vocab_size=512))
    torch.save({"model": random_state_dict(RLIPParSeDA(cli_cfg))}, tmp / "pretrained.pth")

    def argv(out):
        return ["--device", "cpu", "--hoi_path", str(tmp / "hico"), "--tokenizer_dir", str(tmp / "tok"),
                "--pretrained", str(tmp / "pretrained.pth"), "--batch_size", "2", "--epochs", "1",
                "--max_steps", "1", "--giou_verb_label", "--pseudo_verb", "--triplet_filtering",
                "--negative_text_sampling", "500", "--use_nms_filter", "--print_freq", "10", "--output_dir", str(tmp / out)]

    torch.save((argv("dp"), cli_cfg, 64, 64), tmp / "cli.pt")
    with spawn_ranks(launch_rank, 2, (2, str(tmp)), deadline_s=180):
        # the one-process runs meanwhile, on one thread, as each rank has:
        # the pseudo-verb threshold and the triplet filter are
        # discontinuous, and another thread count's float noise can flip a
        # pseudo label (a 2e-4 change of loss_verb_ce here)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            loop_run(None, str(tmp), "loop_one")
            torch.save(run_cli(argv("one"), cli_cfg, 64, 64), tmp / "cli_one.pt")
        finally:
            torch.set_num_threads(threads)
    return tmp


def test_data_parallel_epoch_slices_the_one_process_batches(two_ranks):
    """Two gloo ranks run `train_one_epoch(mesh=...)` over items that a
    train HOITransform augments from one stream, whose object texts are
    each item's own and in its own order, with negatives, two loader
    threads, a plain epoch and an accumulated one: each rank's batches are
    its contiguous slice of the one-process batches, pixels, padding,
    text slots, features and targets, bit for bit. A global batch that does
    not divide over the ranks is refused."""
    tmp = two_ranks
    one = torch.load(tmp / "loop_one.pt", weights_only=False)
    ranks = [torch.load(tmp / f"loop{r}.pt", weights_only=False) for r in range(2)]
    assert len(one) == len(ranks[0]) == len(ranks[1]) == 3
    own_buckets_differ = False
    for step, (whole, *parts) in enumerate(zip(one, *ranks)):
        for m, micro in enumerate(whole):
            for r, part in enumerate(parts):
                for k, v in micro.items():
                    np.testing.assert_array_equal(part[m][k], v[2 * r : 2 * r + 2], err_msg=f"{step} {m} {r} {k}")
            # a half padded to its own images' bucket would differ from the batch's
            hw = [np.argwhere(micro["pixel_valid"][b]).max(0) + 1 for b in range(4)]
            own = [pick_bucket(*np.max(hw[2 * r : 2 * r + 2], axis=0)) for r in range(2)]
            own_buckets_differ |= own[0] != own[1]
    assert own_buckets_differ
    for r in range(2):
        refused = torch.load(tmp / f"refused{r}.pt")
        assert refused is not None and "--batch_size 3" in refused and "world size 2" in refused


def test_cli_on_two_ranks_equals_one_process(two_ranks):
    """`cli.main` (HICO fine-tune with RPL, online pseudo verbs, the triplet
    filter, negatives, in-graph text training) on two gloo ranks, a global batch of 2: the
    first step's loss, terms and gradient norm equal the one-process run's
    on the same batch (dropout off in both: each rank draws its own
    masks), both ranks get the one-process evaluation's stats from the
    sharded evaluation of 3 images (wrap-padded), and rank 0 alone writes
    the checkpoint and the log line."""
    tmp = two_ranks
    one = torch.load(tmp / "cli_one.pt", weights_only=False)
    ranks = [torch.load(tmp / f"cli{r}.pt", weights_only=False) for r in range(2)]
    assert len(one["steps"]) == 1
    for got in ranks:
        assert len(got["steps"]) == 1 and set(got["steps"][0]) == set(one["steps"][0])
        for k, v in one["steps"][0].items():
            np.testing.assert_allclose(got["steps"][0][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
        assert set(got["stats"]) == set(one["stats"])
        for k, v in one["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, rtol=1e-6, atol=1e-9, err_msg=k)
    assert ranks[0]["checkpoints"] == [str(tmp / "dp" / "ckpt" / "checkpoint0000.pth")]
    assert ranks[1]["checkpoints"] == []
    assert len((tmp / "dp" / "log.txt").read_text().splitlines()) == 1
