"""Rank bodies of the port's data-parallel CPU tests and the spawner that
runs them: real gloo processes on a `file://` store under the test's
temporary directory (so parallel test workers never race for a port),
one thread a rank (two in the sharded step's four), each collective with a timeout and the whole spawn
with a join deadline. This module imports torch and the port only: a
spawned rank imports it, and JAX would cost each rank seconds."""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from pathlib import Path

import numpy as np
import torch

COLLECTIVE_TIMEOUT_S = 60.0


@contextlib.contextmanager
def spawn_ranks(fn, world: int, args: tuple, deadline_s: float):
    """fn(rank, *args) in `world` spawned processes while the block runs
    (the caller's own work overlaps them), joined when it ends: raises what
    a rank raised, or TimeoutError (killing them) `deadline_s` after the
    spawn."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        yield
    finally:
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            if time.monotonic() >= end:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks of {fn.__name__} still running after {deadline_s} s")


def join(rank: int, world: int, tmp: str):
    """One thread, the gloo group on tmp's file store, the data axis."""
    import torch.distributed as dist

    from rlipv2_tpu_torch.engine.launch import init_distributed
    from rlipv2_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    init_distributed(f"file://{Path(tmp) / 'store'}", world_size=world, rank=rank, device="cpu",
                     timeout_s=COLLECTIVE_TIMEOUT_S)
    assert (dist.get_rank(), dist.get_world_size()) == (rank, world)
    return create_mesh()


def leave() -> None:
    """Leave the group once every rank is done with it."""
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def port_config(cfg):
    """The port's config classes holding a JAX config's values."""
    import rlipv2_tpu_torch.config as pc

    if dataclasses.is_dataclass(cfg):
        return getattr(pc, type(cfg).__name__)(**{f.name: port_config(getattr(cfg, f.name))
                                                 for f in dataclasses.fields(cfg)})
    return cfg


def train_batch(arrays: dict):
    from rlipv2_tpu_torch.engine.train import TrainBatch
    from rlipv2_tpu_torch.structures import HOITargets

    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
    return TrainBatch(t["pixels"], t["pixel_valid"], t["text_emb"], t["text_valid"],
                      HOITargets(t["obj_labels"], t["sub_labels"], t["verb_labels"], t["sub_boxes"],
                                 t["obj_boxes"], t["triplet_valid"]))


# ---------------------------------------------------------------- train step


def train_step_rank(rank: int, world: int, tmp: str) -> None:
    """Rank `rank`'s slice of each of the payload's batches through the
    data-parallel step of a fresh model: step 1 (its reduced loss, terms
    and gradients saved). On the last batch then a checkpoint and step 2,
    and a fresh model restored from the checkpoint takes step 2 again."""
    from rlipv2_tpu_torch.config import LossConfig, TrainConfig
    from rlipv2_tpu_torch.engine.checkpoint import CheckpointManager, TrainState
    from rlipv2_tpu_torch.engine.optim import build_optimizer, freeze_parameters
    from rlipv2_tpu_torch.engine.train import make_train_step
    from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
    from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
    from rlipv2_tpu_torch.parallel.mesh import shard_batch

    mesh = join(rank, world, tmp)
    payload = torch.load(Path(tmp) / "payload.pt", weights_only=False)
    cfg, state = payload["cfg"], payload["state"]
    tcfg = dataclasses.replace(TrainConfig(), clip_max_norm=1e9)

    def fresh(seed: int):
        torch.manual_seed(seed)  # what the step does not broadcast would differ
        model = RLIPParSeDA(cfg)
        if rank == 0:
            model.load_state_dict(state)  # the others take rank 0's through the step's broadcast
        freeze_parameters(model)
        opt, sched = build_optimizer(model, tcfg)
        step = make_train_step(model.eval(), SetCriterionHOI(LossConfig()), opt, sched, tcfg, mesh=mesh)
        return model, TrainState(model, opt, sched, generator=step.generator, mesh=mesh), step

    out = {"first": [], "grads": [], "n_pairs": []}
    for arrays in payload["batches"]:
        batch = shard_batch(mesh, train_batch(arrays))
        model, train_state, step = fresh(1000 + rank)
        out["first"].append({k: float(v) for k, v in step(batch).items()})
        out["grads"].append({k: p.grad.detach().numpy().copy() for k, p in model.named_parameters()
                             if p.grad is not None})
        out["n_pairs"].append(int(batch.targets.valid.sum()))
    mgr = CheckpointManager(Path(tmp) / "ckpt")
    saved = mgr.save(0, train_state)
    second = step(batch)
    model_b, state_b, step_b = fresh(2000 + rank)
    mgr.restore(state_b)
    second_b = step_b(batch)
    out["resumed_equal"] = all(torch.equal(second[k], second_b[k]) for k in second) and all(
        torch.equal(p, q) for p, q in zip(model.parameters(), model_b.parameters()))
    out["second"] = {k: float(v) for k, v in second.items()}
    out["saved"] = None if saved is None else str(saved)
    torch.save(out, Path(tmp) / f"rank{rank}.pt")
    leave()


# ---------------------------------------------------------------- the sharded step


PLANS = ("fsdp", "tp", "hybrid")


def sharded_step_rank(rank: int, world: int, tmp: str) -> None:
    """On a (2, 2) mesh, two threads a rank, once the parent has written
    the payload: the 1-D data-parallel step over this rank's data group,
    then the FSDP, TP and hybrid steps, each of a fresh model from the
    payload's state (EMA on, clipping at the default norm) on the
    payload's global batch. Saves each step's metrics and plan; for each
    plan the largest difference of its parameters, AdamW moments and EMA,
    gathered whole (the checkpoint's gathers), from the data-parallel
    step's, relative to the tensor's largest value; the shapes that the
    split parameters' moments and EMA have on this rank; and the mesh's
    groups."""
    import torch.distributed as dist

    from rlipv2_tpu_torch.config import LossConfig, TrainConfig
    from rlipv2_tpu_torch.engine import train
    from rlipv2_tpu_torch.engine.launch import init_distributed
    from rlipv2_tpu_torch.engine.optim import build_optimizer, freeze_parameters
    from rlipv2_tpu_torch.losses.criterion import SetCriterionHOI
    from rlipv2_tpu_torch.models.parseda import RLIPParSeDA
    from rlipv2_tpu_torch.parallel.mesh import create_mesh, shard_batch

    torch.set_num_threads(2)
    init_distributed(f"file://{Path(tmp) / 'store'}", world_size=world, rank=rank, device="cpu",
                     timeout_s=COLLECTIVE_TIMEOUT_S)
    mesh = create_mesh(axis_names=("data", "model"), shape=(2, 2))
    payload = Path(tmp) / "payload.pt"
    end = time.monotonic() + COLLECTIVE_TIMEOUT_S
    while not payload.exists() and time.monotonic() < end:  # the parent writes it after the spawn
        time.sleep(0.1)
    payload = torch.load(payload, weights_only=False)
    cfg, state = payload["cfg"], payload["state"]
    tcfg = dataclasses.replace(TrainConfig(), ema=True)
    plans = {"dp": lambda m: None, "fsdp": lambda m: train.fsdp_state_sharding(m, 2, min_size=1 << 10),
             "tp": lambda m: train.tp_state_sharding(m, 2),
             "hybrid": lambda m: train.hybrid_state_sharding(m, 2, min_size=1 << 10)}
    out = {"groups": {"data": (mesh.data.rank, mesh.data.world), "model": (mesh.model.rank, mesh.model.world),
                      "world": (mesh.rank, mesh.world), "shape": mesh.shape}}
    whole = {}
    for kind, make_plan in plans.items():
        torch.manual_seed(rank)  # what the step does not broadcast would differ
        model = RLIPParSeDA(cfg)
        plan = make_plan(model)
        if (rank if plan is not None else mesh.data.rank) == 0:  # the others take it by the step's broadcast
            model.load_state_dict(state)
        freeze_parameters(model)
        opt, sched = build_optimizer(model, tcfg)
        step = train.make_train_step(model.eval(), SetCriterionHOI(LossConfig()), opt, sched, tcfg,
                                     mesh=mesh.data if plan is None else mesh, state_sharding=plan)
        metrics = {k: float(v) for k, v in step(shard_batch(mesh, train_batch(payload["batch"]))).items()}
        names = [k for k, p in model.named_parameters() if p.requires_grad]
        shards = step.shards
        moments = opt.state_dict() if shards is None else shards.whole_optimizer_state(opt)
        ema = step.ema_params if shards is None else shards.whole(names, step.ema_params)
        got = {**{("params", k): p.detach() for k, p in model.named_parameters()},
               **{("ema", k): e for k, e in zip(names, ema)},
               **{(m, i): v for i, st in moments["state"].items() for m, v in st.items() if v.dim()}}
        if shards is None:
            whole, out[kind] = got, {"metrics": metrics}
            continue
        errors = {}
        for key, want in whole.items():
            scale = max(float(want.abs().max()), 1e-30)
            part = errors.setdefault(key[0], (0.0, None))
            err = float((got[key] - want).abs().max()) / scale
            errors[key[0]] = max(part, (err, key[1]), key=lambda x: x[0])
        ema_of = dict(zip(names, step.ema_params))
        held = {name: {"shard": tuple(s.shape), "ema": tuple(ema_of[name].shape), "whole_state": p in opt.state,
                       "moments": [tuple(v.shape) for v in opt.state[s].values() if v.dim()]}
                for name, p, _, s in shards.split}
        out[kind] = {"metrics": metrics, "plan": plan, "held": held, "errors": errors,
                     "shapes": {k: tuple(p.shape) for k, p in model.named_parameters()}, "trainable": names,
                     "keys": sorted(map(str, got)) == sorted(map(str, whole))}
    torch.save(out, Path(tmp) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------- evaluation


class CountedVal:
    """A SyntheticHICODataset val split that records the indices read."""

    def __init__(self, **kw):
        from rlipv2_tpu_torch.data.synthetic import SyntheticHICODataset

        self.base = SyntheticHICODataset(**kw)
        self.read: list[int] = []

    def __getattr__(self, name):
        return getattr(self.base, name)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        self.read.append(int(idx))
        return self.base[idx]


def eval_rank(rank: int, world: int, tmp: str) -> None:
    """The payload's model through the sharded `evaluate_hoi` on rank
    `rank`'s shard; its stats, the images it read and the gathered
    per-image top scores saved."""
    from rlipv2_tpu_torch.engine import loops
    from rlipv2_tpu_torch.models.parseda import RLIPParSeDA

    join(rank, world, tmp)
    payload = torch.load(Path(tmp) / "payload.pt", weights_only=False)
    model = RLIPParSeDA(payload["cfg"])
    model.load_state_dict(payload["state"])
    val = CountedVal(**payload["dataset"])
    feats = payload["features"]
    text = loops.CachedTextEncoder(lambda texts: np.stack([feats[t] for t in texts]))
    top, evaluator = [], loops._run_hico_evaluator

    def recorded(dataset, preds, gts, *a):
        top.extend(float(p["verb_scores"].max()) for p in preds)
        return evaluator(dataset, preds, gts, *a)

    loops._run_hico_evaluator = recorded
    stats = loops.evaluate_hoi(lambda m, *a: m(*a), model.eval(), val, payload["cfg"], text, rank=rank,
                               world=world, **payload["eval_kw"])
    torch.save({"stats": stats, "top_scores": top, "read": val.read}, Path(tmp) / f"rank{rank}.pt")
    leave()


# ---------------------------------------------------------------- the loop


class AugmentedDataset:
    """A SyntheticHICODataset train split whose items pass through a train
    HOITransform (flip, jitter, resize, crop) drawing from `rng`, and whose
    object texts are each item's own, in an order of its own (as VG
    items' are), so that the batch's merged texts depend on every item."""

    def __init__(self, n: int, rng: random.Random):
        from rlipv2_tpu_torch.data.synthetic import SyntheticHICODataset
        from rlipv2_tpu_torch.data.transforms import HOITransform

        self.base = SyntheticHICODataset(n, min_size=(300, 300), max_size=(500, 700), n_obj_classes=6,
                                         n_verb_classes=5, seed=11, image_set="train")
        # sizes that land in several of the collate buckets
        self.transform = HOITransform(True, scales=[448, 512, 576], max_size=800, rng=rng)
        self.object_text, self.verb_text = self.base.object_text, self.base.verb_text

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        img, t = self.base[idx]
        n = len(t["obj_labels"])
        boxes = np.concatenate([t["sub_boxes"], t["obj_boxes"]]).astype(np.float32).reshape(-1, 4)
        out, moved = self.transform(torch.from_numpy(img), {"boxes": boxes, "labels": np.arange(2 * n)})
        at = {int(j): b for j, b in zip(moved["labels"], moved["boxes"])}
        keep = [j for j in range(n) if j in at and j + n in at]
        names = list(dict.fromkeys([self.object_text[0]] + [self.object_text[int(x)] for x in t["obj_labels"]]))
        extra = [self.object_text[j] for j in np.random.RandomState(idx).permutation(len(self.object_text))
                 if self.object_text[j] not in names][: idx % 3]
        texts = [str(x) for x in np.random.RandomState(100 + idx).permutation(names + extra)]
        return out.numpy(), {
            "obj_labels": np.asarray([texts.index(self.object_text[int(t["obj_labels"][j])]) for j in keep], np.int64),
            "sub_labels": np.full(len(keep), texts.index(self.object_text[0]), np.int64),
            "verb_labels": t["verb_labels"][keep].reshape(len(keep), t["verb_labels"].shape[1]),
            "sub_boxes": np.asarray([at[j] for j in keep], np.float32).reshape(-1, 4),
            "obj_boxes": np.asarray([at[j + n] for j in keep], np.float32).reshape(-1, 4),
            "obj_classes": texts,
            "verb_classes": list(self.verb_text),
        }


def loop_run(mesh, tmp: str, tag: str) -> None:
    """The payload's epoch through `train_one_epoch` with a step that
    records its batches (this rank's slice, or the one-process batch)."""
    from rlipv2_tpu_torch.engine import loops

    payload = torch.load(Path(tmp) / "loop.pt", weights_only=False)
    rng = random.Random(5)
    ds = AugmentedDataset(payload["n"], rng)
    got = []
    zero = {k: 0.0 for k in ("loss", "grad_norm", "loss_obj_ce", "loss_verb_ce")}

    def step(batch):
        got.append([{k: getattr(b, k).numpy() for k in ("pixels", "pixel_valid", "text_emb", "text_valid")}
                    | {k: getattr(b.targets, k).numpy() for k in b.targets._fields}
                    for b in (batch if isinstance(batch, list) else [batch])])
        return {k: torch.tensor(v) for k, v in zero.items()}

    rs = np.random.RandomState(0)
    feats = {}

    def encode(texts):
        return np.stack([feats.setdefault(t, rs.randn(8).astype(np.float32)) for t in texts])

    text = loops.CachedTextEncoder(encode)
    text(list(ds.object_text) + ["no objects"] + list(ds.verb_text) + ["."])
    for kw in payload["runs"]:
        loops.train_one_epoch(step, torch.nn.Linear(1, 1), ds, text_encoder=text, cfg=payload["cfg"],
                              obj_vocab=ds.object_text, verb_vocab=ds.verb_text, augment_rng=rng, mesh=mesh,
                              print_freq=100, **kw)
    torch.save(got, Path(tmp) / f"{tag}.pt")


def launch_rank(rank: int, world: int, tmp: str) -> None:
    """The loop's epoch (`loop_run`), then `cli.main` (`run_cli`) on the
    payload's commands: the data-parallel one, the same with --fsdp 2, and
    --fsdp 2 resuming the data-parallel run's checkpoint for a second
    epoch; then a global batch that does not divide over the ranks,
    refused: one spawn pays the ranks' start-up once."""
    from rlipv2_tpu_torch import cli

    mesh = join(rank, world, tmp)
    loop_run(mesh, tmp, f"loop{rank}")
    commands = torch.load(Path(tmp) / "cli.pt", weights_only=False)
    for tag, (argv, cfg, train_size, val_size) in commands.items():
        torch.save(run_cli(argv, cfg, train_size, val_size), Path(tmp) / f"{tag}{rank}.pt")
    try:
        cli.distributed(cli.get_parser().parse_args(["--device", "cpu", "--batch_size", "3"]))
        refused = None
    except ValueError as e:
        refused = str(e)
    torch.save(refused, Path(tmp) / f"refused{rank}.pt")
    leave()


# ---------------------------------------------------------------- the command line


def no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    """Every dropout of `model` off: each rank draws its own masks, so only
    a run without them can equal the one-process run number for number."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        elif isinstance(m, torch.nn.MultiheadAttention):
            m.dropout = 0.0
    return model


def run_cli(argv: list, cfg, train_size: int, val_size: int) -> dict:
    """`cli.main(argv)` on `cfg` with small HICO transforms and dropout
    off: each step's metrics, the stats, the checkpoints written and the
    number of parameters the step splits over a model axis."""
    from rlipv2_tpu_torch import cli
    from rlipv2_tpu_torch.data.transforms import HOITransform
    from rlipv2_tpu_torch.engine import loops
    from rlipv2_tpu_torch.models import factory

    steps, split = [], []
    build, train = factory.build_model, loops.train_one_epoch

    def instrumented(step_fn, *args, **kwargs):
        split.append(0 if step_fn.shards is None else len(step_fn.shards.split))

        def step(batch):
            metrics = step_fn(batch)
            steps.append({k: float(v) for k, v in metrics.items()})
            return metrics

        step.ema_params = step_fn.ema_params
        return train(step, *args, **kwargs)

    factory.build_model = lambda *a, **k: no_dropout(build(*a, **k))
    loops.train_one_epoch = instrumented
    try:
        run = cli.main(argv, model_cfg=cfg, transforms={
            "train": HOITransform(True, scales=[train_size], max_size=100, rng=random.Random(0)),
            "val": HOITransform(False, val_size=val_size, max_size=100)})
    finally:
        factory.build_model, loops.train_one_epoch = build, train
    return {"steps": steps, "stats": run.stats, "checkpoints": [str(p) for p in run.checkpoints], "split": split}
