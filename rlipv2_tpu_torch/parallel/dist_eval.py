"""Multi-process evaluation: a wrap-padded strided shard of the dataset a
rank, a fixed-shape all-gather of the predictions and the padded ground
truths, and the dedupe by image index (a copy of
rlipv2_tpu/parallel/dist_eval.py:31-144; reference engine.py:326-329 and
:439-453, util/misc.py:102-143).

As in the JAX design there is no pickling: every rank scores the same
number of images, padded to whole batches, so every array has the same
shape on every rank, and one all-gather an array moves them
(`default_gather`: `DataParallel.all_gather`, on CUDA tensors under nccl
and on host tensors under gloo). Wrap padding repeats images; the dedupe
keeps each image index's first occurrence. The gather function is
injectable, so the protocol is testable in one process.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np


def shard_indices(n: int, rank: int, world: int) -> list[int]:
    """Wrap-padded strided shard: every rank gets ceil(n / world) indices;
    index i of rank r is (i * world + r) mod n (torch's DistributedSampler
    padding, which the reference's post-gather dedupe undoes)."""
    if world <= 1:
        return list(range(n))
    per = math.ceil(n / world)
    return [(i * world + rank) % n for i in range(per)]


def default_gather(tree: dict, mesh=None) -> dict:
    """Every rank's equal-shape numpy arrays, each with a leading (world,)
    axis, through the data axis `mesh` (`parallel/mesh.py`; default: the
    joined process group's)."""
    from rlipv2_tpu_torch.parallel.mesh import create_mesh

    mesh = mesh or create_mesh()
    return {k: mesh.gather_numpy(np.asarray(v)) for k, v in tree.items()}


class DistEvalBuffer:
    """Accumulates fixed-shape per-batch arrays, then gathers them across
    processes and dedupes by image index. add() takes `image_idx` (B,) and
    a dict of (B, ...) arrays whose trailing shapes every batch shares."""

    def __init__(self):
        self._ids: list[np.ndarray] = []
        self._trees: list[dict] = []

    def add(self, image_idx, tree: dict):
        self._ids.append(np.asarray(image_idx, np.int32))
        self._trees.append({k: np.asarray(v) for k, v in tree.items()})

    def _local(self):
        ids = np.concatenate(self._ids, axis=0)
        tree = {k: np.concatenate([t[k] for t in self._trees], axis=0) for k in self._trees[0]}
        return ids, tree

    def gather_and_dedupe(self, gather_fn: Optional[Callable] = None) -> tuple[np.ndarray, dict]:
        """(image_idx (N,), tree of (N, ...) arrays): duplicates removed
        (the first occurrence wins) and sorted by image index, so every
        rank rebuilds the same ordered list."""
        ids, tree = self._local()
        gathered = (gather_fn or default_gather)({"_ids": ids, **tree})
        flat = {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:]) for k, v in gathered.items()}
        all_ids = flat.pop("_ids")
        _, first = np.unique(all_ids, return_index=True)
        keep = np.sort(first)
        order = np.argsort(all_ids[keep], kind="stable")
        sel = keep[order]
        return all_ids[sel], {k: v[sel] for k, v in flat.items()}


def pad_gt_arrays(targets: Sequence[dict], max_boxes: int, max_hois: int) -> dict:
    """Variable-length GT dicts as fixed-shape arrays and their counts, to
    ride the predictions' gather."""
    B = len(targets)
    boxes = np.zeros((B, max_boxes, 4), np.float32)
    labels = np.zeros((B, max_boxes), np.int32)
    n_boxes = np.zeros((B,), np.int32)
    hois = np.zeros((B, max_hois, 3), np.int32)
    n_hois = np.zeros((B,), np.int32)
    for b, t in enumerate(targets):
        tb = np.asarray(t["boxes"], np.float32).reshape(-1, 4)
        tl = np.asarray(t["labels"], np.int32).reshape(-1)
        th = np.asarray(t["hois"], np.int32).reshape(-1, 3)
        nb, nh = min(len(tb), max_boxes), min(len(th), max_hois)
        boxes[b, :nb] = tb[:nb]
        labels[b, :nb] = tl[:nb]
        n_boxes[b] = nb
        hois[b, :nh] = th[:nh]
        n_hois[b] = nh
    return {"gt_boxes": boxes, "gt_labels": labels, "gt_n_boxes": n_boxes, "gt_hois": hois, "gt_n_hois": n_hois}


def unpack_gt_arrays(tree: dict) -> list[dict]:
    """The inverse of pad_gt_arrays after the gather."""
    out = []
    for b in range(len(tree["gt_n_boxes"])):
        nb, nh = int(tree["gt_n_boxes"][b]), int(tree["gt_n_hois"][b])
        out.append({"boxes": tree["gt_boxes"][b, :nb], "labels": tree["gt_labels"][b, :nb],
                    "hois": tree["gt_hois"][b, :nh]})
    return out
