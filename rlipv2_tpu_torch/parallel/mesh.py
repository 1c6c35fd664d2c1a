"""The data-parallel axis (counterpart of rlipv2_tpu/parallel/mesh.py:24-58,
its `data` axis only).

The JAX package runs one global program over a `data` mesh: the batch is
sharded on its leading dimension (`P("data")`, `P(None, "data")` under
accumulation), the parameters and the slot tokens are replicated, and XLA
inserts the gradient all-reduce. The port runs one process per card
(`engine/launch.py`); `DataParallel` is the handle each of them holds: its
rank, the world size, the process group and the reductions the train
step, the criterion and the loops need. Everything the JAX program
computes over the global batch is then computed here from per-rank parts:

  * `batch_slice` / `shard_batch`: the rank's contiguous slice of the
    leading dimension, as `P("data")` shards it;
  * `sum`: the all-reduced sum of a per-rank count (a loss normalizer, a
    metric's numerator), with no gradient;
  * `share`: a value that every rank computes whole (a mean over its equal
    share of the batch, a metric of global counts) divided by the world
    size, so that the sum over ranks is the global value;
  * `all_gather` / `gather_numpy`: fixed-shape gathers, no pickling;
  * `all_reduce_grads`: the gradients summed over the ranks in flat
    buckets, one all-reduce a bucket.

Under "nccl" the collectives take CUDA tensors; under "gloo" (ranks that
share a card, or CPU runs) host copies. `host_group` is a second, gloo,
group for the loader's gathers of batch metadata, which its threads make in
batch order beside the train step's collectives. A `model` axis (FSDP) is
not ported: ROADMAP queue 1 item 18.2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

MODEL_AXIS_TODO = "a model axis (FSDP parameter sharding) is not ported yet: ROADMAP queue 1 item 18.2"
# the gradient all-reduce's bucket, in elements (256 MB of float32)
GRAD_BUCKET_ELEMENTS = 1 << 26


def _gather_flat(out: torch.Tensor, x: torch.Tensor, group) -> None:
    import torch.distributed as dist

    # all_gather_single where this torch has it (all_gather_into_tensor is
    # its older name); a flat output serves both backends
    fn = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    fn(out, x, group=group)


@dataclasses.dataclass
class DataParallel:
    """One rank's view of the data axis. `group` None is the default
    process group."""

    rank: int
    world: int
    backend: str = "gloo"
    group: object = None
    host_group: object = None

    @property
    def device(self) -> torch.device:
        """Where this group's collectives take their tensors."""
        return torch.device("cuda", torch.cuda.current_device()) if self.backend == "nccl" else torch.device("cpu")

    def batch_slice(self, n: int) -> slice:
        """The rank's contiguous share of a leading dimension of `n`."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not divide over {self.world} ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of `x` (detached), on x's device."""
        import torch.distributed as dist

        y = x.detach().contiguous().to(self.device, copy=True)
        dist.all_reduce(y, group=self.group)
        return y.to(x.device)

    def share(self, x: torch.Tensor) -> torch.Tensor:
        """x over the world size: the rank's share of a value that every
        rank holds whole, so that the ranks' shares sum to it."""
        return x / self.world

    def all_gather(self, x: torch.Tensor, host: bool = False) -> torch.Tensor:
        """(world, *x.shape): every rank's `x`, equal shapes on every rank,
        on x's device; `host` gathers through `host_group`."""
        device = torch.device("cpu") if host else self.device
        group = self.host_group if host else self.group
        flat = x.detach().reshape(-1).to(device, copy=True)
        out = torch.empty(self.world * flat.numel(), dtype=flat.dtype, device=device)
        _gather_flat(out, flat, group)
        return out.reshape(self.world, *x.shape).to(x.device)

    def gather_numpy(self, a: np.ndarray, host: bool = False) -> np.ndarray:
        """`all_gather` of a numpy array (bool travels as uint8)."""
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a.astype(np.uint8) if a.dtype == bool else a)
        out = self.all_gather(t, host=host).numpy()
        return out.astype(bool) if a.dtype == bool else out

    def all_reduce_grads(self, grads: Sequence[torch.Tensor]) -> None:
        """Sum `grads` over the ranks in place: flat buckets of one dtype,
        one all-reduce a bucket."""
        import torch.distributed as dist

        by_dtype: dict = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for same in by_dtype.values():
            bucket, size = [], 0
            for g in same + [None]:
                if g is not None and (not bucket or size + g.numel() <= GRAD_BUCKET_ELEMENTS):
                    bucket.append(g)
                    size += g.numel()
                    continue
                flat = torch.cat([b.reshape(-1) for b in bucket]).to(self.device)
                dist.all_reduce(flat, group=self.group)
                start = 0
                for b in bucket:
                    b.copy_(flat[start : start + b.numel()].view_as(b))
                    start += b.numel()
                bucket, size = ([g], g.numel()) if g is not None else ([], 0)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `x` (detached) on every rank, on x's device."""
        import torch.distributed as dist

        y = x.detach().contiguous().to(self.device, copy=True)
        dist.broadcast(y, src, group=self.group)
        return y.to(x.device)

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite `tensors` on every rank with rank `src`'s."""
        with torch.no_grad():
            for t in tensors:
                t.copy_(self.broadcast(t, src))

    def gather_objects(self, obj) -> list:
        """Every rank's picklable `obj`, through the host group (the
        checkpoint's random states; never on a hot path)."""
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.host_group)


def create_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",), group=None) -> DataParallel:
    """The data axis over the joined process group (`engine/launch.py`
    `init_distributed` first): every rank calls it, since it makes the
    host group. `n_devices` must be the world size where given."""
    import torch.distributed as dist

    if tuple(axis_names) != ("data",):
        raise NotImplementedError(f"mesh axes {tuple(axis_names)}: {MODEL_AXIS_TODO}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("create_mesh needs a joined process group: call engine/launch.py's init_distributed")
    world = dist.get_world_size(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a data axis of {n_devices} over a process group of {world}")
    backend = str(dist.get_backend(group))
    return DataParallel(rank=dist.get_rank(group), world=world, backend=backend, group=group,
                        host_group=dist.new_group(backend="gloo"))


def batch_sharding(mesh: DataParallel, n: int) -> slice:
    """The rank's slice of a leading (batch) dimension of `n`: `P("data")`."""
    return mesh.batch_slice(n)


def replicated_sharding(mesh: DataParallel) -> slice:
    """Every rank holds the whole: `P()`."""
    return slice(None)


# fields that every rank holds whole: the slot texts' tokens, shared by the
# batch's images (the JAX step replicates them, engine/train.py:265-276)
REPLICATED_FIELDS = ("token_ids", "token_mask")


def shard_batch(mesh: DataParallel, tree, axis: int = 0):
    """The rank's slice of every array of `tree` (a dict, list, tuple or
    NamedTuple of arrays, tensors or None) along `axis`: 0 is `P("data")`,
    1 the micro-batch axis first, `P(None, "data")`. A TrainBatch's slot
    tokens (REPLICATED_FIELDS) stay whole."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(v if f in REPLICATED_FIELDS else shard_batch(mesh, v, axis)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v, axis) for v in tree)
    index = (slice(None),) * axis + (mesh.batch_slice(tree.shape[axis]),)
    return tree[index]
