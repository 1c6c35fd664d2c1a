"""The data axis and the (data, model) mesh (counterpart of
rlipv2_tpu/parallel/mesh.py:24-58).

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
batch order beside the train step's collectives.

`create_mesh(axis_names=("data", "model"), shape=(d, m))` is the JAX 2-D
mesh: `Mesh`, a DataParallel over the whole world (its collectives, the
evaluation's gathers, the checkpoint's random states) with one
DataParallel for each axis. Rank r sits at data index r // m and model
index r % m, as `devs.reshape(shape)` lays the JAX devices out. `data`
holds the ranks of r's model index (they read different slices of the
batch: `batch_slice` takes the data index), `model` the ranks of r's data
index (they read the same slice and split the state that a placement plan
of `engine/train.py` names: `gather_split` rebuilds a split tensor from
the model group's shards).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

# the gradient all-reduce's and the shard all-gather's bucket, in elements
# (256 MB of float32)
GRAD_BUCKET_ELEMENTS = 1 << 26


def _gather_flat(out: torch.Tensor, x: torch.Tensor, group) -> None:
    import torch.distributed as dist

    # all_gather_single where this torch has it (all_gather_into_tensor is
    # its older name); a flat output serves both backends
    fn = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    fn(out, x, group=group)


def _buckets(tensors: Sequence[torch.Tensor]):
    """Yield lists of indices into `tensors`: flat buckets of one dtype, of
    at most GRAD_BUCKET_ELEMENTS elements unless one tensor holds more."""
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for same in by_dtype.values():
        bucket, size = [], 0
        for i in same:
            if bucket and size + tensors[i].numel() > GRAD_BUCKET_ELEMENTS:
                yield bucket
                bucket, size = [], 0
            bucket.append(i)
            size += tensors[i].numel()
        if bucket:
            yield bucket


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

        for bucket in _buckets(grads):
            flat = torch.cat([grads[i].reshape(-1) for i in bucket]).to(self.device)
            dist.all_reduce(flat, group=self.group)
            start = 0
            for i in bucket:
                grads[i].copy_(flat[start : start + grads[i].numel()].view_as(grads[i]))
                start += grads[i].numel()

    def gather_split(self, shards: Sequence[torch.Tensor], dims: Sequence[int], host: bool = False):
        """Yield (i, whole) for each of `shards`: every rank's shard i
        concatenated along dims[i], in rank order, shards[i] being this
        rank's equal part. One all-gather a flat bucket of one dtype; the
        wholes lie on the collective's device, or with `host` on the CPU
        through `host_group` (a checkpoint's gather)."""
        device = torch.device("cpu") if host else self.device
        group = self.host_group if host else self.group
        for bucket in _buckets(shards):
            flat = torch.cat([shards[i].detach().reshape(-1).to(device) for i in bucket])
            out = torch.empty(self.world * flat.numel(), dtype=flat.dtype, device=device)
            _gather_flat(out, flat, group)
            out, start = out.view(self.world, -1), 0
            for i in bucket:
                n = shards[i].numel()
                yield i, torch.cat(out[:, start : start + n].unflatten(1, shards[i].shape).unbind(0), dim=dims[i])
                start += n

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `x` (detached) on every rank, on x's device."""
        import torch.distributed as dist

        y = x.detach().contiguous().to(self.device, copy=True)
        # `src` is this axis's rank; the call takes the world's
        dist.broadcast(y, src if self.group is None else dist.get_global_rank(self.group, src), group=self.group)
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


@dataclasses.dataclass
class Mesh(DataParallel):
    """One rank's view of a (data, model) mesh. As a DataParallel it is
    the whole world (the default group and a gloo host group): its
    `rank` and `world` are the world's, and so are its sums, gathers,
    broadcasts and barrier. `data` and `model` are the two axes; the batch
    is split over `data` alone (`P("data")`)."""

    shape: tuple = (1, 1)
    data: Optional[DataParallel] = None
    model: Optional[DataParallel] = None

    def batch_slice(self, n: int) -> slice:
        """The data index's contiguous share of a leading dimension of `n`:
        the ranks of one model group take the same slice."""
        return self.data.batch_slice(n)


def data_axis(mesh: Optional[DataParallel]) -> Optional[DataParallel]:
    """The data axis of `mesh`: a Mesh's `data`, a DataParallel itself."""
    return mesh.data if isinstance(mesh, Mesh) else mesh


def mesh_groups(shape: Sequence[int]) -> tuple[list, list]:
    """(data groups, model groups) of a (d, m) mesh, as lists of ranks:
    data group j holds the ranks at model index j, model group i those at
    data index i (rank r at (r // m, r % m))."""
    d, m = shape
    return [[i * m + j for i in range(d)] for j in range(m)], [[i * m + j for j in range(m)] for i in range(d)]


def create_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",), group=None,
                shape: Optional[Sequence[int]] = None) -> DataParallel:
    """The data axis over the joined process group (`engine/launch.py`
    `init_distributed` first): every rank calls it, since it makes the
    host group. `n_devices` must be the world size where given. With
    `axis_names=("data", "model")` the `Mesh` of `shape` (d, m), d * m the
    world, over the default group (default shape: (world, 1), as the JAX
    function's); every rank makes every axis group, so every rank calls it
    alike."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("create_mesh needs a joined process group: call engine/launch.py's init_distributed")
    axes = tuple(axis_names)
    if axes not in (("data",), ("data", "model")):
        raise ValueError(f"mesh axes {axes}: the port's meshes are ('data',) and ('data', 'model')")
    world = dist.get_world_size(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a data axis of {n_devices} over a process group of {world}")
    backend = str(dist.get_backend(group))
    if axes == ("data",):
        return DataParallel(rank=dist.get_rank(group), world=world, backend=backend, group=group,
                            host_group=dist.new_group(backend="gloo"))
    if group is not None:
        raise ValueError("a (data, model) mesh spans the default process group")
    shape = (world, 1) if shape is None else tuple(int(x) for x in shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"a mesh of shape {shape} over a process group of {world}")
    rank = dist.get_rank()
    axis = {}
    for name, groups, index in zip(("data", "model"), mesh_groups(shape), (rank % shape[1], rank // shape[1])):
        for i, ranks in enumerate(groups):  # every rank makes every group, in one order
            made = (dist.new_group(ranks), dist.new_group(ranks, backend="gloo"))
            if i == index:
                axis[name] = DataParallel(rank=ranks.index(rank), world=len(ranks), backend=backend, group=made[0],
                                          host_group=made[1])
    return Mesh(rank=rank, world=world, backend=backend, group=None, host_group=dist.new_group(backend="gloo"),
                shape=shape, **axis)


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
