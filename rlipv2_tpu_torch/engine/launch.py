"""Multi-process launch and auto-requeue (counterpart of
rlipv2_tpu/engine/launch.py; reference run_with_submitit.py:19-117 and the
torch.distributed.launch rendezvous of util/misc.py:387-417).

One process per card, started by torchrun, is the port's counterpart of
the JAX `data` mesh and of `jax.distributed`:

    python -m torch.distributed.run --nproc_per_node 8 -m rlipv2_tpu_torch.cli \\
        --batch_size 64 ...            # the global batch, 8 images a card

torchrun sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT;
`init_distributed` reads them (or takes its arguments in their place, as
the JAX function takes coordinator_address, num_processes and process_id)
and joins the process group. On several hosts torchrun's
`--nnodes/--node_rank/--master_addr` give the same variables.

`run_with_requeue` re-enters a training function after an infrastructure
failure, as the submitit `checkpoint() -> resubmit(--resume)` loop does;
as in the JAX package, the command line does not call it.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Optional, Sequence

# the process group's collective timeout when the caller gives none
DEFAULT_TIMEOUT_S = 1800.0


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    device: str = "cuda",
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> tuple[int, int]:
    """Join the process group from the arguments or torchrun's environment
    and return (rank, world). With neither (a plain `python` run) it is a
    no-op returning (0, 1), the reference's non-distributed fallback
    (util/misc.py:395-399); a group already joined returns its own.

    `init_method` defaults to "env://" (MASTER_ADDR and MASTER_PORT);
    "tcp://host:port" and "file://path" serve a caller that spawns its own
    processes. `backend` defaults to "nccl" on cuda and "gloo" on cpu. A
    cuda run binds `cuda:LOCAL_RANK`. NCCL refuses two ranks on one card:
    under "gloo" ranks may share the cards, rank i taking
    cuda:(LOCAL_RANK % cards), and the collectives then run on host
    copies."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank or 0))
    if world_size is None and init_method is None:
        return 0, 1
    if world_size is None or rank is None:
        raise ValueError(f"a distributed run needs its world size and rank (got {world_size} and {rank})")
    device = torch.device(device).type
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("a cuda run, and torch sees no CUDA device")
        if backend == "nccl" and local_rank >= cards:
            raise ValueError(f"local rank {local_rank} under nccl needs its own card, and this host has {cards}: "
                             "NCCL refuses two ranks on one card (give the gloo backend to share them)")
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def infrastructure_errors(retry_on: Sequence[type] = ()) -> tuple:
    """The exceptions `run_with_requeue` retries on: torch.distributed's
    DistError family (its backend, network and store errors, the collective
    timeouts among them), OSError and `retry_on`. A CUDA launch failure or a
    kernel's RuntimeError is not among them."""
    import torch.distributed as dist

    dist_errors = (dist.DistError,) if hasattr(dist, "DistError") else ()
    return dist_errors + (OSError,) + tuple(retry_on)


def run_with_requeue(
    train_fn: Callable[[bool], object],
    max_restarts: int = 100,
    retry_on: Sequence[type] = (),
    backoff_seconds: float = 10.0,
    logger: Optional[Callable[[str], None]] = None,
):
    """Call `train_fn(resume)` and call it again after an infrastructure
    failure (reference: run_with_submitit.py:58-68 `Trainer.checkpoint`
    resubmits with --resume). `train_fn` gets resume=False on the first
    attempt and True on every retry, when it should restore its latest
    checkpoint (engine/checkpoint.py). Only `infrastructure_errors(retry_on)`
    are retried; anything else, a kernel's RuntimeError included,
    propagates at once: a retry must never hide a fault of the program."""
    log = logger or (lambda m: print(m, flush=True))
    retried = infrastructure_errors(retry_on)
    attempt = 0
    while True:
        try:
            return train_fn(attempt > 0)
        except retried as e:
            attempt += 1
            if attempt > max_restarts:
                log(f"requeue budget exhausted after {max_restarts} restarts")
                raise
            log(f"requeue {attempt}/{max_restarts} after {type(e).__name__}: {e}")
            time.sleep(backoff_seconds)
