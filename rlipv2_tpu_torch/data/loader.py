"""Prefetching batch loader (a copy of rlipv2_tpu/data/loader.py).

Worker THREADS build whole batches ahead of the training step through a
bounded in-order window, so host batch building overlaps device compute
(numpy batch packing releases the GIL; the device step is asynchronous).
Determinism: each batch gets its own `random.Random(seed(epoch,
batch_index))` stream, so results are independent of worker scheduling.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence


def batch_rng(base_seed: int, epoch: int, batch_idx: int) -> random.Random:
    """Deterministic per-batch stream independent of thread timing."""
    return random.Random(hash((base_seed, epoch, batch_idx)) & 0x7FFFFFFF)


def prefetch_map(
    fn: Callable,
    items: Iterable,
    num_workers: int,
    window: int = 4,
) -> Iterator:
    """Yield fn(item) in order with up to `window` results in flight.

    num_workers == 0 degrades to a plain map (the deterministic
    single-threaded path)."""
    if num_workers <= 0:
        for it in items:
            yield fn(it)
        return
    window = max(window, num_workers)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = []
        it = iter(items)
        try:
            for _ in range(window):
                pending.append(pool.submit(fn, next(it)))
        except StopIteration:
            it = None
        while pending:
            fut = pending.pop(0)
            if it is not None:
                try:
                    pending.append(pool.submit(fn, next(it)))
                except StopIteration:
                    it = None
            yield fut.result()
