"""Profiling and tracing hooks (counterpart of rlipv2_tpu/utils/profiling.py).

`profile_trace` records a `torch.profiler` trace of the enclosed steps
(CPU and, where there is one, CUDA activity) and writes it to `logdir` as
a Chrome trace, which TensorBoard's profiler plugin or chrome://tracing
reads; `annotate` names a region in it; `StepTimer` times steps on the
host clock, waiting for the device at the end of each.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """Record a torch.profiler trace of the enclosed steps into
    `logdir`/trace.json; the profiler is yielded (None when not
    `enabled`) for its `key_averages()`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not enabled:
        yield None
        return
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def annotate(name: str):
    """A named region in the trace (torch.profiler.record_function)."""
    import torch

    return torch.profiler.record_function(name)


class StepTimer:
    """Device-synchronized step timing: `stop` waits for the work queued so
    far (the JAX timer blocks on a scalar the caller passes; here a tensor
    given as `sync_scalar` is read, and the current CUDA device, if any,
    synchronized) before it reads the clock."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_scalar=None) -> float:
        import torch

        if sync_scalar is not None:
            float(sync_scalar)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def p50(self):
        s = sorted(self.times)
        return s[len(s) // 2] if s else 0.0
