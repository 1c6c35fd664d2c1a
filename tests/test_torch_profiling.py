"""The port's profiling hooks (`rlipv2_tpu_torch/utils/profiling.py`)
against rlipv2_tpu/utils/profiling.py: the step timer's p50 and its
waiting on a scalar, and a torch.profiler trace with a named region."""

import json

import numpy as np
import pytest
import torch

from rlipv2_tpu.utils.profiling import StepTimer as JaxStepTimer
from rlipv2_tpu_torch.utils.profiling import StepTimer, annotate, profile_trace


@pytest.mark.parametrize("times", [[], [0.3], [0.5, 0.1], [0.2, 0.9, 0.4, 0.1, 0.7]])
def test_step_timer_p50_matches_jax(times):
    got, want = StepTimer(), JaxStepTimer()
    got.times, want.times = list(times), list(times)
    assert got.p50 == want.p50


def test_step_timer_times_each_step():
    timer = StepTimer()
    for _ in range(3):
        timer.start()
        dt = timer.stop(torch.ones(()).sum())
        assert dt >= 0.0
    assert len(timer.times) == 3 and timer.p50 == sorted(timer.times)[1]


def test_profile_trace_records_the_named_region(tmp_path):
    x = torch.arange(64.0).reshape(8, 8)
    with profile_trace(str(tmp_path / "trace")) as prof:
        with annotate("matmul_region"):
            np.testing.assert_allclose((x @ x).numpy(), x.numpy() @ x.numpy())
    assert "matmul_region" in {e.key for e in prof.key_averages()}
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "matmul_region" for e in events)
    with profile_trace(str(tmp_path / "off"), enabled=False) as off:
        assert off is None
    assert not (tmp_path / "off").exists()
