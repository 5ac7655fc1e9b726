"""The port's timing and profiling shims (``graphdyn_torch.utils.profiling``),
as ``tests/test_profiling.py`` holds the JAX package's: ``StepTimer`` and
``wall_clock`` measure through ``obs.timed`` (deprecated, still working, and
in the ledger while recording), ``device_trace`` writes a ``torch.profiler``
chrome trace."""

import json
import time

import pytest
import torch

from graphdyn_torch import obs
from graphdyn_torch.obs import trace
from graphdyn_torch.obs.recorder import read_ledger
from graphdyn_torch.utils.profiling import StepTimer, device_trace, wall_clock


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_step_timer_accumulates_and_rates(tmp_path):
    t = StepTimer()
    p = str(tmp_path / "run.jsonl")
    with obs.recording(p):
        with pytest.warns(DeprecationWarning):
            with t.measure(100):
                pass
        with t.measure(50):
            pass
    assert t.updates == 150 and t.seconds > 0 and t.updates_per_sec > 0
    assert StepTimer().updates_per_sec == 0.0
    spans = [e for e in read_ledger(p)[0] if e["ev"] == "span"]
    assert [s["attrs"]["n_updates"] for s in spans] == [100, 50]
    assert {s["name"] for s in spans} == {"profiling.step_timer"}


def test_wall_clock_bracket():
    with pytest.warns(DeprecationWarning):
        with wall_clock() as w:
            time.sleep(0.02)
    assert w["seconds"] >= 0.015


def test_device_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with pytest.warns(DeprecationWarning):
        with device_trace(logdir):
            with obs.span("profiling.block"):
                torch.arange(16).sum()
    (path,) = trace.trace_files(logdir)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "profiling.block" in names
