"""The port's device-side telemetry, as ``tests/test_obs_device.py`` holds the
JAX package's: the ``torch.profiler`` capture whose ranges carry the
ledger's span name paths, the memory gauges and memcheck rows (null plus a
reason off the card), and the always-on flight recorder: its bounded ring,
``GRAPHDYN_FLIGHT=0``, and the post-mortems of an unhandled exception, a
preemption (exit 75) and a ``sweep.nan`` degrade injected through
``GRAPHDYN_FAULT_PLAN``, each rendered alike by both packages' report; a
clean run leaves none, a recorded run keeps the evidence in its ledger, and
``run-supervised`` collects them. Every test that can dump runs in its own
directory."""

import contextlib
import glob
import io
import json
import os
import tracemalloc

import pytest
import torch

from graphdyn_torch import obs
from graphdyn_torch.cli import main
from graphdyn_torch.config import DynamicsConfig, EntropyConfig
from graphdyn_torch.graphs import erdos_renyi_graph
from graphdyn_torch.models.entropy import entropy_sweep
from graphdyn_torch.obs import flight, memband, trace
from graphdyn_torch.obs.recorder import NULL_SPAN, read_ledger
from graphdyn_torch.obs.report import summarize
from graphdyn_torch.resilience import faults
from graphdyn_torch.resilience import supervisor as sup
from graphdyn_torch.resilience.retry import RetryPolicy
from graphdyn_torch.resilience.shutdown import EX_TEMPFAIL, clear_shutdown

DYN11 = DynamicsConfig(p=1, c=1)
SA_SMOKE = ["sa", "--n", "40", "--d", "3", "--p", "1", "--c", "1",
            "--n-stat", "1", "--seed", "0", "--max-steps", "2000",
            "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs small tensors here: one intra-op thread per test
    process avoids oversubscribing the cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_ring():
    """Every test starts with an empty ring of the default capacity and no
    pending shutdown."""
    flight.configure(flight.DEFAULT_CAPACITY)
    flight.clear()
    clear_shutdown()
    yield
    flight.configure(flight.DEFAULT_CAPACITY)
    flight.clear()
    clear_shutdown()


def _quiet(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def _postmortem_events(directory):
    path = os.path.join(str(directory), flight.POSTMORTEM_NAME)
    assert os.path.exists(path), "the crash left no obs_postmortem.jsonl"
    events, torn = read_ledger(path)
    assert torn == 0                      # atomic dump: never a torn line
    return events


def _assert_crash_shape(events, reason):
    """Manifest first (stamped postmortem), ``obs.crash`` last, and the JAX
    package's reader and report take it as the port's do."""
    from graphdyn.obs.report import summarize as jsum

    assert events[0]["ev"] == "manifest"
    assert events[0]["run"]["postmortem"] is True
    assert events[0]["run"]["reason"] == reason
    last = events[-1]
    assert last["ev"] == "counter" and last["name"] == "obs.crash"
    assert last["attrs"]["reason"] == reason
    doc = summarize(events)
    assert doc == jsum(events)
    assert doc["counters"]["obs.crash"]["total"] == 1
    return last["attrs"]


# ---------------------------------------------------------------------------
# the profiler capture: one vocabulary for the ledger and the trace
# ---------------------------------------------------------------------------


def test_profiled_smoke_annotations_match_ledger_paths(tmp_path):
    """``--profile`` + ``--obs-ledger`` on a real CLI run: every span name
    path of the ledger is a ``record_function`` range of the chrome trace,
    and the output equals the run's without either flag."""
    pdir, ledger = str(tmp_path / "prof"), str(tmp_path / "run.jsonl")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert _quiet(["--profile", pdir, "--obs-ledger", ledger, *SA_SMOKE,
                   "--out", a]) == 0
    assert _quiet([*SA_SMOKE, "--out", b]) == 0
    import numpy as np

    with np.load(a + ".npz") as fa, np.load(b + ".npz") as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert np.array_equal(fa[k], fb[k]), k
    paths = set(summarize(read_ledger(ledger)[0])["spans"])
    assert {"run", "run > pipeline.sa.group",
            "run > pipeline.sa.group > pipeline.sa.chunk"} <= paths
    traces = trace.trace_files(pdir)
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f).get("traceEvents", [])}
    assert not paths - names, paths - names
    assert not trace.active() and obs.span("x") is NULL_SPAN


def test_span_ranges_nest_as_name_paths(monkeypatch, tmp_path):
    """Nested spans open ``record_function`` ranges named with the ledger's
    ``" > "``-joined paths, and the name stack unwinds with the spans."""
    opened = []

    class Stub:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Prof:
        def __init__(self, **kw):
            pass

        start = stop = lambda self: None

        def export_chrome_trace(self, path):
            pass

    monkeypatch.setattr(torch.profiler, "record_function", Stub)
    monkeypatch.setattr(torch.profiler, "profile", Prof)
    with trace.profiling(str(tmp_path / "p")):
        with obs.span("run"):
            with obs.span("pipeline.sa.chunk"):
                pass
            with obs.span("pipeline.sa.chunk"):
                pass
    assert opened == ["run", "run > pipeline.sa.chunk",
                      "run > pipeline.sa.chunk"]
    assert not trace.active() and obs.span("x") is NULL_SPAN


def test_profiling_scopes(monkeypatch, tmp_path):
    monkeypatch.delenv(trace.ENV_VAR, raising=False)
    with trace.profiling() as d:
        assert d is None and not trace.active()
    monkeypatch.setenv(trace.ENV_VAR, str(tmp_path / "env"))
    with trace.profiling(str(tmp_path / "a")):
        with pytest.raises(RuntimeError, match="one trace per run"):
            with trace.profiling(str(tmp_path / "b")):
                pass
        with trace.profiling() as d:            # the env names no second
            assert d == str(tmp_path / "a")
    assert len(trace.trace_files(str(tmp_path / "a"))) == 1


# ---------------------------------------------------------------------------
# memory: the gauges and memcheck off the card
# ---------------------------------------------------------------------------


def test_memcheck_structural_pass_off_the_card():
    rows = memband.run_memcheck(device="cpu")
    assert [r.program for r in rows] == [
        "packed_state", "bdcm_stack", "entropy_cell_chunk", "halo_shard",
        "bucketed_state", "streamed_chunk", "streamed_shard"]
    for r in rows:
        assert r.ok and r.measured is None and r.frac is None, r
        assert r.reason and r.device == "cpu"
        assert r.model > 0
    # the halo row charges the widest shard of the JAX package's smoke
    # partition, as its model does
    from graphdyn.obs import memband as jmem

    assert rows[3].model == jmem._halo_smoke_model(W=8)
    # the sharded stream's row: the JAX package's shard_plan_device_bytes
    # of the same smoke plan (its widest shard's two largest chunks)
    from graphdyn import graphs as jg
    from graphdyn.parallel.stream import (
        build_shard_stream_plan,
        shard_plan_device_bytes,
    )

    g = jg.powerlaw_graph(4096, gamma=2.5, dmin=2, seed=0)
    plan = build_shard_stream_plan(g, W=8, partition=jg.partition_graph(
        g, 2, seed=0), n_chunks=4)
    assert rows[6].model == shard_plan_device_bytes(plan, 8)


def test_memrow_band_logic_and_peak_null_plus_reason():
    row = memband._row("packed_state", 10 ** 6, 10 ** 6 / 2)
    assert row.frac == pytest.approx(2.0) and row.ok
    lo, hi = memband.MEM_BANDS["packed_state"]
    assert not memband._row("packed_state", int(10 ** 6 * hi * 4), 10 ** 6).ok
    assert not memband.MemRow("packed_state", None, 1.0, None, lo, hi,
                              None).ok
    peak, reason = memband.peak_hbm_bytes("cpu")
    assert peak is None and "cpu" in reason


def test_mem_gauges_unavailable_once_per_recording_scope(tmp_path):
    p = str(tmp_path / "mem.jsonl")
    with obs.recording(p):
        memband.emit_memory_gauges("cpu", loop="t.chunk", chunk=0)
        memband.emit_memory_gauges("cpu", loop="t.chunk", chunk=1)
    events, _ = read_ledger(p)
    gone = [e for e in events if e.get("name") == "obs.mem.unavailable"]
    assert len(gone) == 1 and "host memory" in gone[0]["attrs"]["reason"]


# ---------------------------------------------------------------------------
# the flight ring
# ---------------------------------------------------------------------------


def test_ring_bounded_fifo_and_allocation_bounded():
    flight.configure(8)
    for i in range(20):
        obs.counter("tick", i=i)
    assert [e["attrs"]["i"] for e in flight.snapshot()] == list(range(12, 20))
    flight.configure(64)
    for i in range(flight.capacity() + 16):
        obs.counter("tick", i=i)
    tracemalloc.start()
    base = tracemalloc.take_snapshot()
    for i in range(4000):
        obs.counter("tick", i=i)
        obs.gauge("level", i)
    diff = tracemalloc.take_snapshot().compare_to(base, "filename")
    tracemalloc.stop()
    leaked = sum(d.size_diff for d in diff if d.size_diff > 0)
    assert leaked < 16_384, f"flight ring retained {leaked} B in steady state"


def test_ring_disarmed_by_env(monkeypatch, tmp_path):
    monkeypatch.setenv(flight.ENV_VAR, "0")
    obs.counter("tick")
    assert flight.snapshot() == []
    assert flight.dump("exception", workdir=str(tmp_path)) is None
    assert not (tmp_path / flight.POSTMORTEM_NAME).exists()


# ---------------------------------------------------------------------------
# the dump paths, injected through GRAPHDYN_FAULT_PLAN
# ---------------------------------------------------------------------------


def _plan(monkeypatch, *specs):
    """``GRAPHDYN_FAULT_PLAN`` for this test, parsed afresh (the env plan
    lives for the process once parsed)."""
    monkeypatch.setenv(faults.ENV_VAR, json.dumps(list(specs)))
    monkeypatch.setattr(faults, "_env_plan_cache", [])


def test_unhandled_cli_exception_leaves_postmortem(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(obs.ENV_VAR, raising=False)
    _plan(monkeypatch, {"site": "rep.boundary", "action": "raise", "at": 1})
    with pytest.raises(Exception, match="rep.boundary"):
        _quiet([*SA_SMOKE, "--out", str(tmp_path / "sa")])
    attrs = _assert_crash_shape(_postmortem_events(tmp_path), "exception")
    assert attrs["exc_type"] == "InjectedFault" and "site" in attrs


def test_sigterm_preempt_exits_75_and_leaves_postmortem(tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(obs.ENV_VAR, raising=False)
    _plan(monkeypatch, {"site": "rep.boundary", "action": "signal", "at": 1})
    assert _quiet([*SA_SMOKE, "--out", str(tmp_path / "sa")]) == EX_TEMPFAIL
    attrs = _assert_crash_shape(_postmortem_events(tmp_path), "preempt")
    assert attrs["site"] == "rep" and attrs["exc_type"] == "ShutdownRequested"


def test_sweep_nan_degrade_preserves_flight_evidence(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    obs.counter("marker.before_poison", k=7)     # the ring's tail survives
    _plan(monkeypatch, {"site": "sweep.nan", "action": "nan", "at": 2})
    g = erdos_renyi_graph(60, 1.5 / 59, seed=0)
    cfg = EntropyConfig(dynamics=DYN11, lmbd_max=0.3, lmbd_step=0.1,
                        max_sweeps=300, eps=1e-5)
    res = entropy_sweep(g, cfg, seed=0, device="cpu")   # degrades, no raise
    assert res.nonconverged is not None
    events = _postmortem_events(tmp_path)
    attrs = _assert_crash_shape(events, "sweep.nan")
    assert "lambda" in attrs["site"]
    assert "marker.before_poison" in [e.get("name") for e in events]


def test_clean_run_leaves_no_postmortem(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert _quiet([*SA_SMOKE, "--out", str(tmp_path / "sa")]) == 0
    assert not (tmp_path / flight.POSTMORTEM_NAME).exists()


def test_cli_crash_with_ledger_records_obs_crash_in_ledger(tmp_path,
                                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    ledger = str(tmp_path / "run.jsonl")
    _plan(monkeypatch, {"site": "rep.boundary", "action": "signal", "at": 1})
    assert _quiet(["--obs-ledger", ledger, *SA_SMOKE, "--out",
                   str(tmp_path / "sa")]) == EX_TEMPFAIL
    assert not (tmp_path / flight.POSTMORTEM_NAME).exists()
    events, _ = read_ledger(ledger)
    crash = [e for e in events if e.get("name") == "obs.crash"]
    assert len(crash) == 1
    assert crash[0]["attrs"]["reason"] == "preempt"
    assert crash[0]["attrs"]["site"] == "rep"
    counters = summarize(events)["counters"]
    assert counters["resilience.shutdown"]["total"] == 1


def test_dump_with_live_recorder_goes_to_ledger_not_file(tmp_path):
    p = str(tmp_path / "live.jsonl")
    with obs.recording(p):
        assert flight.dump("sweep.nan", site="cell=3",
                           workdir=str(tmp_path)) is None
    assert not (tmp_path / flight.POSTMORTEM_NAME).exists()
    crash = [e for e in read_ledger(p)[0] if e.get("name") == "obs.crash"]
    assert len(crash) == 1 and crash[0]["attrs"]["site"] == "cell=3"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_postmortems_cross_read(tmp_path, writer):
    """Each package's post-mortem is a ledger the other's reader and report
    take, to the same summary."""
    from graphdyn import obs as jobs
    from graphdyn.obs import flight as jflight
    from graphdyn.obs.recorder import read_ledger as jread
    from graphdyn.obs.report import summarize as jsum

    pkg, fl = (obs, flight) if writer == "port" else (jobs, jflight)
    fl.clear()
    pkg.counter("tick", i=1)
    path = fl.dump("exception", exc=ValueError("boom"),
                   workdir=str(tmp_path))
    assert path == str(tmp_path / flight.POSTMORTEM_NAME)
    events, torn = read_ledger(path)
    assert (events, torn) == jread(path)
    doc = summarize(events)
    assert doc == jsum(events)
    assert doc["manifest"]["postmortem"] is True
    assert doc["counters"]["obs.crash"]["total"] == 1
    assert "tick" in doc["counters"]
    fl.clear()


def test_run_supervised_collects_postmortems(tmp_path, monkeypatch):
    """A crash at every episode's first repetition boundary: each episode
    leaves its post-mortem, the supervisor keys the loop on its site and
    keeps every one as ``supervise/postmortem.ep<N>.jsonl`` evidence."""
    monkeypatch.chdir(tmp_path)
    _plan(monkeypatch, {"site": "rep.boundary", "action": "raise",
                        "count": 99})
    pol = sup.RestartPolicy(backoff=RetryPolicy(
        tries=4, base_delay_s=0.01, max_delay_s=0.02, jitter=True))
    rep = sup.supervise(SA_SMOKE, workdir=str(tmp_path / "w"), policy=pol,
                        runner=sup.run_inprocess)
    assert rep["exit"] == sup.EX_QUARANTINE
    kept = sorted(glob.glob(str(tmp_path / "w" / "supervise"
                                / "postmortem.ep*.jsonl")))
    assert len(kept) == len(rep["episodes"]) >= 2
    sites = {ep["site"] for ep in rep["episodes"]}
    assert len(sites) == 1 and not sites.pop().startswith("exit:")
    for path in kept:
        _assert_crash_shape(read_ledger(path)[0], "exception")
    assert all("postmortem" in ep for ep in rep["episodes"])
