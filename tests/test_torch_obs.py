"""The port's runtime telemetry (``graphdyn_torch.obs``), as
``tests/test_obs.py`` holds the JAX package's: the recorder and its JSONL
schema, the null recorder's cost, the recording scope, the report, the
trend gate and the byte models. Held against the JAX package wherever both
run: each package's reader and report take the other's ledgers and give the
same summary; the same CLI command through both packages records the same
span paths, counter names and sums, and gauge names (``jax.compile`` and
``kernel.build`` aside); the byte models and the trend logic equal the JAX
package's. The bound models that ``chip_smoke.py`` prints come from
``obs/roofline.py`` and give PERF.md's bound column at one table shape."""

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import tracemalloc
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from graphdyn_torch import obs
from graphdyn_torch.obs import memband, roofline, trend
from graphdyn_torch.obs.recorder import (
    EVENT_KINDS,
    NULL,
    NULL_SPAN,
    Recorder,
    read_ledger,
)
from graphdyn_torch.obs.report import load_summary, summarize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _assert_schema_valid(events):
    """Every event is a complete object of a known kind with the kind's
    required fields."""
    assert events, "empty ledger"
    for e in events:
        assert e["ev"] in EVENT_KINDS, e
        assert isinstance(e["t"], (int, float)), e
        if e["ev"] == "span":
            assert {"name", "id", "parent", "t0", "wall_s", "cpu_s"} <= set(e)
            assert e["wall_s"] >= 0 and e["cpu_s"] >= 0
        elif e["ev"] == "counter":
            assert {"name", "inc"} <= set(e), e
        elif e["ev"] == "gauge":
            assert {"name", "value"} <= set(e), e
        elif e["ev"] == "manifest":
            assert e["run"]["schema"] == obs.SCHEMA


# ---------------------------------------------------------------------------
# recorder core
# ---------------------------------------------------------------------------


def test_recorder_writes_jsonl_events_and_nests_spans(tmp_path):
    p = str(tmp_path / "run.jsonl")
    rec = Recorder(p)
    rec.manifest(cmd="test", backend="cpu")
    with rec.span("outer", stage="a"):
        with rec.span("inner") as sp:
            sp.set(rows=3, path=tmp_path)          # non-JSON attr: str()
        rec.counter("hits", 2, site="x")
        rec.gauge("rate", 1.5e9)
    rec.close()
    events, torn = read_ledger(p)
    assert torn == 0
    _assert_schema_valid(events)
    assert [e["ev"] for e in events] == ["manifest", "span", "counter",
                                         "gauge", "span"]
    inner, outer = events[1], events[4]
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert inner["attrs"] == {"rows": 3, "path": str(tmp_path)}
    assert outer["attrs"] == {"stage": "a"}


def test_span_imperative_and_abandoned_child(tmp_path):
    """``stop()`` is idempotent, and a child whose stop was skipped (an
    exception unwound past it) does not misparent later spans."""
    p = str(tmp_path / "run.jsonl")
    rec = Recorder(p)
    outer = rec.span("outer").start()
    rec.span("abandoned").start()
    outer.stop()
    outer.stop()
    with rec.span("later"):
        pass
    rec.close()
    events, _ = read_ledger(p)
    spans = [e for e in events if e["ev"] == "span"]
    assert [s["name"] for s in spans] == ["outer", "later"]
    assert spans[1]["parent"] is None


@pytest.mark.parametrize("text,torn", [
    ('{"ev": "counter", "t": 0, "name": "a", "inc": 1}\n{"ev": "gau', 1),
    ('{"ev": "counter", "t": 0, "name": "a", "inc": 1}\n{"ev": "co\n'
     '{"ev": "manifest", "t": 0, "run": {"schema": 1}}\n', 1),
    ('{"ev": "counter", "t": 0, "name": "a", "inc": 1}\n', 0),
], ids=["torn_tail", "requeue_seam", "clean"])
def test_read_ledger_torn_line_rules_match_jax(tmp_path, text, torn):
    from graphdyn.obs.recorder import read_ledger as jread

    p = tmp_path / "l.jsonl"
    p.write_text(text)
    assert read_ledger(str(p)) == jread(str(p))
    assert read_ledger(str(p))[1] == torn


def test_read_ledger_rejects_torn_middle_line(tmp_path):
    p = tmp_path / "l.jsonl"
    p.write_text('{"ev": "manifest"}\n{"torn\n{"ev": "x"}\n')
    with pytest.raises(ValueError, match="torn JSON line"):
        read_ledger(str(p))


def test_requeue_reopen_seals_torn_tail(tmp_path):
    p = tmp_path / "run.jsonl"
    p.write_text('{"ev": "counter", "t": 0, "name": "a", "inc": 1}\n{"ev": "sp')
    rec = Recorder(str(p))
    rec.manifest(cmd="requeued")
    rec.close()
    events, torn = read_ledger(str(p))
    assert torn == 1 and events[-1]["ev"] == "manifest"


# ---------------------------------------------------------------------------
# the null recorder and the recording scope
# ---------------------------------------------------------------------------


def test_null_recorder_is_default_and_allocation_free():
    assert obs.current() is NULL and not obs.enabled()
    assert obs.span("pipeline.sa.chunk") is NULL_SPAN
    with obs.span("x") as sp:
        assert sp is NULL_SPAN
    assert obs.manifest(cmd="x") is None
    from graphdyn_torch.obs import flight

    flight.configure(64)
    try:
        for _ in range(flight.capacity() + 100):   # warm caches, fill ring
            with obs.span("chunk"):
                pass
            obs.counter("c")
        tracemalloc.start()
        base = tracemalloc.take_snapshot()
        for _ in range(2000):
            with obs.span("chunk"):
                pass
            obs.counter("c")
        diff = tracemalloc.take_snapshot().compare_to(base, "filename")
        tracemalloc.stop()
        leaked = sum(d.size_diff for d in diff if d.size_diff > 0)
        assert leaked < 16_384, f"null-recorder path retained {leaked} B"
    finally:
        flight.configure(flight.DEFAULT_CAPACITY)
        flight.clear()


def test_timed_always_measures_and_recording_scopes(tmp_path, monkeypatch):
    with obs.timed("bench.row") as sw:
        time.sleep(0.01)
    assert sw.wall_s >= 0.008
    p = str(tmp_path / "run.jsonl")
    with obs.recording(p) as rec:
        assert obs.enabled() and obs.current() is rec
        obs.counter("inside")
        with pytest.raises(RuntimeError, match="one ledger per run"):
            with obs.recording(str(tmp_path / "b.jsonl")):
                pass
        with obs.recording() as inner:
            assert inner is rec
    assert obs.current() is NULL
    assert read_ledger(p)[0][0]["name"] == "inside"
    monkeypatch.setenv("GRAPHDYN_OBS", str(tmp_path / "env.jsonl"))
    with obs.recording() as rec:
        assert rec.enabled
    monkeypatch.delenv("GRAPHDYN_OBS")
    with obs.recording() as rec:
        assert rec is NULL


def test_manifest_fields_name_torch_and_the_card():
    f = obs.run_manifest_fields(cmd="x")
    assert f["torch"] == torch.__version__ and f["cmd"] == "x"
    assert f["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    if not torch.cuda.is_available():
        assert f["device_name"] is None and f["power_limit"] is None
    assert "jax" not in f


# ---------------------------------------------------------------------------
# one schema: each package reads and reports the other's ledgers
# ---------------------------------------------------------------------------


def _ledger_through(rec_cls, path):
    rec = rec_cls(str(path))
    rec.manifest(cmd="entropy", backend="cpu")
    with rec.span("run", cmd="entropy"):
        with rec.span("pipeline.entropy.chunk", chunk=0):
            rec.counter("pipeline.lambda.boundary", cell=0, lmbd=0.0)
        with rec.span("pipeline.entropy.chunk", chunk=1):
            pass
        rec.gauge("ops.rollout.rate", 1.5e9, solver="sa_group")
    rec.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ledgers_cross_read_to_the_same_summary(tmp_path, writer):
    from graphdyn.obs.recorder import Recorder as JRecorder
    from graphdyn.obs.recorder import read_ledger as jread
    from graphdyn.obs.report import summarize as jsum

    p = tmp_path / "run.jsonl"
    _ledger_through(Recorder if writer == "port" else JRecorder, p)
    (ev_t, torn_t), (ev_j, torn_j) = read_ledger(str(p)), jread(str(p))
    assert ev_t == ev_j and torn_t == torn_j == 0
    _assert_schema_valid(ev_t)
    doc = summarize(ev_t)
    assert doc == jsum(ev_j)
    assert doc["spans"]["run > pipeline.entropy.chunk"]["count"] == 2
    assert doc["counters"]["pipeline.lambda.boundary"]["total"] == 1


def test_report_cli_one_json_document(tmp_path):
    p = tmp_path / "run.jsonl"
    _ledger_through(Recorder, p)
    with open(p, "a") as f:
        f.write('{"ev":"cou')
    proc = subprocess.run(
        [sys.executable, "-m", "graphdyn_torch.obs", "report", str(p),
         "--format=json"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-800:]
    doc = json.loads(proc.stdout)
    assert doc["torn_lines"] == 1 and "torn line" in proc.stderr
    assert doc == json.loads(json.dumps(load_summary(str(p)), default=str))
    text = subprocess.run(
        [sys.executable, "-m", "graphdyn_torch.obs", "report", str(p)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert text.returncode == 0 and "pipeline.entropy.chunk" in text.stdout


# ---------------------------------------------------------------------------
# the same command through both packages records the same events
# ---------------------------------------------------------------------------

CLI_RUNS = {
    "hpr": ["hpr", "--n", "60", "--max-sweeps", "50"],
    "entropy": ["entropy", "--n", "30", "--deg", "1.2", "1.6", "--num-rep",
                "1", "--lmbd-max", "0.1"],
    "sa": ["sa", "--n", "60", "--d", "3", "--n-stat", "2", "--max-steps",
           "500"],
    "consensus": ["consensus", "--n", "300", "--replicas", "64", "--m0",
                  "0.0", "0.3", "--max-steps", "40"],
    "stream": ["stream", "--n", "96", "--steps", "4", "--replicas", "8",
               "--chunks", "3", "--churn-rate", "4.0"],
}
BOUNDARY_COUNTERS = ("pipeline.rep.boundary", "pipeline.lambda.boundary",
                     "resilience.shutdown")
BUILD_COUNTERS = {"jax.compile", "kernel.build"}
TIMING_KEYS = ("time", "overlap_frac")


def _recorded(main, argv, path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--obs-ledger", str(path), *argv])
    assert rc in (0, None)
    events, torn = read_ledger(str(path))
    assert torn == 0
    _assert_schema_valid(events)
    return summarize(events), buf.getvalue()


@pytest.mark.parametrize("cmd", list(CLI_RUNS))
def test_same_command_records_the_same_events_as_jax(cmd, tmp_path,
                                                     monkeypatch):
    from graphdyn.cli import main as jmain
    from graphdyn_torch.cli import main as tmain

    monkeypatch.chdir(tmp_path)
    argv = CLI_RUNS[cmd]
    want, _ = _recorded(jmain, argv, tmp_path / "j.jsonl")
    got, out = _recorded(tmain, argv + ["--device", "cpu"],
                         tmp_path / "t.jsonl")
    assert got["manifest"]["cmd"] == cmd and got["manifest"]["argv"]
    assert "run" in got["spans"]
    assert set(got["spans"]) == set(want["spans"])
    assert set(got["counters"]) - BUILD_COUNTERS \
        == set(want["counters"]) - BUILD_COUNTERS
    for name in BOUNDARY_COUNTERS:
        if name in want["counters"]:
            assert got["counters"][name] == want["counters"][name], name
    assert set(got["gauges"]) == set(want["gauges"])
    # recording changes no result: the same command without a ledger
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tmain(argv + ["--device", "cpu"]) in (0, None)
    assert _result(buf.getvalue()) == _result(out)


def _result(stdout: str) -> dict:
    """A CLI's printed document without its wall-clock fields."""
    doc = json.loads(stdout.strip().splitlines()[-1])
    return {k: v for k, v in doc.items() if k not in TIMING_KEYS}


# ---------------------------------------------------------------------------
# byte models and the trend gate equal the JAX package's
# ---------------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(d=st.integers(1, 12), T=st.integers(1, 6))
def test_roofline_byte_models_equal_jax(d, T):
    from graphdyn.obs import roofline as jr

    assert roofline.packed_bytes_per_update(d) == jr.packed_bytes_per_update(d)
    assert roofline.bdcm_bytes_per_edge_sweep(d, T) \
        == jr.bdcm_bytes_per_edge_sweep(d, T)


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 10**7), d=st.integers(1, 64), W=st.integers(1, 1024),
       E=st.integers(0, 10**7), K=st.integers(1, 4096),
       M=st.integers(0, 10**6), width=st.integers(1, 1 << 15),
       budget=st.integers(1, 1 << 40))
def test_memband_byte_models_equal_jax(n, d, W, E, K, M, width, budget):
    from graphdyn.obs import memband as jm

    assert memband.packed_state_bytes(n, d, W) == jm.packed_state_bytes(n, d, W)
    assert memband.halo_shard_bytes(n, M, W) == jm.halo_shard_bytes(n, M, W)
    assert memband.bucketed_state_bytes(n, W, E) \
        == jm.bucketed_state_bytes(n, W, E)
    assert memband.bucketed_table_entries_bound(n, E) \
        == jm.bucketed_table_entries_bound(n, E)
    assert memband.streamed_chunk_bytes(n, M, width, W) \
        == jm.streamed_chunk_bytes(n, M, width, W)
    assert memband.streamed_min_bytes(d, W) == jm.streamed_min_bytes(d, W)
    assert memband.streamed_state_bytes(n, W, E, K) \
        == jm.streamed_state_bytes(n, W, E, K)
    assert memband.streamed_chunk_count(min(n, 4096), W, E, budget) \
        == jm.streamed_chunk_count(min(n, 4096), W, E, budget)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stacked_bdcm_models_equal_jax(dtype):
    """The stacked-BDCM and entropy-chunk models over both packages' stacks
    of the same ragged ER cells."""
    from graphdyn.graphs import erdos_renyi_graph as jer
    from graphdyn.graphs import remove_isolates as jri
    from graphdyn.obs import memband as jm
    from graphdyn.ops.bdcm import BDCMData as JData
    from graphdyn.ops.bdcm import stack_bdcm as jstack
    from graphdyn_torch.graphs import erdos_renyi_graph, remove_isolates
    from graphdyn_torch.ops.bdcm import BDCMData, stack_bdcm

    import jax

    cells = ((1, 2.0), (2, 3.5), (3, 1.2))
    port = stack_bdcm([BDCMData(remove_isolates(erdos_renyi_graph(
        80, c / 79, seed=s))[0], p=1, c=1, dtype=dtype) for s, c in cells])
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        ref = jstack([JData(jri(jer(80, c / 79, seed=s))[0], p=1, c=1,
                            dtype=dtype) for s, c in cells])
        assert memband.stacked_bdcm_bytes(port) == jm.stacked_bdcm_bytes(ref)
        assert memband.entropy_chunk_bytes(port) \
            == jm.entropy_chunk_bytes(ref)
    finally:
        jax.config.update("jax_enable_x64", x64)


PREV_ROW = {"backend": "cpu", "metric": "spin_updates_per_sec_n100000",
            "value": 2.0e9, "packed_rate_natural_order": 2.0e9,
            "ensemble_rate": 1.0e7, "int8_rate": 8.0e7}


@pytest.mark.parametrize("new", [
    {"value": 4.0e8, "packed_rate_natural_order": 4.0e8},
    {"int8_rate": 8.0e7 * 40}, {"value": 2.1e9}, {"backend": "tpu"},
    {"metric": "other_n1000000"}, {"ensemble_rate": None},
    {"backend": "gpu", "value": 1.0},
], ids=["slowed", "jumped", "stable", "backend", "metric", "null", "gpu"])
def test_trend_diff_equals_jax(new):
    from graphdyn.obs import trend as jt

    row = {**PREV_ROW, **new}
    assert trend.comparable(PREV_ROW, row) == jt.comparable(PREV_ROW, row)
    # the same findings; the bless hint names each package's own module
    assert [(f.row, f.code, f.message.replace("graphdyn_torch.obs",
                                              "graphdyn.obs"))
            for f in trend.diff_bench_rates(PREV_ROW, row)] \
        == [tuple(f) for f in jt.diff_bench_rates(PREV_ROW, row)]
    assert trend.diff_bench_rates({**PREV_ROW, "value": 0.0}, row) == []


def test_gpu_row_finds_no_tpu_round_to_compare(tmp_path):
    notes = []
    row = {"backend": "gpu", "metric": "spin_updates_per_sec_n1000000",
           "value": 6.2e12}
    assert trend.check_trend(row, ledger={"classes": {}},
                             diag=notes.append) == ([], "no_baseline")
    assert "no comparable committed round" in notes[0]
    (tmp_path / "BENCH_r01.json").write_text(json.dumps({"parsed": row}))
    assert trend.check_trend({**row, "value": 6.0e12}, root=str(tmp_path),
                             ledger={"classes": {}})[1] == "stable"
    lpath = str(tmp_path / "OBS_TREND.json")
    trend.write_trend_ledger({**row, "value": 1.0e12}, lpath)
    assert trend.check_trend({**row, "value": 1.0e12}, root=str(tmp_path),
                             ledger=trend.load_trend_ledger(lpath))[1] \
        == "blessed"


# ---------------------------------------------------------------------------
# the bound models chip_smoke.py prints (PERF.md's bound column)
# ---------------------------------------------------------------------------


def test_lifted_bounds_give_the_table_at_one_shape():
    """K1/K2′ at the headline (RRG d=3, n=10⁶, W=512, fast path) and config
    3 (ER n=10⁵ c=6 isolates removed, W=16, general path); K4′ at the scale
    shape (RRG d=5, n=10⁶, W=32, χ=16: a class's ball is (d+1)·|C| rows and
    the rows its LUTs read, |D|, average 737,478, the colouring's count
    printed by the card's run); K3′ at config 2 (a union of 256 RRG(10⁵, 3),
    f32, one class d=2 T=2, node bias; every row in the class); K3 at (d=3,
    T=2, G=5, Ed=10⁵) f32; KB at the bench graph's 10⁵ rows, Σdeg 765,678,
    W=32. Built from the shapes' numbers: no 10⁶-node graph."""
    from graphdyn_torch.models.consensus import er_consensus_ensemble

    head = roofline.step_bound(types.SimpleNamespace(
        n=10**6, deg=np.full(10**6, 3)), 512, True)
    assert f"{head['bound_ms']:.4g}" == "1.226" and head["bound_by"] == "bytes"
    g3, _, _, _ = er_consensus_ensemble(100_000, c=6.0, seed=0, device="cpu")
    cfg3 = roofline.step_bound(g3, 16, False)
    assert f"{cfg3['bound_ms']:.3g}" == "0.00465"

    n, d, chi, W = 10**6, 5, 16, 32
    k = n // chi
    cls = {"k": k, "n_d": 737_478, "deg_b": d * (d + 1) * k,
           "deg_b1": (d + 1) ** 2 * k, "deg_c1": (d + 1) * k,
           "nb_terms": (d + 1) * k * (2 * d * 3 + (d + 1) * 7)}
    k4 = roofline.class_step_bound_counts([cls], W, d)
    assert f"{k4['bound_ms']:.4g}" == "0.32" and k4["bound_by"] == "operations"
    assert k4["int_ops"] == 5_352_000_000 and k4["bytes"] == 132_371_672

    twoE = 256 * 100_000 * 3
    k3p = roofline.sweep_bound_counts({
        "G": 1, "rows": twoE, "T": 2, "esize": 4, "cid_bytes": 2 * twoE,
        "pass_rows": 0, "bias_elems": 2 * 256 * 100_000, "src": twoE,
        "classes": [(2, twoE, twoE, 16 * 9)]})
    assert f"{k3p['bound_ms']:.4g}" == "3.408" and k3p["bound_by"] == "bytes"

    k3 = roofline.contract_bound(5, 100_000, 3, 2, torch.float32)
    assert f"{k3['bound_ms']:.4g}" == "0.04776"

    deg = np.full(100_000, 7)
    deg[: 765_678 - 700_000] += 1
    kb = roofline.kb_bound(100_000, 32, deg)
    assert f"{kb['bound_ms']:.4g}" == "0.008675" and kb["bound_by"] == "bytes"


def test_h100_profile_keyed_on_the_device_name():
    assert roofline.chip_profile("NVIDIA H100 80GB HBM3")[:2] == (
        "h100", 3.35e12)
    assert roofline.chip_profile("NVIDIA A100-SXM4-40GB") is None
    for prof in roofline.CHIP_BANDS.values():
        assert set(prof["bands"]) == set(roofline.BANDS)
    assert roofline.H100["int32_ops_per_s"] == 132 * 64 * 1.98e9
    assert roofline.H100["f64_flops_per_s"] == 34e12
    assert roofline.H100["alu_ops_per_s"] == 67e12


def test_roofline_obscheck_runs_on_the_host_proxy(tmp_path):
    p = str(tmp_path / "roofline.jsonl")
    notes = []
    with obs.recording(p):
        rows = roofline.run_obscheck(diag=notes.append, device="cpu")
    assert [r.program for r in rows] == ["packed_rollout", "bdcm_sweep",
                                         "entropy_cell_chunk"]
    for r in rows:
        assert r.measured > 0 and r.model > 0 and r.ok, r
        assert (r.anchor, r.device) == ("host-proxy", "cpu"), r
    assert "host stream bandwidth" in notes[0]
    gauges = {e["name"]: e for e in read_ledger(p)[0] if e["ev"] == "gauge"}
    assert {f"obs.roofline.{r.program}" for r in rows} <= set(gauges)
    assert gauges["obs.roofline.packed_rollout"]["attrs"]["anchor"] == \
        "host-proxy"


def test_obscheck_and_memcheck_run_on_the_card_unless_asked(monkeypatch,
                                                             capsys):
    """No quiet host fallback: without a card ``check`` and ``memcheck``
    fail unless given ``--device cpu``; a card with no committed profile is
    refused, never measured against another part's roof."""
    from graphdyn_torch.obs.__main__ import main as obs_main
    from graphdyn_torch.utils import platform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.run_obscheck()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        memband.run_memcheck()
    for sub in ("check", "memcheck"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            obs_main([sub, "--format=json"])
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(platform, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-40GB")
    with pytest.raises(LookupError, match="no committed profile"):
        roofline.run_obscheck()
