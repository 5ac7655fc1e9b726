"""The port's worker and lifecycle (``graphdyn_torch.serve.worker``,
``graphdyn_torch.serve.lifecycle``) against the JAX package's: one spool of
several tenants' jobs (fused, a bucket hit, the JAX package's ``'xla'``
label, bucketed, streamed, an oversized and an under-declared job) served
by both workers on the CPU, held record by record, journal event by
journal event, and result by result (fused under the near-tie rule,
bucketed and streamed bit for bit); the streamed twin admitted where the
resident engine is refused; eviction, escalation and ``done``; quarantine
after two crashes; the dispatch retry, then requeue; the background
thread; and ``run_service``'s recover and drain."""

import os
import time

import numpy as np
import pytest
import torch

from graphdyn.graphs import powerlaw_graph as j_powerlaw
from graphdyn.resilience import faults as jfaults
from graphdyn.resilience.retry import RetryPolicy as JRetry
from graphdyn.serve import lifecycle as jlife
from graphdyn.serve import spool as jspool
from graphdyn.serve import worker as jworker
from graphdyn_torch.resilience import faults as tfaults
from graphdyn_torch.resilience.retry import RetryPolicy as TRetry
from graphdyn_torch.resilience.shutdown import shutdown_requested
from graphdyn_torch.serve import lifecycle as tlife
from graphdyn_torch.serve import spool as tspool
from graphdyn_torch.serve import worker as tworker

import torch_serve

SMALL = torch_serve.SMALL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cwd(tmp_path, monkeypatch):
    # a crashing job leaves its flight post-mortem in the working directory
    monkeypatch.chdir(tmp_path)


def _pl(n):
    g = j_powerlaw(n, gamma=2.5, dmin=2, seed=0)
    return int(g.edges.shape[0]), int(g.deg.max())


E64, _ = _pl(64)
E512, DMAX512 = _pl(512)

JOBS = [
    ("alice", {**SMALL, "seed": 1}),
    ("bob", {**SMALL, "seed": 2, "graph_seed": 1, "rule": "minority",
             "tie": "change"}),
    ("alice", {**SMALL, "seed": 5}),                       # a bucket hit
    ("carol", {"n": 200000, "d": 3, "replicas": 4096}),    # oversized
    ("dave", {"solver": "bucketed", "n": 64, "d": 2, "gamma": 2.5,
              "edges": E64, "replicas": 40, "max_sweeps": 8}),
    ("erin", {"solver": "streamed", "n": 512, "d": 2, "gamma": 2.5,
              "edges": E512, "dmax": DMAX512, "replicas": 32,
              "max_sweeps": 4, "seed": 3}),
    ("frank", {"n": 1000, "d": 3, "replicas": 512, "max_sweeps": 2,
               "chunk_sweeps": 1, "seed": 4}),             # JAX: 'xla'
    ("grace", {"solver": "bucketed", "n": 64, "d": 2, "gamma": 2.5,
               "edges": 1, "replicas": 32, "max_sweeps": 4}),  # under-declared
]


def _serve_both(tmp, jobs, budget=torch_serve.BUDGET):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRAPHDYN_SERVE_HBM_BUDGET", str(budget))
        for name, mod, make in (
                ("jax", jspool, lambda sp: jworker.Worker(sp)),
                ("port", tspool,
                 lambda sp: tworker.Worker(sp, device="cpu"))):
            sp = mod.Spool(str(tmp / name))
            for tenant, spec in jobs:
                sp.submit(spec, tenant)
            w = make(sp)
            settled = w.run_until_drained()
            out[name] = {"spool": sp, "settled": settled,
                         "stats": w.cache.stats()}
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return _serve_both(tmp_path_factory.mktemp("served"), JOBS)


def test_every_job_settled_in_the_same_state(served):
    assert served["port"]["settled"] == served["jax"]["settled"] == len(JOBS)
    states = [r["state"] for r in served["port"]["spool"].jobs()]
    assert states == ["done", "done", "done", "refused", "done", "done",
                      "done", "refused"]


def test_records_and_journals_equal(served):
    torch_serve.same_records(served["port"]["spool"].jobs(),
                             served["jax"]["spool"].jobs())
    assert torch_serve.journal_events(served["port"]["spool"].root) == \
        torch_serve.journal_events(served["jax"]["spool"].root)


def test_refusal_reasons(served):
    recs = served["port"]["spool"].jobs()
    assert "exceeds the device budget" in recs[3]["reason"]
    assert f"{torch_serve.BUDGET} B" in recs[3]["reason"]
    assert "under-priced" in recs[7]["reason"]
    for r in (recs[3], recs[7]):
        assert not os.path.exists(r["result"])


def test_results_held_to_the_jax_package(served):
    how = torch_serve.hold_results(served["port"]["spool"].jobs(),
                                   served["jax"]["spool"].jobs())
    assert len(how) == 6 and set(how.values()) <= {"bit-exact", "near-tie"}
    # the bucketed and streamed jobs are integer paths: bit for bit
    assert how["j000005-dave"] == how["j000006-erin"] == "bit-exact"


def test_bucket_statistics_equal(served):
    assert served["port"]["stats"] == served["jax"]["stats"]
    # alice's second job and grace's (dave's graph) are hits
    assert served["port"]["stats"]["hits"] == 2


def test_streamed_twin_admitted_where_resident_twin_refused(tmp_path):
    """Under a clamped budget the same declared shape is refused on the
    resident bucketed engine and served streamed in at least two chunks,
    by both packages, with equal records and bit-equal results. The
    refusals name each package's own bucketed price (the port's is what
    its rollout holds, above the JAX package's one resident copy)."""
    from graphdyn_torch.obs.memband import (
        bucketed_job_bytes,
        bucketed_state_bytes,
        bucketed_table_entries_bound,
        streamed_min_bytes,
    )

    n = 512
    resident = bucketed_state_bytes(n, 1, bucketed_table_entries_bound(
        n, E512))
    price = bucketed_job_bytes(n, 1, E512)
    budget = max(3 * resident // 4, 4 * streamed_min_bytes(DMAX512, 1))
    assert budget < resident < price
    shape = {"n": n, "d": 2, "gamma": 2.5, "edges": E512, "replicas": 32,
             "max_sweeps": 4}
    jobs = [("t1", {**shape, "solver": "bucketed"}),
            ("t1", {**shape, "solver": "streamed", "dmax": DMAX512})]
    out = _serve_both(tmp_path, jobs, budget=budget)
    recs, jrecs = out["port"]["spool"].jobs(), out["jax"]["spool"].jobs()
    assert f"{price} B" in recs[0]["reason"]
    assert f"{resident} B" in jrecs[0]["reason"]
    torch_serve.same_records(
        recs, [{**jrecs[0], "reason": jrecs[0]["reason"].replace(
            f"{resident} B", f"{price} B")}] + jrecs[1:])
    assert [r["state"] for r in recs] == ["refused", "done"]
    torch_serve.hold_results(recs, jrecs)
    assert int(np.load(recs[1]["result"])["chunks"]) >= 2


EVICT = {"n": 64, "d": 3, "rule": "minority", "max_sweeps": 256,
         "chunk_sweeps": 2}


def test_timeout_evicts_then_escalates_to_done(tmp_path):
    """A 50 ms slice evicts attempt 1 (journal serve.evict and a durable
    eviction checkpoint), the ×4 escalation finishes the replay, and the
    result equals the uninterrupted run's and the JAX package's."""
    from graphdyn_torch.utils.io import load_results_npz

    roots = {}
    for name, mod, make in (("port", tspool,
                             lambda sp: tworker.Worker(sp, device="cpu")),
                            ("jax", jspool, lambda sp: jworker.Worker(sp))):
        sp = mod.Spool(str(tmp_path / name))
        jid = sp.submit(dict(EVICT), "tim", timeout_s=0.05)
        make(sp).run_until_drained()
        rec = sp.load(jid)
        assert rec["state"] == "done" and rec["requeues"] >= 1, rec
        ops = [e["op"] for e in torch_serve.journal_events(sp.root)]
        assert ops.count("serve.evict") >= 1
        assert ops.count("serve.evict") == ops.count("serve.requeue")
        assert os.path.exists(os.path.join(sp.root, "evict", jid + ".npz"))
        roots[name] = rec
    assert not shutdown_requested()              # the flag was cleared
    twin = tspool.Spool(str(tmp_path / "twin"))
    tjid = twin.submit(dict(EVICT), "tim")
    tworker.Worker(twin, device="cpu").run_until_drained()
    got = load_results_npz(roots["port"]["result"])
    want = load_results_npz(twin.load(tjid)["result"])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert torch_serve.hold_fused(
        roots["port"]["spec"], got,
        load_results_npz(roots["jax"]["result"])) in ("bit-exact",
                                                      "near-tie")


def test_deadline_after_the_last_boundary_leaves_no_flag(tmp_path,
                                                         monkeypatch):
    """A job that completes after its deadline fired (no boundary left to
    honour it) is done, and the deadline's flag does not stop the
    server."""
    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.search import fused as tsf
    from graphdyn_torch.serve.bucketing import _sa_config

    spec = tspool.normalize_spec(dict(SMALL))
    done = tsf.fused_anneal(random_regular_graph(24, 3, seed=0),
                            _sa_config(spec), max_sweeps=16, device="cpu")

    def slow(*a, **k):
        # a job with no boundary after its deadline fires
        time.sleep(0.3)
        return done

    monkeypatch.setattr(tsf, "fused_anneal", slow)
    sp = tspool.Spool(str(tmp_path / "spool"))
    jid = sp.submit(dict(SMALL), "tim", timeout_s=0.05)
    other = sp.submit(dict(SMALL), "alice")
    assert tlife.run_service(sp.root, idle_exit_s=0.0, device="cpu",
                             warm=False) == 0
    assert sp.load(jid)["state"] == sp.load(other)["state"] == "done"
    assert sp.load(jid)["requeues"] == 0
    assert not shutdown_requested()


def test_server_deadline_after_a_timed_jobs_last_boundary_stops_it(
        tmp_path, monkeypatch):
    """The server's own deadline (the CLI's ``--deadline`` watchdog)
    firing while a timed job runs past its last boundary is not the job's
    flag to clear: the job is done and the service exits 75, leaving the
    next job pending."""
    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.resilience.shutdown import EX_TEMPFAIL, clear_shutdown
    from graphdyn_torch.resilience.supervisor import supervision
    from graphdyn_torch.search import fused as tsf
    from graphdyn_torch.serve.bucketing import _sa_config

    spec = tspool.normalize_spec(dict(SMALL))
    done = tsf.fused_anneal(random_regular_graph(24, 3, seed=0),
                            _sa_config(spec), max_sweeps=16, device="cpu")
    outer = {}

    def slow(*a, **k):
        # no boundary: the job's 50 ms deadline and then the server's fire
        # while it runs
        t0 = time.monotonic()
        while (not outer["wd"].deadline_fired
               and time.monotonic() - t0 < 30.0):
            time.sleep(0.01)
        return done

    monkeypatch.setattr(tsf, "fused_anneal", slow)
    sp = tspool.Spool(str(tmp_path / "spool"))
    jid = sp.submit(dict(SMALL), "tim", timeout_s=0.05)
    other = sp.submit(dict(SMALL), "alice")
    try:
        with supervision(None, 2.0, poll_s=0.01) as outer["wd"]:
            rc = tlife.run_service(sp.root, idle_exit_s=0.0, device="cpu",
                                   warm=False)
        assert outer["wd"].deadline_fired
        assert rc == EX_TEMPFAIL
        assert sp.load(jid)["state"] == "done"
        assert sp.load(jid)["requeues"] == 0
        assert sp.load(other)["state"] == "pending"
    finally:
        clear_shutdown()


def test_quarantine_after_two_crashes_alike(tmp_path):
    """A spec that passes admission but crashes the solver is requeued
    once and quarantined at the bar; the next tenant's job still runs."""
    recs = {}
    for name, mod, make in (("port", tspool,
                             lambda sp: tworker.Worker(sp, device="cpu",
                                                       quarantine_after=2)),
                            ("jax", jspool,
                             lambda sp: jworker.Worker(sp,
                                                       quarantine_after=2))):
        sp = mod.Spool(str(tmp_path / name))
        sp.submit({**SMALL, "rule": "no-such-rule"}, "mallory")
        sp.submit(dict(SMALL), "alice")
        make(sp).run_until_drained()
        recs[name] = sp.jobs()
    torch_serve.same_records(recs["port"], recs["jax"])
    assert recs["port"][0]["state"] == "quarantined"
    assert recs["port"][0]["crashes"] == 1
    assert "2 crash(es) at serve.job:ValueError" == recs["port"][0]["reason"]
    assert recs["port"][1]["state"] == "done"
    ops = [e["op"] for e in torch_serve.journal_events(
        str(tmp_path / "port"))]
    assert ops == [e["op"] for e in torch_serve.journal_events(
        str(tmp_path / "jax"))]
    assert "serve.quarantine" in ops


def test_refused_k4_launch_is_a_named_crash_not_a_plain_rerun(tmp_path,
                                                              monkeypatch):
    """K4′ refusing a launch (a grid that cannot be co-resident) is a crash
    at ``serve.job:fused_chunk``: requeued, then quarantined, never run on
    the plain version."""
    from graphdyn_torch.search import fused as tsf

    calls = []

    def refused(*a, **k):
        calls.append(k.get("kernel"))
        raise RuntimeError("fused_chunk: kernel launch failed, cudaError 720")

    monkeypatch.setattr(tsf, "fused_anneal", refused)
    sp = tspool.Spool(str(tmp_path / "spool"))
    jid = sp.submit(dict(SMALL), "alice")
    tworker.Worker(sp, device="cpu").run_until_drained()
    rec = sp.load(jid)
    assert rec["state"] == "quarantined"
    assert rec["reason"] == "2 crash(es) at serve.job:fused_chunk"
    assert calls == ["auto", "auto"]
    assert os.path.exists("obs_postmortem.jsonl")


def test_dispatch_transient_fault_retried_then_requeued_alike(tmp_path):
    """``serve.dispatch`` 'raise' is a transient unavailability: one blip
    is absorbed by the retry (the job finishes); a storm exhausts the
    budget and requeues the job; the server survives either way."""
    recs, ops = {}, {}
    for name, mod, make, fmod in (
            ("port", tspool, lambda sp: tworker.Worker(
                sp, device="cpu", retry=TRetry(
                    tries=3, base_delay_s=0.001, max_delay_s=0.002,
                    jitter=True)), tfaults),
            ("jax", jspool, lambda sp: jworker.Worker(sp, retry=JRetry(
                tries=3, base_delay_s=0.001, max_delay_s=0.002,
                jitter=True)), jfaults)):
        sp = mod.Spool(str(tmp_path / name))
        w = make(sp)
        jid = sp.submit(dict(SMALL), "alice")
        with fmod.FaultPlan([fmod.FaultSpec("serve.dispatch", action="raise",
                                            at=1, count=1)]):
            w.run_until_drained()
        assert sp.load(jid)["state"] == "done"
        jid2 = sp.submit(dict(SMALL), "bob")
        with fmod.FaultPlan([fmod.FaultSpec("serve.dispatch", action="raise",
                                            at=1, count=99)]):
            assert w.step()
        rec = sp.load(jid2)
        assert rec["state"] == "pending" and rec["requeues"] == 1
        assert "dispatch retries exhausted" in rec["reason"]
        w.run_until_drained()
        recs[name] = sp.jobs()
        ops[name] = torch_serve.journal_events(sp.root)
    torch_serve.same_records(recs["port"], recs["jax"])
    assert ops["port"] == ops["jax"]


def test_worker_background_thread_face(tmp_path):
    """start()/stop(): the ``graphdyn-serve-worker`` thread drains
    submissions arriving while it runs, and stop() joins bounded."""
    sp = tspool.Spool(str(tmp_path / "spool"))
    w = tworker.Worker(sp, poll_s=0.01, device="cpu").start()
    try:
        assert w._thread.name == "graphdyn-serve-worker"
        jid = sp.submit(dict(SMALL), "alice")
        deadline = time.monotonic() + 60.0
        while (sp.load(jid)["state"] != "done"
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert sp.load(jid)["state"] == "done"
    finally:
        w.stop(timeout_s=30.0)
    assert w._thread is None


def test_run_service_recovers_drains_and_exits_clean_alike(tmp_path,
                                                           monkeypatch):
    """Boot order: recover the orphan, refuse the oversized, drain, exit 0
    on idle, in both packages, with equal records and journals."""
    monkeypatch.setenv("GRAPHDYN_SERVE_HBM_BUDGET", str(torch_serve.BUDGET))
    recs, ops = {}, {}
    for name, mod, run in (
            ("port", tspool, lambda root: tlife.run_service(
                root, idle_exit_s=0.1, device="cpu")),
            ("jax", jspool, lambda root: jlife.run_service(
                root, idle_exit_s=0.1))):
        sp = mod.Spool(str(tmp_path / name))
        orphan = sp.submit(dict(SMALL), "alice")
        sp.claim()                               # a killed worker's leftover
        sp.submit({"n": 200000, "d": 3, "replicas": 4096}, "carol")
        sp.submit({**SMALL, "seed": 7}, "bob")
        assert run(sp.root) == 0
        counts = sp.counts()
        assert counts["done"] == 2 and counts["refused"] == 1
        assert sp.load(orphan)["requeues"] == 1
        recs[name], ops[name] = sp.jobs(), torch_serve.journal_events(sp.root)
    torch_serve.same_records(recs["port"], recs["jax"])
    assert ops["port"] == ops["jax"]
    assert any("recovered" in (e.get("reason") or "") for e in ops["port"])
    torch_serve.hold_results(recs["port"], recs["jax"])
