"""The port's job spool and client API (``graphdyn_torch.serve.spool``,
``graphdyn_torch.serve.api``) against the JAX package's
(``graphdyn.serve``): the same spec defaults, the same state machine, record
fields, job ids and journal ops through submit, claim, finish, refuse,
requeue, quarantine and recover; each package reading the other's spool;
and a restarted server process recovering a spool from disk alone."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from graphdyn.serve import api as japi
from graphdyn.serve import spool as jspool
from graphdyn_torch.serve import api as tapi
from graphdyn_torch.serve import spool as tspool

import torch_serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = torch_serve.SMALL


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


def test_spec_defaults_and_states_equal_the_jax_package():
    assert tspool.SPEC_DEFAULTS == jspool.SPEC_DEFAULTS
    assert tspool.STATES == jspool.STATES
    assert tspool.SPOOL_SCHEMA == jspool.SPOOL_SCHEMA


@pytest.mark.parametrize("spec", [
    {"n": 10}, dict(SMALL), {"solver": "bucketed", "n": 10, "edges": 40,
                             "gamma": 2.2},
    {"solver": "streamed", "n": 512, "edges": 900, "dmax": 40, "shards": 2},
    {},
])
def test_normalize_spec_equal(spec):
    assert tspool.normalize_spec(spec) == jspool.normalize_spec(spec)


def test_normalize_spec_rejects_unknown_keys_alike():
    with pytest.raises(ValueError) as jx:
        jspool.normalize_spec({"banana": 1, "n": 3})
    with pytest.raises(ValueError) as tx:
        tspool.normalize_spec({"banana": 1, "n": 3})
    assert str(tx.value) == str(jx.value)


def _transitions(mod, root: str) -> list[dict]:
    """Every transition of the state machine, driven the same way."""
    sp = mod.Spool(root)
    a = sp.submit(dict(SMALL), "alice")
    b = sp.submit({**SMALL, "seed": 3}, "bob", timeout_s=2.5)
    c = sp.submit({"n": 200000, "d": 3, "replicas": 4096}, "carol")
    d = sp.submit(dict(SMALL), "dave")
    e = sp.submit(dict(SMALL), "erin")
    assert sp.claim()["id"] == a
    sp.finish(a)
    sp.claim()
    sp.requeue(b, "preempted mid-run")
    sp.claim()                                   # b again (lowest pending)
    sp.requeue(b, "crashed", crashed=True)
    sp.refuse(c, "refused: too big")
    sp.claim()                                   # b
    sp.quarantine(b, "serve.job:ValueError", 2)
    assert sp.claim()["id"] == d                 # d running
    sp.claim()                                   # e running
    sp.finish(e)
    assert mod.Spool(root).recover() == [d]      # the killed worker's job
    assert sp.claim()["id"] == d
    assert sp.claim() is None
    return sp.jobs()


def test_state_machine_records_and_journal_equal(tmp_path):
    got = _transitions(tspool, str(tmp_path / "t"))
    want = _transitions(jspool, str(tmp_path / "j"))
    torch_serve.same_records(got, want)
    assert [r["state"] for r in got] == [
        "done", "quarantined", "refused", "running", "done"]
    assert [r["id"] for r in got] == ["j000001-alice", "j000002-bob",
                                      "j000003-carol", "j000004-dave",
                                      "j000005-erin"]
    ev_t = torch_serve.journal_events(str(tmp_path / "t"))
    ev_j = torch_serve.journal_events(str(tmp_path / "j"))
    assert ev_t == ev_j
    assert [e["op"] for e in ev_t] == [
        "serve.submit"] * 5 + ["serve.done", "serve.requeue",
                               "serve.requeue", "serve.refuse",
                               "serve.quarantine", "serve.done",
                               "serve.requeue"]
    assert tspool.Spool(str(tmp_path / "t")).counts() == \
        jspool.Spool(str(tmp_path / "j")).counts()


@pytest.mark.parametrize("writer,reader", [(jspool, tspool), (tspool, jspool)],
                         ids=["jax_writes", "port_writes"])
def test_each_package_serves_the_others_spool_records(tmp_path, writer,
                                                      reader):
    root = str(tmp_path / "spool")
    w = writer.Spool(root)
    ids = [w.submit({**SMALL, "seed": s}, t)
           for s, t in ((1, "b"), (2, "a"), (3, "c"))]
    w.claim()
    r = reader.Spool(root)
    assert r.recover() == [ids[0]]
    assert [r.claim()["id"] for _ in ids] == ids
    r.finish(ids[1])
    assert writer.Spool(root).load(ids[1])["state"] == "done"
    assert r.jobs() == writer.Spool(root).jobs()
    assert torch_serve.journal_events(root)


def test_restarted_server_process_recovers_from_disk_alone(tmp_path):
    """A fresh process against an existing port spool recovers every
    pending job from disk alone: no shared memory, no live server."""
    sp = tspool.Spool(str(tmp_path))
    ids = [sp.submit(dict(SMALL), "alice") for _ in range(3)]
    sp.claim()                                   # orphan one as running
    script = "\n".join([
        "import sys, json",
        f"sys.path.insert(0, {REPO!r})",
        "from graphdyn_torch.serve.spool import Spool",
        f"sp = Spool({str(tmp_path)!r})",
        "recovered = sp.recover()",
        "print(json.dumps({'recovered': recovered,",
        "                  'counts': sp.counts(),",
        "                  'jax': sorted(m for m in sys.modules",
        "                                if m.split('.')[0] in ('jax',",
        "                                                       'graphdyn'))}))",
    ])
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["recovered"] == [ids[0]]
    assert out["counts"]["pending"] == 3
    assert out["counts"]["running"] == 0
    assert out["jax"] == []


def test_api_equal_and_result_refuses_unfinished(tmp_path):
    roots = {m: str(tmp_path / n) for m, n in ((tapi, "t"), (japi, "j"))}
    ids = {m: m.submit(r, dict(SMALL), "alice", timeout_s=1.0)
           for m, r in roots.items()}
    assert ids[tapi] == ids[japi] == "j000001-alice"
    st_t, st_j = tapi.status(roots[tapi], ids[tapi]), \
        japi.status(roots[japi], ids[japi])
    torch_serve.same_records([st_t], [st_j])
    assert tapi.queue(roots[tapi]) == japi.queue(roots[japi])
    for m in (tapi, japi):
        with pytest.raises(RuntimeError, match="is 'pending', not done"):
            m.result(roots[m], ids[m])
    # a done job whose npz went missing: the same refusal
    for m, sp_mod in ((tapi, tspool), (japi, jspool)):
        sp = sp_mod.Spool(roots[m])
        sp.claim()
        sp.finish(ids[m])
        with pytest.raises(FileNotFoundError, match="result file is missing"):
            m.result(roots[m], ids[m])
        np.savez(sp.result_path(ids[m]), conf=np.ones((2, 3), np.int8),
                 m_end=np.zeros(2))
    got, want = tapi.result(roots[tapi], ids[tapi]), \
        japi.result(roots[japi], ids[japi])
    assert sorted(got) == sorted(want) == ["conf", "m_end"]
