"""The port's sharded streamed jobs and ``serve`` command line against the
JAX package's: a ``shards=2`` job served by a worker with ``n_devices=2``
(two spawned gloo ranks) equal bit for bit to the same job at ``shards=1``
and to the JAX package's served ``shards=2`` job; the refusal of a shard
count beyond the worker's devices, at admission and again in the worker; a
deadline during the ranks ends them and evicts the job; and ``serve
submit/run/status/result/queue --device cpu`` printing the JAX CLI's JSON
keys."""

import json
import os

import numpy as np
import pytest
import torch

from graphdyn.graphs import powerlaw_graph as j_powerlaw
from graphdyn.serve import spool as jspool
from graphdyn.serve import worker as jworker
from graphdyn_torch.serve import spool as tspool
from graphdyn_torch.serve import worker as tworker
from graphdyn_torch.serve.admission import DeclaredShapeMismatch

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
    monkeypatch.chdir(tmp_path)


def _shape(n=512):
    g = j_powerlaw(n, gamma=2.5, dmin=2, seed=0)
    return {"n": n, "d": 2, "gamma": 2.5, "edges": int(g.edges.shape[0]),
            "dmax": int(g.deg.max()), "replicas": 32, "max_sweeps": 4,
            "solver": "streamed"}


def test_sharded_job_over_gloo_ranks_equals_unsharded_and_jax(tmp_path):
    shape = _shape()
    tsp = tspool.Spool(str(tmp_path / "port"))
    solo = tsp.submit(shape, "t1")
    duo = tsp.submit({**shape, "shards": 2}, "t1")
    assert tworker.Worker(tsp, device="cpu", n_devices=2
                          ).run_until_drained() == 2
    jsp = jspool.Spool(str(tmp_path / "jax"))
    jsp.submit(shape, "t1")
    jsp.submit({**shape, "shards": 2}, "t1")
    assert jworker.Worker(jsp).run_until_drained() == 2
    recs = tsp.jobs()
    torch_serve.same_records(recs, jsp.jobs())
    assert [r["state"] for r in recs] == ["done", "done"]
    torch_serve.hold_results(recs, jsp.jobs())
    a, b = np.load(tsp.load(solo)["result"]), np.load(tsp.load(duo)["result"])
    assert int(b["shards"]) == 2 and int(a["shards"]) == 1
    np.testing.assert_array_equal(b["conf"], a["conf"])
    np.testing.assert_array_equal(b["m_end"], a["m_end"])


def test_shards_beyond_the_devices_refused_at_admission_and_in_the_worker(
        tmp_path):
    from unittest import mock

    shape = {**_shape(128), "shards": 2}
    tsp = tspool.Spool(str(tmp_path / "port"))
    tjid = tsp.submit(shape, "t1")
    tworker.Worker(tsp, device="cpu").run_until_drained()   # 1 device
    jsp = jspool.Spool(str(tmp_path / "jax"))
    jjid = jsp.submit(shape, "t1")
    with mock.patch("jax.devices", return_value=[object()]):
        jworker.Worker(jsp).run_until_drained()
    rec = tsp.load(tjid)
    assert rec["state"] == "refused" and "1 devices" in rec["reason"]
    assert rec["reason"] == jsp.load(jjid)["reason"]
    # a job admitted on a larger host: the worker refuses it again
    from graphdyn_torch.graphs import powerlaw_graph
    from graphdyn_torch.ops.packed import pack_spins

    g = powerlaw_graph(128, gamma=2.5, dmin=2, seed=0)
    w = tworker.Worker(tsp, device="cpu", n_devices=1)
    with pytest.raises(DeclaredShapeMismatch, match="this worker has 1 "
                       "devices"):
        w._run_sharded(tspool.normalize_spec(shape), g,
                       pack_spins(np.ones((32, 128), np.int8)), 1, 2,
                       torch_serve.BUDGET)


def test_deadline_during_the_ranks_ends_them_and_evicts(tmp_path,
                                                        monkeypatch):
    """The worker hands ``run_ranks`` the job's remaining time and the
    shutdown flag as its stop test; a deadline firing while the ranks run
    ends them, and the job is evicted, then served in full."""
    import time

    from graphdyn_torch.scripts import halo_ranks

    real = halo_ranks.run_ranks
    seen = []

    def first_waits(fn, world, *args, stop=None, timeout=None, **kw):
        seen.append((world, timeout))
        if len(seen) == 1:
            t0 = time.monotonic()
            while not stop() and time.monotonic() - t0 < 30:
                time.sleep(0.01)
            raise RuntimeError("rank 0 of _sharded_rank failed: killed")
        return real(fn, world, *args, stop=stop, timeout=timeout, **kw)

    monkeypatch.setattr(halo_ranks, "run_ranks", first_waits)
    sp = tspool.Spool(str(tmp_path / "spool"))
    jid = sp.submit({**_shape(128), "shards": 2}, "t1", timeout_s=0.5)
    tworker.Worker(sp, device="cpu", n_devices=2).run_until_drained()
    rec = sp.load(jid)
    assert rec["state"] == "done" and rec["requeues"] >= 1, rec
    assert seen[0][0] == 2 and seen[0][1] <= 1.0     # max(left, 1 s)
    ops = [e["op"] for e in torch_serve.journal_events(sp.root)]
    assert "serve.evict" in ops


def test_run_ranks_stop_ends_the_ranks_early(tmp_path):
    import time

    import torch_ranks
    from graphdyn_torch.scripts.halo_ranks import run_ranks

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="left no result"):
        run_ranks(torch_ranks.stall_worker, 2, device="cpu", backend="gloo",
                  root=str(tmp_path / "ranks"), timeout=120,
                  stop=lambda: time.monotonic() - t0 > 1.0)
    assert time.monotonic() - t0 < 30


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip()
    return rc, (json.loads(out.splitlines()[-1]) if out else None)


def test_serve_cli_prints_the_jax_cli_keys(tmp_path, capsys):
    from graphdyn.cli import main as jmain
    from graphdyn_torch.cli import main as tmain

    docs = {}
    for name, main, dev in (("port", tmain, ["--device", "cpu"]),
                            ("jax", jmain, [])):
        root = str(tmp_path / name)
        d = docs[name] = {}
        rc, d["submit"] = _cli(main, ["serve", "submit", "--root", root,
                                      "--tenant", "alice", "--n", "24",
                                      "--max-sweeps", "16",
                                      "--chunk-sweeps", "8"], capsys)
        assert rc == 0
        _cli(main, ["serve", "submit", "--root", root, "--tenant", "bob",
                    "--solver", "bucketed", "--n", "64", "--d", "2",
                    "--edges", "1"], capsys)
        rc, d["queue0"] = _cli(main, ["serve", "queue", "--root", root],
                               capsys)
        rc, _ = _cli(main, ["serve", "run", "--root", root, "--idle-exit",
                            "0.1", *dev], capsys)
        assert rc == 0
        jid = d["submit"]["job"]
        _, d["status"] = _cli(main, ["serve", "status", jid, "--root",
                                     root], capsys)
        _, d["result"] = _cli(main, ["serve", "result", jid, "--root",
                                     root], capsys)
        _, d["queue"] = _cli(main, ["serve", "queue", "--root", root],
                             capsys)
        with pytest.raises(SystemExit, match="needs a job id"):
            main(["serve", "status", "--root", root])
    t, j = docs["port"], docs["jax"]
    assert t["submit"]["job"] == j["submit"]["job"] == "j000001-alice"
    assert sorted(t["submit"]) == sorted(j["submit"])
    assert t["queue0"] == j["queue0"] and t["queue"] == j["queue"]
    assert t["queue"] == {"pending": 0, "running": 0, "done": 1,
                          "refused": 1, "quarantined": 0}
    torch_serve.same_records([t["status"]], [j["status"]])
    assert sorted(t["result"]) == sorted(j["result"])
    assert t["result"]["keys"] == j["result"]["keys"] == [
        "conf", "m_end", "mag_reached", "steps_to_target"]
    for k in ("m_end_mean", "mag_reached"):
        assert t["result"][k] == j["result"][k]
    assert os.path.basename(t["result"]["result"]) == \
        os.path.basename(j["result"]["result"])
