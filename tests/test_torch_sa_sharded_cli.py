"""The sharded commands of the port's CLI on spawned gloo ranks (P = 2):

- ``sa --sharded --shards 2`` (halo mode) prints the JAX package's JSON
  keys on rank 0 only (``"solver": "sa_sharded"``, ``"mesh"``,
  ``"node_mode"``), and equals the one-process run (``--shards 1``);
- a graceful-shutdown request on rank 1 alone (a SIGTERM's flag) makes
  both ranks snapshot and exit 75; the requeued job exits 0 on both ranks
  with the uninterrupted result;
- ``consensus --sharded`` prints the unsharded document on rank 0 only;
- the refusals of the JAX package's CLI, and those of a job smaller than
  the shards it asks for (the streamed layout, the sharded stream and the
  lane shards run since the slice after node sharding)."""

import json

import pytest

from graphdyn_torch.cli import main

import torch_ranks

JAX_SA_KEYS = ["solver", "mesh", "node_mode", "mag_reached", "num_steps",
               "m_final", "out"]
SA = ["sa", "--sharded", "--device", "cpu", "--n", "60", "--d", "3", "--p",
      "1", "--n-replicas", "4", "--max-steps", "400", "--chunk-steps", "32",
      "--seed", "2"]


def _json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_sa_sharded_cli_rank0_output_and_preemption(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.chdir(tmp_path)
    assert main(SA + ["--shards", "1"]) == 0
    want = _json(capsys.readouterr().out)
    ck = str(tmp_path / "ck" / "sa")
    argv = SA + ["--shards", "2", "--checkpoint", ck,
                 "--checkpoint-interval", "0"]
    res = torch_ranks.run_ranks(
        "cli_worker", 2, str(tmp_path / "ranks"), SA + ["--shards", "2"],
        [None], str(tmp_path / "plain"))
    (rc0, out0), = res[0]
    (rc1, out1), = res[1]
    assert rc0 == rc1 == 0 and out1 == ""
    doc = _json(out0)
    assert list(doc) == JAX_SA_KEYS
    assert doc["mesh"] == {"replica": 1, "node": 2}
    assert doc["node_mode"] == "halo"
    for k in ("mag_reached", "num_steps", "m_final"):
        assert doc[k] == want[k], k
    # SIGTERM on rank 1 only: both ranks snapshot and exit 75; the requeue
    # finishes on both with the uninterrupted result
    res = torch_ranks.run_ranks("cli_worker", 2, str(tmp_path / "pre"), argv,
                                [(1, 2), None], str(tmp_path / "pre"))
    assert [leg[0] for leg in res[0]] == [75, 0]
    assert [leg[0] for leg in res[1]] == [75, 0]
    assert res[1][1][1] == ""
    doc = _json(res[0][1][1])
    for k in ("mag_reached", "num_steps", "m_final"):
        assert doc[k] == want[k], k


def test_consensus_sharded_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["consensus", "--device", "cpu", "--n", "300", "--replicas",
            "128", "--m0", "0.0", "0.3", "--max-steps", "30"]
    assert main(argv) == 0
    want = _json(capsys.readouterr().out)
    res = torch_ranks.run_ranks("cli_worker", 2, str(tmp_path / "r"),
                                argv + ["--sharded"], [None],
                                str(tmp_path / "r"))
    (rc0, out0), = res[0]
    (rc1, out1), = res[1]
    assert rc0 == rc1 == 0 and out1 == ""
    assert _json(out0) == want


@pytest.mark.parametrize("extra,match", [
    (["--shards", "2"], "pass --sharded as well"),
    (["--sharded", "--layout", "bucketed"], "per-repetition driver layout"),
    (["--sharded", "--layout", "streamed", "--shards", "3"],
     "ranks in the job"),
    (["--sharded", "--shards", "2", "--rollout-mode", "lightcone"],
     "no node axis to shard"),
    (["--sharded", "--shards", "0"], "must be >= 1"),
    (["--sharded", "--shards", "3"], "ranks in the job"),
])
def test_sa_sharded_refusals(extra, match, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["sa", "--device", "cpu", "--n", "40", "--d", "3"]
    with pytest.raises(SystemExit, match=match):
        main(base + extra)


@pytest.mark.parametrize("argv,match", [
    (["temper", "--lane-shards", "2"], "needs a job of 2 ranks"),
    (["stream", "--shards", "2"], "--shards 2 > 1 ranks in the job"),
    (["stream", "--shards", "4", "--hub-threshold", "9"],
     "--shards 4 > 1 ranks in the job"),
], ids=["argv0", "argv1", "argv2"])
def test_a15b_refusals(argv, match, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=match):
        main(argv + ["--device", "cpu"])
