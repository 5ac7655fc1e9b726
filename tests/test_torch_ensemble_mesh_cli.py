"""The sharded commands this slice adds to the port's CLI, on spawned gloo
ranks (one spawn of 2 ranks for the module), each printed by rank 0 only
and equal to the one-process command, after ``tests/test_search.py:460``
and the JAX package's ``stream --shards`` path (``graphdyn/cli.py:
1012-1054``):

- ``temper --lane-shards 2`` equals ``temper`` without it;
- ``stream --shards 2 --hub-threshold 17`` with churn equals ``stream
  --shards 1`` (npz and JSON), and repartitions twice with 22 mutations, as
  the JAX package's command does at these arguments;
- ``sa --sharded --layout streamed --shards 2`` equals ``--shards 1``."""

import contextlib
import io
import json

import numpy as np
import pytest

from graphdyn_torch.cli import main

import torch_ranks

TEMPER = ["temper", "--device", "cpu", "--n", "96", "--d", "3", "--lanes",
          "4", "--swap-interval", "200", "--m-target", "0.9",
          "--stop-on-first", "--max-steps", "20000", "--seed", "1"]
STREAM = ["stream", "--device", "cpu", "--n", "160", "--gamma", "2.3",
          "--dmin", "2", "--steps", "5", "--chunks", "2", "--replicas",
          "32", "--seed", "0", "--churn-rate", "12.0", "--churn-seed", "25"]
SA = ["sa", "--device", "cpu", "--n", "40", "--d", "3", "--sharded",
      "--layout", "streamed", "--n-replicas", "4", "--max-steps", "40",
      "--stream-chunks", "2", "--seed", "3"]


def _argvs(root):
    return {
        "temper": TEMPER + ["--lane-shards", "2"],
        "stream": STREAM + ["--shards", "2", "--hub-threshold", "17",
                            "--out", f"{root}/s2.npz"],
        "sa": SA + ["--shards", "2"],
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_cli"))
    out = {}
    for key, argv in _argvs(root).items():
        out[key] = torch_ranks.run_ranks("cli_worker", 2, root, argv, [None],
                                         f"{root}/{key}")
    return out, root


def _one_process(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _rank0(res):
    (rc0, out0), = res[0]
    (rc1, out1), = res[1]
    assert rc0 == rc1 == 0 and out1 == ""
    return json.loads(out0.strip().splitlines()[-1])


def test_temper_lane_shards_cli(ranks, tmp_path, monkeypatch):
    res, _ = ranks
    got = _rank0(res["temper"])
    monkeypatch.chdir(tmp_path)
    want = _one_process(TEMPER)
    assert got["lane_shards"] == 2 and want["lane_shards"] is None
    for k in want:
        if k != "lane_shards":
            assert got[k] == want[k], k
    assert got["steps_to_target"] >= 0


def test_stream_shards_cli_equals_one_shard(ranks, tmp_path, monkeypatch):
    res, root = ranks
    got = _rank0(res["stream"])
    monkeypatch.chdir(tmp_path)
    want = _one_process(STREAM + ["--shards", "1", "--out",
                                  str(tmp_path / "s1.npz")])
    assert got["shards"] == 2 and got["repartitions"] == 2
    assert got["mutations"] == want["mutations"] == 22
    assert got["m_end_mean"] == want["m_end_mean"]
    a, b = np.load(tmp_path / "s1.npz"), np.load(f"{root}/s2.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_sa_sharded_streamed_cli_equals_one_shard(ranks, tmp_path,
                                                  monkeypatch):
    res, _ = ranks
    got = _rank0(res["sa"])
    monkeypatch.chdir(tmp_path)
    want = _one_process(SA + ["--shards", "1"])
    assert got["mesh"] == {"replica": 1, "node": 2}
    assert got["node_mode"] == want["node_mode"] == "gather"
    for k in ("mag_reached", "num_steps", "m_final"):
        assert got[k] == want[k], k
