"""The port's bounded soak matrix, its ``stream_shard_requeue`` scenario
(``tests/torch_soak.py``): the sharded stream (``--shards 4``, a job of
spawned gloo ranks, churn-driven repartition) preempted at a chunk
boundary mid-churn and requeued onto ``--shards 2``, bit-exact against the
fault-free oracle with a valid journal carrying ``stream.churn`` and
``stream.repartition`` and the flight story of rank 0."""

import pytest

import torch_soak

NAMES = ["stream_shard_requeue"]


@pytest.fixture(scope="module")
def oracle_cache():
    return {}


@pytest.mark.parametrize("name,seed", torch_soak.cases(NAMES))
def test_soak_stream_shard_scenario(name, seed, tmp_path_factory,
                                    oracle_cache, monkeypatch):
    root = tmp_path_factory.getbasetemp() / "soak_stream_shard"
    monkeypatch.chdir(tmp_path_factory.mktemp("cwd"))
    torch_soak.run_and_check(name, seed, str(root), oracle_cache)
