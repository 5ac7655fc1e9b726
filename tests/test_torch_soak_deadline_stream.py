"""The port's bounded soak matrix, its ``entropy`` and ``stream``
scenarios (``tests/torch_soak.py``): the deadline preemption of the
``entropy`` ladder and the streamed rollout preempted twice mid-churn,
each bit-exact against the fault-free oracle with a valid journal and
flight story."""

import pytest

import torch_soak

NAMES = ["deadline_preempt", "stream_churn"]


@pytest.fixture(scope="module")
def oracle_cache():
    return {}


@pytest.mark.parametrize("name,seed", torch_soak.cases(NAMES))
def test_soak_deadline_stream_scenario(name, seed, tmp_path_factory,
                                      oracle_cache, monkeypatch):
    root = tmp_path_factory.getbasetemp() / "soak_deadline_stream"
    monkeypatch.chdir(tmp_path_factory.mktemp("cwd"))
    torch_soak.run_and_check(name, seed, str(root), oracle_cache)
