"""The port's bounded soak matrix, its ``entropy`` mirror scenarios
(``tests/torch_soak.py``): the primary directory lost and resumed from the
mirror, and the degraded mirror, each bit-exact against the fault-free
oracle with a valid journal and flight story."""

import pytest

import torch_soak

NAMES = ["mirror_failover", "mirror_degraded"]


@pytest.fixture(scope="module")
def oracle_cache():
    return {}


@pytest.mark.parametrize("name,seed", torch_soak.cases(NAMES))
def test_soak_entropy_stream_scenario(name, seed, tmp_path_factory,
                                      oracle_cache, monkeypatch):
    root = tmp_path_factory.getbasetemp() / "soak_entropy"
    monkeypatch.chdir(tmp_path_factory.mktemp("cwd"))
    torch_soak.run_and_check(name, seed, str(root), oracle_cache)
