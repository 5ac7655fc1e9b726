"""The port's bounded soak matrix, its other ``sa`` scenarios
(``tests/torch_soak.py``): bit rot caught by the checksum manifest and
the requeue storm, each bit-exact against the fault-free oracle with a valid
journal and flight story."""

import pytest

import torch_soak

NAMES = ["bitrot", "requeue_storm"]


@pytest.fixture(scope="module")
def oracle_cache():
    return {}


@pytest.mark.parametrize("name,seed", torch_soak.cases(NAMES))
def test_soak_sa_storm_scenario(name, seed, tmp_path_factory, oracle_cache,
                          monkeypatch):
    root = tmp_path_factory.getbasetemp() / "soak_sa_storm"
    monkeypatch.chdir(tmp_path_factory.mktemp("cwd"))
    torch_soak.run_and_check(name, seed, str(root), oracle_cache)
