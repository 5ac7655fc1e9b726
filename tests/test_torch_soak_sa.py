"""The port's bounded soak matrix, its first two ``sa`` scenarios (one test
per scenario and seed; ``tests/torch_soak.py``): torn write, save ENOSPC
burst, each bit-exact against the fault-free oracle
with a valid journal and flight story."""

import pytest

import torch_soak

NAMES = ["torn_write", "write_degrade"]


@pytest.fixture(scope="module")
def oracle_cache():
    return {}


@pytest.mark.parametrize("name,seed", torch_soak.cases(NAMES))
def test_soak_sa_scenario(name, seed, tmp_path_factory, oracle_cache,
                          monkeypatch):
    root = tmp_path_factory.getbasetemp() / "soak_sa"
    monkeypatch.chdir(tmp_path_factory.mktemp("cwd"))
    torch_soak.run_and_check(name, seed, str(root), oracle_cache)
