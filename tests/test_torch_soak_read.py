"""The port's bounded soak matrix, its truncated-read scenario
(``tests/torch_soak.py``): the published snapshot truncated between
episodes, the requeue falling back to a retained version, bit-exact against
the fault-free oracle with a valid journal and flight story."""

import pytest

import torch_soak

NAMES = ["truncated_read"]


@pytest.fixture(scope="module")
def oracle_cache():
    return {}


@pytest.mark.parametrize("name,seed", torch_soak.cases(NAMES))
def test_soak_truncated_read_scenario(name, seed, tmp_path_factory,
                                      oracle_cache, monkeypatch):
    root = tmp_path_factory.getbasetemp() / "soak_read"
    monkeypatch.chdir(tmp_path_factory.mktemp("cwd"))
    torch_soak.run_and_check(name, seed, str(root), oracle_cache)
