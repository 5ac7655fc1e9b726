"""The port's bounded soak matrix, its supervised scenarios
(``tests/torch_soak.py``): a stall detected by the watchdog and restarted
by the supervisor to a bit-exact finish, and a crash loop quarantined after
its restarts (no results file, bundled post-mortems, exit 86)."""

import pytest

import torch_soak

NAMES = ["hang_detect", "crash_loop_quarantine"]


@pytest.fixture(scope="module")
def oracle_cache():
    return {}


@pytest.mark.parametrize("name,seed", torch_soak.cases(NAMES))
def test_soak_supervised_scenario(name, seed, tmp_path_factory, oracle_cache,
                                  monkeypatch):
    root = tmp_path_factory.getbasetemp() / "soak_supervised"
    monkeypatch.chdir(tmp_path_factory.mktemp("cwd"))
    torch_soak.run_and_check(name, seed, str(root), oracle_cache)
