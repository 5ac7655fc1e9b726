"""The port's bounded soak matrix, its ``serve_kill_requeue`` scenario
(``tests/torch_soak.py``), one seed on the CPU: tenants submit to a spool
with no server alive, a serving child process is hard-killed at
``serve.dispatch`` and a fresh one recovers the orphaned job from disk;
every accepted job bit-exact against the fault-free oracle, the oversized
job refused with the byte model's reason, and a valid spool journal
carrying ``serve.submit/refuse/requeue/evict/done``."""

import pytest

import torch_soak

NAMES = ["serve_kill_requeue"]


@pytest.fixture(scope="module")
def oracle_cache():
    return {}


@pytest.mark.parametrize("name,seed", [(n, 0) for n in NAMES])
def test_soak_serve_scenario(name, seed, tmp_path_factory, oracle_cache,
                             monkeypatch):
    root = tmp_path_factory.getbasetemp() / "soak_serve"
    monkeypatch.chdir(tmp_path_factory.mktemp("cwd"))
    rep = torch_soak.run_and_check(name, seed, str(root), oracle_cache)
    assert [e["rc"] for e in rep["episodes"]] == [75, 0]
