"""The port's two race-checker soak scenarios (``tests/torch_soak.py``) on
the CPU, against the JAX package's contract
(``graphdyn/resilience/soak.py:325-336``):

- ``race_mirror_exit``: real child processes under ``GRAPHDYN_RACECHECK=1``
  and ``GRAPHDYN_RACEFUZZ=<seed>`` make four durable saves with every
  write-behind copy stalled (``mirror.copy``) and exit; the atexit
  ``flush_mirror`` delivers the last replica, and at the pinned seed 0 the
  control child with that registration undone loses it;
- ``race_prefetch_close``: the prefetcher under the seeded lock jitter
  closes mid-stream with no deadlock and no leaked worker, its fuzzed
  stream equals the synchronous builds, and its overlap gauge lands once.
"""

import threading

import pytest
import torch

import torch_soak
from graphdyn_torch.analysis import racecheck
from graphdyn_torch.resilience import soak


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_race_mirror_exit_green_and_pinned_control_red(tmp_path):
    rep = torch_soak.run_and_check("race_mirror_exit", soak.RACE_PIN_SEED,
                                   str(tmp_path), {})
    assert rep["control_lost_replica"] is True
    assert [e["episode"] for e in rep["episodes"]] == ["green", "reverted"]
    assert all(e["rc"] == 0 for e in rep["episodes"])
    assert {"save", "mirror.save"} <= set(rep["journal_ops"])


def test_race_mirror_exit_unpinned_seed_runs_no_control(tmp_path):
    rep = torch_soak.run_and_check("race_mirror_exit", 1, str(tmp_path), {})
    assert rep["control_lost_replica"] is None
    assert [e["episode"] for e in rep["episodes"]] == ["green"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_race_prefetch_close(seed, tmp_path):
    before = {t.ident for t in threading.enumerate()}
    torch_soak.run_and_check("race_prefetch_close", seed, str(tmp_path), {})
    assert not racecheck.installed()          # the scenario uninstalled
    leaked = [t for t in threading.enumerate()
              if t.ident not in before and t.name == soak.PREFETCH_THREAD]
    assert leaked == []
