"""The port's chaos soak harness (``graphdyn_torch.resilience.soak``): the
catalogue's shape (all 15 of the JAX package's scenarios, with their
evidence), the command line, and the card refusal. The bounded matrix itself runs in
``tests/test_torch_soak_*.py`` (eight files, so that ``--dist loadfile``
spreads it over the test workers)."""

import contextlib
import io
import json
import subprocess
import sys

import pytest
import torch

from graphdyn.resilience import soak as jsoak
from graphdyn_torch.resilience import soak

PORTED = {"torn_write", "write_degrade", "truncated_read", "bitrot",
          "mirror_failover", "mirror_degraded", "requeue_storm",
          "hang_detect", "deadline_preempt", "crash_loop_quarantine",
          "stream_churn", "stream_shard_requeue", "serve_kill_requeue",
          "race_mirror_exit", "race_prefetch_close"}


def test_catalogue_shape_matches_the_jax_package():
    assert set(soak.SCENARIOS) == PORTED == set(jsoak.SCENARIOS)
    for name, scn in soak.SCENARIOS.items():
        j = jsoak.SCENARIOS[name]
        assert (scn.workload, scn.mirror, scn.require_ops, scn.require_flight,
                scn.mode) == (j.workload, j.mirror, j.require_ops,
                              j.require_flight, j.mode), name
    assert soak.BOUNDED_SEEDS == jsoak.BOUNDED_SEEDS
    assert len(soak.BOUNDED_SEEDS) >= 3


# the supervised, serve and race scenarios plan no episode chain (their
# runners drive the supervisor, the serving or racing child processes, or
# the prefetcher directly)
@pytest.mark.parametrize("name", sorted(PORTED - {"hang_detect",
                                                  "crash_loop_quarantine",
                                                  "serve_kill_requeue",
                                                  "race_mirror_exit",
                                                  "race_prefetch_close"}))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_episode_plans_match_the_jax_package(name, seed):
    import numpy as np

    got = soak._plan_episodes(name, np.random.default_rng(seed))
    want = jsoak._plan_episodes(name, np.random.default_rng(seed))
    assert [vars(e) for e in got] == [vars(e) for e in want]


def test_workloads_are_the_jax_package_lines_on_a_device():
    for kind in ("sa", "entropy", "stream", "stream_shard"):
        got = soak._workload_args(kind, "o.npz", "ck", "m", "cpu")
        want = jsoak._workload_args(kind, "o.npz", "ck", "m")
        i = got.index("--device")
        assert got[i:i + 2] == ["--device", "cpu"]
        assert got[:i] + got[i + 2:] == want


def test_race_constants_are_the_jax_package_ones():
    for name in ("RACE_FUZZ_MAX_MS", "RACE_STALL_SECS", "RACE_SAVES",
                 "RACE_PIN_SEED", "SERVE_HBM_BUDGET"):
        assert getattr(soak, name) == getattr(jsoak, name), name


def test_list_and_card_refusal(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert soak.main(["--list"]) == 0
    names = [line.split()[0] for line in buf.getvalue().splitlines()]
    assert set(names) == PORTED
    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, "-m", "graphdyn_torch.resilience.soak",
         "--scenarios", "torn_write", "--seeds", "1", "--format", "json"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ,
             "PYTHONPATH": __import__("os").path.dirname(
                 __import__("os").path.dirname(__file__))})
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    with pytest.raises(RuntimeError, match="device='cpu'"):
        soak.run_soak(scenarios=["torn_write"], seeds=[0])


def test_json_report_names_its_device(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = soak.main(["--scenarios", "write_degrade", "--seeds", "1",
                        "--device", "cpu", "--format", "json",
                        "--root", str(tmp_path / "soak")])
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and doc["ok"] and doc["device"] == "cpu"
    assert doc["scenarios"] == 1 and doc["seeds"] == 1
