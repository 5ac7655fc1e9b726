"""The port's chaos soak harness (``graphdyn_torch.resilience.soak``): the
catalogue's shape (the 11 ported scenarios with their evidence, the 4 left
out refused with their ROADMAP.md item wherever they are named), the
command line, and the card refusal. The bounded matrix itself runs in
``tests/test_torch_soak_*.py`` (six files, so that ``--dist loadfile``
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
          "stream_churn"}
LEFT_OUT = {"stream_shard_requeue": "A15b", "race_mirror_exit": "A18",
            "race_prefetch_close": "A18", "serve_kill_requeue": "A19"}


def test_catalogue_shape_matches_the_jax_package():
    assert set(soak.SCENARIOS) == PORTED
    assert set(soak.NOT_PORTED) == set(LEFT_OUT)
    assert set(soak.SCENARIOS) | set(soak.NOT_PORTED) == set(jsoak.SCENARIOS)
    for name, scn in soak.SCENARIOS.items():
        j = jsoak.SCENARIOS[name]
        assert (scn.workload, scn.mirror, scn.require_ops, scn.require_flight,
                scn.mode) == (j.workload, j.mirror, j.require_ops,
                              j.require_flight, j.mode), name
    assert soak.BOUNDED_SEEDS == jsoak.BOUNDED_SEEDS
    assert len(soak.BOUNDED_SEEDS) >= 3


@pytest.mark.parametrize("name", sorted(PORTED - {"hang_detect",
                                                  "crash_loop_quarantine"}))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_episode_plans_match_the_jax_package(name, seed):
    import numpy as np

    got = soak._plan_episodes(name, np.random.default_rng(seed))
    want = jsoak._plan_episodes(name, np.random.default_rng(seed))
    assert [vars(e) for e in got] == [vars(e) for e in want]


def test_workloads_are_the_jax_package_lines_on_a_device():
    for kind in ("sa", "entropy", "stream"):
        got = soak._workload_args(kind, "o.npz", "ck", "m", "cpu")
        want = jsoak._workload_args(kind, "o.npz", "ck", "m")
        i = got.index("--device")
        assert got[i:i + 2] == ["--device", "cpu"]
        assert got[:i] + got[i + 2:] == want


@pytest.mark.parametrize("name,item", sorted(LEFT_OUT.items()))
def test_left_out_scenarios_raise_with_their_item(name, item, tmp_path):
    with pytest.raises(NotImplementedError, match=item):
        soak.run_scenario(name, 0, str(tmp_path), {}, "cpu")
    with pytest.raises(NotImplementedError, match=item):
        soak.run_soak(scenarios=[name], seeds=[0], device="cpu")
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as ex:
        soak.main(["--scenarios", f"torn_write,{name}", "--device", "cpu"])
    assert ex.value.code == 2 and item in err.getvalue()


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
