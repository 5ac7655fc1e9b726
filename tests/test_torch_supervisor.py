"""The port's supervised execution (``graphdyn_torch.resilience.supervisor``),
as ``tests/test_supervisor.py`` holds the JAX package's: heartbeats, the
watchdog's stall and deadline ladder, the ``stall`` fault action, and the
restart loop's exit-code policy (quarantine after N same-site crashes,
seeded-jitter backoff, journaled episodes). The hook routes to the port's
telemetry (``graphdyn_torch.obs``); the flight ring's own tests are in
``tests/test_torch_obs_device.py``."""

import json
import os
import time

import pytest

from graphdyn_torch.resilience import hooks
from graphdyn_torch.resilience import faults as _faults
from graphdyn_torch.resilience import supervisor as sup
from graphdyn_torch.resilience.retry import RetryPolicy
from graphdyn_torch.resilience.shutdown import clear_shutdown, shutdown_requested
from graphdyn_torch.resilience.store import JOURNAL_NAME, validate_journal

pytestmark = pytest.mark.faultinject


@pytest.fixture(autouse=True)
def _clean_shutdown_flag():
    clear_shutdown()
    yield
    clear_shutdown()


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------


def test_beat_is_monotonic_and_readable():
    n0, t0, _ = sup.last_beat()
    n1 = sup.beat("chunk")
    n2 = sup.beat("rep")
    assert n2 == n1 + 1 > n0
    n, t, where = sup.last_beat()
    assert n == n2 and t >= t0 and where == "rep"


def test_hooks_record_nothing(tmp_path):
    """With no recorder installed the hook records nothing to a ledger: a
    beat, a counter and a gauge go only to the flight ring, and a dump
    writes the post-mortem into the workdir it is given."""
    from graphdyn_torch.obs import flight

    flight.clear()
    assert not hooks.enabled()
    sup.beat("lambda")
    hooks.counter("x", 1, a=1)
    hooks.gauge("y", 2.0)
    assert [e["name"] for e in flight.snapshot()] == ["obs.heartbeat", "x",
                                                      "y"]
    path = hooks.dump("exception", exc=RuntimeError("boom"),
                      workdir=str(tmp_path))
    assert path == str(tmp_path / hooks.POSTMORTEM_NAME)
    events, torn = hooks.read_ledger(path)
    assert torn == 0 and events[0]["run"]["postmortem"]
    assert events[-1]["name"] == "obs.crash"
    assert events[-1]["attrs"]["exc_type"] == "RuntimeError"
    with hooks.current().span("io.ckpt.write", path="p") as sp:
        sp.set(bytes=1)


def test_read_ledger_tolerates_torn_tail_and_seam(tmp_path):
    """The JAX package's torn-line contract: a torn last line and a torn
    line followed by a manifest are counted; one mid-file raises."""
    p = tmp_path / "l.jsonl"
    p.write_text('{"ev": "manifest"}\n{"ev": "journal", "op"\n'
                 '{"ev": "manifest"}\n{"ev": "x"}\n{"ev": "jour')
    events, torn = hooks.read_ledger(str(p))
    assert torn == 2 and [e["ev"] for e in events] == ["manifest", "manifest",
                                                       "x"]
    p.write_text('{"ev": "manifest"}\n{"torn\n{"ev": "x"}\n')
    with pytest.raises(ValueError, match="torn JSON line"):
        hooks.read_ledger(str(p))


def test_raise_if_requested_beats():
    from graphdyn_torch.resilience.shutdown import raise_if_requested

    n0 = sup.last_beat()[0]
    raise_if_requested(where="chunk")       # no shutdown pending: no raise
    assert sup.last_beat()[0] == n0 + 1
    assert sup.last_beat()[2] == "chunk"


# ---------------------------------------------------------------------------
# the watchdog ladder
# ---------------------------------------------------------------------------


def test_watchdog_detects_stall_and_requests_graceful_shutdown():
    with sup.supervision(stall_timeout_s=0.08, poll_s=0.02,
                         grace_s=60.0):
        sup.beat("chunk")               # first boundary: steady state begins
        deadline = time.monotonic() + 3.0
        while not shutdown_requested() and time.monotonic() < deadline:
            time.sleep(0.02)            # NOT beating: this is the stall
        assert shutdown_requested(), "watchdog never noticed the stall"
    assert sup.last_beat()[2] == "chunk"    # the last boundary crossed


def test_watchdog_startup_grace_covers_the_cold_start():
    """Before the first boundary beat of the scope, only the (longer)
    startup grace applies — a cold start (import + compile) longer than
    the steady-state stall timeout must not be preempted."""
    with sup.supervision(stall_timeout_s=0.05, poll_s=0.02,
                         startup_grace_s=5.0, grace_s=60.0):
        time.sleep(0.3)                 # "compiling": 6x the stall timeout
        assert not shutdown_requested(), \
            "watchdog preempted a legitimate cold start"
        sup.beat("chunk")               # steady state: the short clock arms
        deadline = time.monotonic() + 3.0
        while not shutdown_requested() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert shutdown_requested()


def test_watchdog_does_not_fire_while_beating():
    with sup.supervision(stall_timeout_s=0.2, poll_s=0.02, grace_s=60.0):
        t_end = time.monotonic() + 0.6
        while time.monotonic() < t_end:
            sup.beat("chunk")
            time.sleep(0.03)
        assert not shutdown_requested(), \
            "watchdog fired on a run that was heartbeating"


def test_watchdog_hard_aborts_wedged_run(tmp_path, monkeypatch):
    """Escalation rung 2: the graceful request is ignored (no beats arrive)
    for a whole grace window — the injected abort hook fires."""
    monkeypatch.chdir(tmp_path)
    aborted = []
    sup.beat("rep")                     # the boundary the stall will name
    # startup grace shrunk: this scenario IS the wedged-before-boundary
    # class (device init hang) the grace exists to give time to
    wd = sup.Watchdog(stall_timeout_s=0.05, grace_s=0.1, poll_s=0.02,
                      startup_grace_s=0.05,
                      abort=lambda: aborted.append(True)).start()
    try:
        deadline = time.monotonic() + 3.0
        while not aborted and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        wd.stop()
    assert aborted, "watchdog never hard-aborted the wedged run"
    assert shutdown_requested()         # rung 1 fired first


def test_watchdog_deadline_requests_graceful_shutdown():
    with sup.supervision(deadline_s=0.06, poll_s=0.02):
        deadline = time.monotonic() + 3.0
        while not shutdown_requested() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert shutdown_requested(), "deadline never fired"


def test_watchdog_says_whether_its_own_deadline_fired():
    """``deadline_fired`` is the watchdog's own: a request from anyone
    else leaves it false, and each request adds one to the count."""
    from graphdyn_torch.resilience.shutdown import (
        request_shutdown,
        shutdown_requests,
    )

    with sup.supervision(deadline_s=30.0, poll_s=0.02) as wd:
        request_shutdown()
        time.sleep(0.06)
        assert not wd.deadline_fired and shutdown_requests() == 1
    clear_shutdown()
    assert shutdown_requests() == 0
    with sup.supervision(deadline_s=0.06, poll_s=0.02) as wd:
        deadline = time.monotonic() + 3.0
        while not wd.deadline_fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert wd.deadline_fired and shutdown_requested()
        request_shutdown()
        assert shutdown_requests() == 2


def test_supervision_without_knobs_is_a_noop():
    with sup.supervision(None, None) as wd:
        assert wd is None               # no thread, no beat, no cost


def test_env_float_is_lenient(monkeypatch):
    monkeypatch.setenv("GRAPHDYN_STALL_TIMEOUT", "garbage")
    assert sup.env_float("GRAPHDYN_STALL_TIMEOUT") is None
    monkeypatch.setenv("GRAPHDYN_STALL_TIMEOUT", "2.5")
    assert sup.env_float("GRAPHDYN_STALL_TIMEOUT") == 2.5
    monkeypatch.setenv("GRAPHDYN_STALL_TIMEOUT", "-1")
    assert sup.env_float("GRAPHDYN_STALL_TIMEOUT") is None


# ---------------------------------------------------------------------------
# the `stall` fault action
# ---------------------------------------------------------------------------


def test_stall_fault_sleeps_then_continues():
    spec = _faults.FaultSpec("rep.boundary", "stall", secs=0.12)
    with _faults.FaultPlan([spec]):
        t0 = time.monotonic()
        _faults.maybe_fail("rep.boundary", key="rep=0")   # must NOT raise
        assert time.monotonic() - t0 >= 0.12
        # side effect consumed: the next hit is past the window, no sleep
        t0 = time.monotonic()
        _faults.maybe_fail("rep.boundary", key="rep=1")
        assert time.monotonic() - t0 < 0.1


def test_stall_fault_is_sideeffect_only_at_transform_sites():
    spec = _faults.FaultSpec("checkpoint.read", "stall", secs=0.05)
    with _faults.FaultPlan([spec]):
        t0 = time.monotonic()
        out = _faults.transform_spec("checkpoint.read", "truncate", key="ck")
        assert out is None              # never misread as a transform
        assert time.monotonic() - t0 >= 0.05


# ---------------------------------------------------------------------------
# the supervise() restart loop (scripted runners)
# ---------------------------------------------------------------------------


def _scripted(rcs, site=None):
    """A runner returning the scripted exit codes; crash codes drop a
    minimal parseable post-mortem naming ``site`` in the episode cwd."""
    calls = []

    def run(args, cwd):
        os.makedirs(cwd, exist_ok=True)
        i = len(calls)
        calls.append(list(args))
        rc = rcs[min(i, len(rcs) - 1)]
        if rc not in (0, 75, 130) and site is not None:
            with open(os.path.join(cwd, "obs_postmortem.jsonl"), "w") as f:
                f.write(json.dumps({"ev": "manifest", "t": 0.0,
                                    "run": {"postmortem": True}}) + "\n")
                f.write(json.dumps({"ev": "counter", "t": 0.1,
                                    "name": "obs.crash", "inc": 1,
                                    "attrs": {"site": site}}) + "\n")
        return rc

    return run, calls


def _policy(quarantine_after=3, max_crashes=10):
    return sup.RestartPolicy(
        quarantine_after=quarantine_after, max_crashes=max_crashes,
        max_episodes=50,
        backoff=RetryPolicy(tries=8, base_delay_s=0.01, max_delay_s=0.05,
                            jitter=True),
    )


def test_supervise_preempt_resumes_and_finishes(tmp_path):
    runner, calls = _scripted([75, 75, 0])
    report = sup.supervise(["sa", "--n", "10"], workdir=str(tmp_path),
                           policy=_policy(), runner=runner,
                           journal_dir=str(tmp_path), sleep=lambda s: None)
    assert report["exit"] == 0 and len(calls) == 3
    assert [e["rc"] for e in report["episodes"]] == [75, 75, 0]
    events, problems = validate_journal(str(tmp_path / JOURNAL_NAME))
    assert problems == []
    restarts = [e for e in events if e.get("op") == "supervise.restart"]
    assert len(restarts) == 2
    assert all(r["kind"] == "preempt" for r in restarts)
    assert any(e.get("op") == "supervise.start" for e in events)


def test_supervise_bounds_consecutive_preemption_loops(tmp_path):
    """A deadline/stall-timeout shorter than the run's cold start would
    spin forever on exit-75 restarts: bounded auto-restart applies to
    preemptions too — the supervisor hands the 75 back to the scheduler
    after max_preempts consecutive ones."""
    runner, calls = _scripted([75])     # preempts every episode
    policy = _policy()
    policy.max_preempts = 4
    report = sup.supervise(["sa"], workdir=str(tmp_path), policy=policy,
                           runner=runner, journal_dir=str(tmp_path),
                           sleep=lambda s: None)
    assert report["exit"] == 75
    assert report["reason"] == "preemption budget exhausted"
    assert len(calls) == 4


def test_supervise_stops_on_abort(tmp_path):
    runner, calls = _scripted([130])
    report = sup.supervise(["sa"], workdir=str(tmp_path), policy=_policy(),
                           runner=runner, journal_dir=str(tmp_path))
    assert report["exit"] == 130 and len(calls) == 1
    assert not report["quarantined"]


def test_supervise_stops_immediately_on_usage_error(tmp_path):
    """argparse exit 2 is a deterministic config error: restarting it N
    times before quarantining would burn the whole crash budget proving
    what the first exit already said."""
    runner, calls = _scripted([2])
    report = sup.supervise(["sa", "--no-such-flag"], workdir=str(tmp_path),
                           policy=_policy(), runner=runner,
                           journal_dir=str(tmp_path), sleep=lambda s: None)
    assert report["exit"] == 2 and report["reason"] == "usage error"
    assert len(calls) == 1              # never restarted


def test_supervise_quarantines_same_site_crash_loop(tmp_path):
    runner, calls = _scripted([1], site="solver.py:42 in explode")
    slept = []
    report = sup.supervise(["sa"], workdir=str(tmp_path),
                           policy=_policy(quarantine_after=3),
                           runner=runner, journal_dir=str(tmp_path),
                           sleep=slept.append)
    assert report["exit"] == sup.EX_QUARANTINE
    assert report["quarantined"] and report["site"] == "solver.py:42 in explode"
    # exactly N episodes — never an N+1-th restart — and N-1 backoffs
    assert len(calls) == 3 and len(slept) == 2
    assert all(s > 0 for s in slept)
    bundle = report["bundle"]
    assert os.path.exists(bundle)
    with open(bundle) as f:
        doc = json.load(f)
    assert doc["site"] == "solver.py:42 in explode" and doc["crashes"] == 3
    assert len(doc["postmortems"]) == 3
    assert all(os.path.exists(p) for p in doc["postmortems"])
    events, problems = validate_journal(str(tmp_path / JOURNAL_NAME))
    assert problems == []
    q = [e for e in events if e.get("op") == "supervise.quarantine"]
    assert len(q) == 1 and q[0]["site"] == doc["site"] and q[0]["crashes"] == 3


def test_supervise_backoff_is_deterministic_per_site(tmp_path):
    """The seeded full-jitter contract: the same crash site draws the
    same backoff schedule on every supervisor run (tests can pin it), while
    a different site draws a de-correlated one."""
    def run_once(d, site):
        runner, _ = _scripted([1], site=site)
        slept = []
        sup.supervise(["sa"], workdir=str(d), policy=_policy(),
                      runner=runner, journal_dir=str(d), sleep=slept.append)
        return slept

    a1 = run_once(tmp_path / "a1", "site.A")
    a2 = run_once(tmp_path / "a2", "site.A")
    b = run_once(tmp_path / "b", "site.B")
    assert a1 == a2
    assert a1 != b


def test_supervise_site_change_resets_streak_until_crash_budget(tmp_path):
    """Crashes alternating between two sites never trip the same-site
    quarantine; the TOTAL crash budget stops the loop instead."""
    sites = ["site.A", "site.B"]
    calls = []

    def runner(args, cwd):
        os.makedirs(cwd, exist_ok=True)
        i = len(calls)
        calls.append(1)
        with open(os.path.join(cwd, "obs_postmortem.jsonl"), "w") as f:
            f.write(json.dumps({"ev": "manifest", "t": 0.0, "run": {}})
                    + "\n")
            f.write(json.dumps({"ev": "counter", "t": 0.1,
                                "name": "obs.crash", "inc": 1,
                                "attrs": {"site": sites[i % 2]}}) + "\n")
        return 1

    report = sup.supervise(["sa"], workdir=str(tmp_path),
                           policy=_policy(quarantine_after=3, max_crashes=5),
                           runner=runner, journal_dir=str(tmp_path),
                           sleep=lambda s: None)
    assert not report["quarantined"]
    assert report["reason"] == "crash budget exhausted"
    assert len(calls) == 5


def test_supervise_crash_without_postmortem_keys_on_exit_code(tmp_path):
    runner, _ = _scripted([7])          # no post-mortem written
    report = sup.supervise(["sa"], workdir=str(tmp_path),
                           policy=_policy(quarantine_after=2),
                           runner=runner, journal_dir=str(tmp_path),
                           sleep=lambda s: None)
    assert report["exit"] == sup.EX_QUARANTINE
    assert report["site"] == "exit:7"


def test_supervise_forwards_watchdog_flags_to_child(tmp_path):
    runner, calls = _scripted([0])
    sup.supervise(["sa", "--n", "10"], workdir=str(tmp_path),
                  policy=_policy(), runner=runner,
                  stall_timeout_s=5.0, deadline_s=9.0,
                  journal_dir=str(tmp_path))
    assert calls[0] == ["--stall-timeout", "5.0", "--deadline", "9.0",
                        "sa", "--n", "10"]


def test_supervise_absolutizes_relative_paths(tmp_path, monkeypatch):
    """Episodes run in per-episode cwds, so a relative --checkpoint/--out
    would resolve somewhere different every episode — the preempted
    episode's snapshot invisible to the restarted one. supervise() anchors
    every path-valued child flag at its own cwd up front."""
    monkeypatch.chdir(tmp_path)
    runner, calls = _scripted([0])
    report = sup.supervise(
        ["--obs-ledger=led.jsonl", "sa", "--checkpoint", "ck/run",
         "--out", "res.npz", "--n", "10"],
        workdir=str(tmp_path), policy=_policy(), runner=runner)
    a = calls[0]
    assert a[a.index("--checkpoint") + 1] == str(tmp_path / "ck" / "run")
    assert a[a.index("--out") + 1] == str(tmp_path / "res.npz")
    assert f"--obs-ledger={tmp_path / 'led.jsonl'}" in a
    # the journal follows the absolutized checkpoint directory
    assert report["journal"] == str(tmp_path / "ck" / JOURNAL_NAME)


def test_checkpoint_dir_parsing():
    assert sup._checkpoint_dir(["sa", "--checkpoint", "/a/b/ck"]) == "/a/b"
    assert sup._checkpoint_dir(["sa", "--checkpoint=/a/b/ck"]) == "/a/b"
    assert sup._checkpoint_dir(["sa", "--checkpoint", "ck"]) == "."
    assert sup._checkpoint_dir(["sa", "--n", "10"]) is None


# ---------------------------------------------------------------------------
# journal schema
# ---------------------------------------------------------------------------


def test_validate_journal_rejects_incomplete_supervise_events(tmp_path):
    from graphdyn_torch.resilience.store import _reset_journal_state, journal_event

    _reset_journal_state()
    jpath = str(tmp_path / JOURNAL_NAME)
    journal_event(jpath, "supervise.start", argv=["sa"])
    journal_event(jpath, "supervise.restart", episode=0, rc=75,
                  kind="preempt")
    journal_event(jpath, "supervise.quarantine", site="x", crashes=3)
    _, problems = validate_journal(jpath)
    assert problems == []
    journal_event(jpath, "supervise.restart", rc=1)       # missing fields
    _, problems = validate_journal(jpath)
    assert any("supervise.restart" in p and "episode" in p
               for p in problems)
    assert any("supervise.restart" in p and "kind" in p for p in problems)


# ---------------------------------------------------------------------------
# CLI surfaces
# ---------------------------------------------------------------------------


def test_supervisor_main_parses_flags_and_command(tmp_path, monkeypatch,
                                                  capsys):
    seen = {}

    def fake_supervise(cmd, **kw):
        seen["cmd"] = cmd
        seen.update(kw)
        return {"exit": 0, "reason": "completed", "episodes": [],
                "quarantined": False, "journal": "j"}

    monkeypatch.setattr(sup, "supervise", fake_supervise)
    rc = sup.main(["--stall-timeout", "5", "--workdir", str(tmp_path),
                   "--format", "json", "--", "sa", "--n", "10"])
    assert rc == 0
    assert seen["cmd"] == ["sa", "--n", "10"]
    assert seen["stall_timeout_s"] == 5.0
    assert seen["policy"].quarantine_after == 3
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0])["exit"] == 0


def test_supervisor_main_requires_a_command():
    with pytest.raises(SystemExit):
        sup.main(["--stall-timeout", "5"])


def test_cli_run_supervised_delegates(monkeypatch):
    from graphdyn_torch import cli

    seen = {}
    monkeypatch.setattr(sup, "main",
                        lambda cmd: seen.setdefault("cmd", cmd) and 0 or 0)
    rc = cli.main(["run-supervised", "--stall-timeout", "5", "--",
                   "sa", "--n", "10"])
    assert rc == 0
    assert seen["cmd"] == ["--stall-timeout", "5", "--", "sa", "--n", "10"]


def test_cli_run_supervised_forwards_presubcommand_flags(monkeypatch):
    """Top-level flags placed BEFORE the run-supervised subcommand reach
    the supervisor (watchdog knobs) and the child (store/obs knobs) — a
    silently dropped --stall-timeout would run with no watchdog at all."""
    from graphdyn_torch import cli

    seen = {}
    real_main = sup.main
    monkeypatch.setattr(sup, "main",
                        lambda cmd: seen.setdefault("cmd", cmd) and 0 or 0)
    rc = cli.main(["--stall-timeout", "300", "--ckpt-keep", "3",
                   "run-supervised", "--", "sa", "--n", "10"])
    assert rc == 0
    cmd = seen["cmd"]
    assert cmd[:2] == ["--stall-timeout", "300.0"]
    sep = cmd.index("--")
    assert cmd[sep + 1:] == ["--ckpt-keep", "3", "sa", "--n", "10"]
    # and the supervisor's own parser accepts exactly this handoff shape
    captured = {}

    def fake_supervise(child, **kw):
        captured["child"] = child
        captured.update(kw)
        return {"exit": 0, "reason": "completed", "episodes": [],
                "quarantined": False, "journal": "j"}

    monkeypatch.setattr(sup, "supervise", fake_supervise)
    assert real_main(cmd) == 0
    assert captured["stall_timeout_s"] == 300.0
    assert captured["child"] == ["--ckpt-keep", "3", "sa", "--n", "10"]
