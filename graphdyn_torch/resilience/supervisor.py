"""Supervised execution: heartbeat watchdog, run deadlines, bounded restart
(the port of ``graphdyn/resilience/supervisor.py``: same exit codes, same
environment variables, same journal events).

- **Liveness.** Every chunk/rep/λ boundary a driver reaches is a heartbeat
  (:func:`beat`). The :class:`Watchdog` thread watches the age of the last
  beat and, past ``stall_timeout_s``, first requests a graceful shutdown
  (the run saves at its next boundary and exits 75), then, if no beat comes
  for a further grace window, hard-aborts with exit
  :data:`~graphdyn_torch.resilience.shutdown.EX_ABORT` (130).
- **Deadlines.** ``deadline_s`` takes the same graceful path on a timer.
  Both ride on every CLI command (``--stall-timeout``/``--deadline``, env
  ``GRAPHDYN_STALL_TIMEOUT``/``GRAPHDYN_DEADLINE``).
- **Bounded auto-restart.** :func:`supervise` (``python -m
  graphdyn_torch.resilience.supervisor`` or ``python -m graphdyn_torch
  run-supervised``) runs a CLI command in episodes and maps each exit code
  to a decision:

  ====  =========================================================
  exit  decision
  ====  =========================================================
  0     done
  75    preempted with a snapshot on disk: restart at once
  130   operator or watchdog abort: stop
  2/64  usage error: stop (every restart would fail the same way)
  else  crash: restart after a seeded full-jitter backoff; the
        ``quarantine_after``-th consecutive crash at one site ends
        the run with :data:`EX_QUARANTINE` (86)
  ====  =========================================================

  A crash's site is the ``obs.crash`` event of the episode's flight
  post-mortem (``obs_postmortem.jsonl``, which a dying run writes into its
  working directory, :mod:`graphdyn_torch.obs.flight`) when there is one,
  else ``exit:<code>``; the post-mortems are kept as
  ``<workdir>/supervise/postmortem.ep<N>.jsonl``. Every episode
  transition is journaled into the checkpoint directory's
  ``run_journal.jsonl``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time

from graphdyn_torch.resilience.retry import RetryPolicy
from graphdyn_torch.resilience.shutdown import EX_ABORT, EX_TEMPFAIL, request_shutdown

log = logging.getLogger("graphdyn_torch.resilience")

_MONO = time.monotonic

#: distinct "quarantined, do NOT requeue" exit code — a scheduler must treat
#: it like 130 (stop; operator attention), never like 75 (requeue): the run
#: has crash-looped at one site and retrying is proven useless
EX_QUARANTINE = 86

ENV_STALL = "GRAPHDYN_STALL_TIMEOUT"
ENV_DEADLINE = "GRAPHDYN_DEADLINE"


def env_float(name: str) -> float | None:
    """Lenient env-var float (the `_env_keep` convention: a typo'd value
    must not crash an otherwise-valid run before it starts)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        log.warning("ignoring unparseable %s=%r", name, raw)
        return None
    return v if v > 0 else None


# ---------------------------------------------------------------------------
# heartbeats (process-global, emitted at every driver boundary)
# ---------------------------------------------------------------------------

_beat_lock = threading.Lock()
_beat_n = 0
_beat_t = _MONO()           # import time: age is bounded before the first beat
_beat_where: str | None = None


def beat(where: str | None = None) -> int:
    """One liveness heartbeat: bump the monotonic counter and emit the
    ``obs.heartbeat`` gauge (value = count). Called at every chunk/rep/λ
    boundary — the same sites that poll the graceful-shutdown flag — so
    "the run reaches boundaries" and "the run is alive" are one fact.
    Near-free: a lock-guarded counter bump plus one gauge event (which the
    null recorder forwards to the bounded flight ring)."""
    global _beat_n, _beat_t, _beat_where
    with _beat_lock:
        _beat_n += 1
        _beat_t = _MONO()
        _beat_where = where
        n = _beat_n
    from graphdyn_torch.resilience import hooks as obs

    if where is None:
        obs.gauge("obs.heartbeat", n)
    else:
        obs.gauge("obs.heartbeat", n, where=where)
    return n


def last_beat() -> tuple[int, float, str | None]:
    """``(count, monotonic_time, where)`` of the newest heartbeat (the
    watchdog's read side; ``count`` changing is how it tells a new beat from
    a stall that merely spans its poll)."""
    with _beat_lock:
        return _beat_n, _beat_t, _beat_where


# ---------------------------------------------------------------------------
# the watchdog thread (stall detection + deadline)
# ---------------------------------------------------------------------------


def _default_abort() -> None:           # pragma: no cover — kills the process
    os._exit(EX_ABORT)


class Watchdog:
    """A daemon thread enforcing liveness (``stall_timeout_s``) and a run
    time budget (``deadline_s``).

    Escalation ladder on a stall (no heartbeat for ``stall_timeout_s``):

    1. deliver a graceful-shutdown request (:func:`~graphdyn_torch.resilience
       .shutdown.request_shutdown`) and emit ``supervise.stall_detected`` —
       if the program was merely slow, it snapshots at its next boundary
       and exits 75 (requeue-able; conservative by design: once a run has
       been stall-flagged it is preempted even if beats resume, because a
       program that stalls once mid-chain is a program the operator wants
       requeued onto healthier ground);
    2. if NO further heartbeat arrives for another ``grace_s``, the program
       is wedged (a hung device call never returns to a boundary): dump a
       flight post-mortem naming the stalled ``where=`` and hard-abort with
       exit 130 (``abort`` is injectable for tests; the default is
       ``os._exit(EX_ABORT)`` — a wedged program cannot run cleanup).

    A deadline fires the graceful request once, at ``deadline_s`` after
    :meth:`start` — the same snapshot + exit-75 path a SIGTERM takes.

    ``stall_timeout_s`` measures **inter-boundary** gaps; the run's cold
    start (interpreter + torch import + kernel builds, easily seconds to
    minutes) is not one. Until the first boundary beat of the scope, the
    effective timeout is ``startup_grace_s`` (default
    ``max(4 × stall_timeout, 60 s)``) — a wedged device *init* is still
    caught, but a legitimate cold start never false-preempts a run whose
    timeout was tuned to its steady-state boundary cadence (measured: a
    1.5 s timeout against subprocess episodes paying ~3 s of import cost
    preempted 13 times before finishing).
    """

    def __init__(self, *, stall_timeout_s: float | None = None,
                 deadline_s: float | None = None, grace_s: float | None = None,
                 startup_grace_s: float | None = None,
                 poll_s: float | None = None, abort=None):
        if stall_timeout_s is None and deadline_s is None:
            raise ValueError("watchdog needs a stall timeout or a deadline")
        self.stall_timeout_s = stall_timeout_s
        self.deadline_s = deadline_s
        # the grace window is generous by default: escalation 2 is for a
        # WEDGED program, and the graceful path (escalation 1) may still be
        # writing its shutdown snapshot — aborting mid-save would tear the
        # very state the ladder exists to protect
        self.grace_s = (grace_s if grace_s is not None
                        else max(4.0 * (stall_timeout_s or 0.0), 30.0))
        self.startup_grace_s = (
            startup_grace_s if startup_grace_s is not None
            else max(4.0 * (stall_timeout_s or 0.0), 60.0))
        if poll_s is None:
            cands = [t / 4.0 for t in (stall_timeout_s, deadline_s)
                     if t is not None]
            poll_s = min(1.0, max(0.01, min(cands)))
        self.poll_s = poll_s
        self._abort = abort or _default_abort
        #: True once this watchdog's deadline has requested the shutdown
        #: (set before the request, so a boundary that sees the flag sees
        #: this too)
        self.deadline_fired = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "Watchdog":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="graphdyn-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        from graphdyn_torch.resilience import hooks as obs
        from graphdyn_torch.resilience import hooks as flight

        t_start = _MONO()
        n_entry = last_beat()[0]        # beats ≤ this are pre-scope
        stall_beat: int | None = None   # beat count when the stall was flagged
        stall_t = 0.0
        while not self._stop.wait(self.poll_s):
            now = _MONO()
            if (self.deadline_s is not None and not self.deadline_fired
                    and now - t_start >= self.deadline_s):
                self.deadline_fired = True
                log.warning(
                    "run deadline of %.3gs reached — requesting graceful "
                    "shutdown (snapshot at next boundary, exit %d)",
                    self.deadline_s, EX_TEMPFAIL,
                )
                obs.counter("supervise.deadline",
                            deadline_s=self.deadline_s,
                            elapsed_s=round(now - t_start, 3))
                request_shutdown()
            if self.stall_timeout_s is None:
                continue
            n, t, where = last_beat()
            age = now - t
            # the cold start is not an inter-boundary gap: until the first
            # boundary beat of this scope, only the startup grace applies
            timeout = (self.stall_timeout_s if n > n_entry
                       else max(self.stall_timeout_s, self.startup_grace_s))
            if age <= timeout:
                continue
            if stall_beat is None or n != stall_beat:
                # first escalation for THIS beat generation: the graceful
                # ladder rung (a new beat arriving later restarts the
                # grace clock via the n != stall_beat comparison)
                stall_beat, stall_t = n, now
                log.warning(
                    "no heartbeat for %.3gs (stall timeout %.3gs; last "
                    "boundary: %s) — requesting graceful shutdown; hard "
                    "abort in %.3gs if the run stays wedged",
                    age, self.stall_timeout_s, where or "<start>",
                    self.grace_s,
                )
                obs.counter("supervise.stall_detected",
                            where=where or "<start>",
                            age_s=round(age, 3),
                            timeout_s=self.stall_timeout_s)
                request_shutdown()
            elif now - stall_t >= self.grace_s:
                # the graceful request was ignored for a whole grace window
                # with zero heartbeats: the program is wedged, not slow
                site = (f"stalled past {where or '<start>'} boundary "
                        f"(no heartbeat for {age:.1f}s)")
                log.error("watchdog hard abort: %s — exiting %d",
                          site, EX_ABORT)
                obs.counter("supervise.stall_abort",
                            where=where or "<start>", age_s=round(age, 3))
                flight.dump("stall", site=site)
                self._abort()
                return


@contextlib.contextmanager
def supervision(stall_timeout_s: float | None = None,
                deadline_s: float | None = None, *,
                grace_s: float | None = None,
                startup_grace_s: float | None = None,
                poll_s: float | None = None, abort=None):
    """Run a scope under a :class:`Watchdog` (no-op when neither knob is
    set — an unsupervised run pays nothing). Emits one heartbeat at entry so
    the stall clock starts at the scope, not at module import."""
    if stall_timeout_s is None and deadline_s is None:
        yield None
        return
    beat("supervise.start")
    wd = Watchdog(stall_timeout_s=stall_timeout_s, deadline_s=deadline_s,
                  grace_s=grace_s, startup_grace_s=startup_grace_s,
                  poll_s=poll_s, abort=abort).start()
    try:
        yield wd
    finally:
        wd.stop()


# ---------------------------------------------------------------------------
# the supervisor restart loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RestartPolicy:
    """Exit-code → restart policy of :func:`supervise` (module docstring
    table). ``backoff`` is the seeded full-jitter
    :class:`~graphdyn_torch.resilience.retry.RetryPolicy`, keyed per crash site —
    deterministic per site for tests, de-correlated across sites."""

    quarantine_after: int = 3       # consecutive same-site crashes → quarantine
    max_crashes: int = 10           # total crash restarts across all sites
    #: consecutive preemption (exit-75) restarts before the supervisor
    #: gives the run back to the scheduler (exits 75 itself): legitimate
    #: eviction-heavy runs resume and make progress, but a misconfigured
    #: deadline/stall-timeout shorter than the cold start would otherwise
    #: spin forever — bounded auto-restart applies to preemptions too
    max_preempts: int = 100
    max_episodes: int = 1000        # backstop incl. preemption restarts
    backoff: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(
            tries=12, base_delay_s=0.5, max_delay_s=30.0, jitter=True))


def run_subprocess(args: list[str], cwd: str) -> int:
    """The default episode runner: one real ``python -m graphdyn_torch`` child
    process in ``cwd`` (where its flight post-mortem lands). Signal deaths
    map to the 128+N shell convention so the policy table sees one code
    space."""
    os.makedirs(cwd, exist_ok=True)
    proc = subprocess.run([sys.executable, "-m", "graphdyn_torch", *args], cwd=cwd)
    rc = proc.returncode
    return 128 - rc if rc < 0 else rc


def run_inprocess(args: list[str], cwd: str) -> int:
    """In-process episode runner (tests): calls the real
    CLI entry in ``cwd`` and simulates a fresh requeued process — journal
    manifest state and any pending shutdown flag are reset, an injected
    hard preemption maps to 137 (SIGKILL's shell code) and any other escape
    to 1, mirroring what a scheduler would observe."""
    from graphdyn_torch.cli import main as cli_main
    from graphdyn_torch.resilience import faults as _faults
    from graphdyn_torch.resilience.shutdown import clear_shutdown
    from graphdyn_torch.resilience.store import _reset_journal_state

    old = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    _reset_journal_state()
    clear_shutdown()
    try:
        # graftlint: disable-next-line=GD007  the null device, not a file
        with open(os.devnull, "w") as devnull, \
                contextlib.redirect_stdout(devnull):
            try:
                return cli_main(args)
            except SystemExit as e:
                return int(e.code) if isinstance(e.code, int) else 1
            except _faults.InjectedPreemption:
                return 137              # hard kill: what SIGKILL looks like
            except KeyboardInterrupt:
                return EX_ABORT
            except BaseException:       # noqa: BLE001 — a crash is exit != 0
                return 1
    finally:
        os.chdir(old)


def crash_site(epdir: str) -> str | None:
    """The failure site named by an episode's flight post-mortem (the last
    ``obs.crash`` event's ``site``), or None when no usable post-mortem
    exists — the supervisor's crash-loop key."""
    from graphdyn_torch.resilience.hooks import POSTMORTEM_NAME
    from graphdyn_torch.resilience.hooks import read_ledger

    path = os.path.join(epdir, POSTMORTEM_NAME)
    if not os.path.exists(path):
        return None
    try:
        events, _ = read_ledger(path)
    except (OSError, ValueError):
        return None
    crashes = [e for e in events
               if e.get("ev") == "counter" and e.get("name") == "obs.crash"]
    if not crashes:
        return None
    return (crashes[-1].get("attrs") or {}).get("site")


#: path-valued CLI flags of the child command. Episodes run in per-episode
#: working directories (<workdir>/ep<N>), so a RELATIVE value would resolve
#: somewhere different every episode — the preempted episode's snapshot
#: would be invisible to the restarted one and every preemption would lose
#: all progress. supervise() rewrites these to absolute paths up front.
_PATH_FLAGS = frozenset((
    "--checkpoint", "--out", "--ckpt-mirror", "--obs-ledger", "--profile",
    "--compile-cache", "--plot",
))


def _absolutize_paths(args: list[str]) -> list[str]:
    """Rewrite the values of :data:`_PATH_FLAGS` (both ``--flag value`` and
    ``--flag=value`` forms) to absolute paths, anchored at the supervisor's
    own cwd — one location for snapshots/results/journal across every
    episode cwd."""
    out: list[str] = []
    i = 0
    while i < len(args):
        a = args[i]
        if a in _PATH_FLAGS and i + 1 < len(args):
            out += [a, os.path.abspath(args[i + 1])]
            i += 2
            continue
        flag, eq, val = a.partition("=")
        if eq and flag in _PATH_FLAGS:
            out.append(f"{flag}={os.path.abspath(val)}")
            i += 1
            continue
        out.append(a)
        i += 1
    return out


def _checkpoint_dir(child_args: list[str]) -> str | None:
    """The child's checkpoint directory (where the run journal lives),
    parsed from its ``--checkpoint`` flag when present."""
    for i, a in enumerate(child_args):
        if a == "--checkpoint" and i + 1 < len(child_args):
            return os.path.dirname(child_args[i + 1]) or "."
        if a.startswith("--checkpoint="):
            return os.path.dirname(a.split("=", 1)[1]) or "."
    return None


def supervise(child_args: list[str], *, workdir: str = ".",
              policy: RestartPolicy | None = None, runner=None,
              stall_timeout_s: float | None = None,
              deadline_s: float | None = None,
              journal_dir: str | None = None,
              sleep=time.sleep, diag=lambda s: None) -> dict:
    """Run a graphdyn_torch CLI command under the restart policy until it
    finishes, is aborted, exhausts its crash budget, or is quarantined.

    Each episode runs in its own ``<workdir>/ep<N>`` directory (so flight
    post-mortems never overwrite each other); crash evidence is copied to
    ``<workdir>/supervise/`` as it happens, and a quarantine writes the
    bundle manifest ``quarantine.json`` there. Every episode transition is
    journaled (``supervise.start`` / ``supervise.restart`` /
    ``supervise.quarantine``) into the child's checkpoint-directory journal
    (fallback: ``workdir``) — the evidence trail grows a supervision
    chapter. Returns the report dict ``{"exit", "episodes", "quarantined",
    ...}``; ``exit`` is what a wrapping scheduler should see.
    """
    from graphdyn_torch.resilience import hooks as obs
    from graphdyn_torch.resilience.hooks import POSTMORTEM_NAME
    from graphdyn_torch.resilience.store import JOURNAL_NAME, journal_event

    policy = policy or RestartPolicy()
    runner = runner or run_subprocess
    child_args = _absolutize_paths(list(child_args))
    pre: list[str] = []
    if stall_timeout_s is not None:
        pre += ["--stall-timeout", str(stall_timeout_s)]
    if deadline_s is not None:
        pre += ["--deadline", str(deadline_s)]
    args = pre + child_args

    jdir = journal_dir or _checkpoint_dir(child_args) or workdir
    jpath = os.path.join(jdir, JOURNAL_NAME)
    evidence = os.path.join(workdir, "supervise")
    journal_event(jpath, "supervise.start", argv=args,
                  workdir=os.path.abspath(workdir),
                  policy={"quarantine_after": policy.quarantine_after,
                          "max_crashes": policy.max_crashes})

    episodes: list[dict] = []
    crashes = 0
    preempts = 0                    # consecutive 75s, reset by any crash
    streak = 0
    last_site: str | None = None
    delay_gen = None

    def _report(exit_code: int, reason: str, **extra) -> dict:
        return {"exit": exit_code, "reason": reason, "episodes": episodes,
                "quarantined": extra.pop("quarantined", False),
                "journal": jpath, **extra}

    for i in range(policy.max_episodes):
        epdir = os.path.join(workdir, f"ep{i}")
        diag(f"supervise: episode {i}: {' '.join(args)}")
        rc = runner(args, epdir)
        ep = {"episode": i, "rc": rc, "cwd": epdir}
        episodes.append(ep)
        if rc == 0:
            diag(f"supervise: episode {i} finished cleanly")
            return _report(0, "completed")
        if rc == EX_ABORT:
            # operator abort or watchdog hard abort: restarting would
            # override a human (or re-wedge a wedged device) — stop
            diag(f"supervise: episode {i} aborted (exit {rc}) — stopping")
            return _report(EX_ABORT, "aborted")
        if rc in (2, 64):
            # argparse's usage exit (2) / sysexits EX_USAGE (64): the
            # command line itself is wrong — deterministic, so every
            # restart would fail identically; stop NOW instead of burning
            # the crash budget discovering that
            diag(f"supervise: episode {i} exited {rc} (usage error) — a "
                 "misconfigured command cannot be restarted into working")
            return _report(rc, "usage error")
        if rc == EX_TEMPFAIL:
            # a graceful preemption left a snapshot: resume immediately;
            # not a failure, so the crash streak resets
            streak, last_site, delay_gen = 0, None, None
            preempts += 1
            ep["kind"] = "preempt"
            if preempts >= policy.max_preempts:
                # a preemption LOOP (deadline/stall-timeout shorter than
                # the run can make progress in): stop spinning locally and
                # hand the 75 to the wrapping scheduler — the snapshot is
                # on disk, another host may fare better
                diag(f"supervise: {preempts} consecutive preemptions — "
                     f"exiting {EX_TEMPFAIL} (requeue elsewhere)")
                return _report(EX_TEMPFAIL, "preemption budget exhausted")
            journal_event(jpath, "supervise.restart", episode=i, rc=rc,
                          kind="preempt")
            obs.counter("supervise.restart", episode=i, rc=rc,
                        kind="preempt")
            diag(f"supervise: episode {i} preempted (exit 75) — resuming")
            continue
        # a real crash: identify the site, preserve the evidence
        preempts = 0
        crashes += 1
        site = crash_site(epdir) or f"exit:{rc}"
        ep["kind"], ep["site"] = "crash", site
        pm = os.path.join(epdir, POSTMORTEM_NAME)
        if os.path.exists(pm):
            os.makedirs(evidence, exist_ok=True)
            dst = os.path.join(evidence, f"postmortem.ep{i}.jsonl")
            try:
                shutil.copyfile(pm, dst)
                ep["postmortem"] = dst
            except OSError as e:        # evidence is best-effort
                log.warning("could not preserve post-mortem %s: %s", pm, e)
        if site == last_site:
            streak += 1
        else:
            streak, last_site = 1, site
            delay_gen = policy.backoff.delays(key=f"supervise:{site}")
        if streak >= policy.quarantine_after:
            bundle = _quarantine(evidence, site, streak, episodes, args)
            journal_event(jpath, "supervise.quarantine", site=site,
                          crashes=streak, bundle=bundle)
            obs.counter("supervise.quarantine", site=site, crashes=streak)
            log.error(
                "run QUARANTINED after %d consecutive crashes at %s — "
                "refusing further restarts (bundle: %s); exiting %d",
                streak, site, bundle, EX_QUARANTINE,
            )
            diag(f"supervise: QUARANTINED after {streak} crashes at {site}")
            return _report(EX_QUARANTINE, "quarantined", quarantined=True,
                           site=site, bundle=bundle)
        if crashes >= policy.max_crashes:
            diag(f"supervise: crash budget ({policy.max_crashes}) "
                 f"exhausted — stopping with exit {rc}")
            return _report(rc, "crash budget exhausted", site=site)
        delay = next(delay_gen, policy.backoff.max_delay_s)
        ep["backoff_s"] = round(delay, 6)
        journal_event(jpath, "supervise.restart", episode=i, rc=rc,
                      kind="crash", site=site, backoff_s=round(delay, 6),
                      streak=streak)
        obs.counter("supervise.restart", episode=i, rc=rc, kind="crash",
                    site=site, backoff_s=round(delay, 6))
        log.warning(
            "episode %d crashed (exit %d) at %s — restart %d/%d for this "
            "site in %.2gs", i, rc, site, streak, policy.quarantine_after,
            delay,
        )
        sleep(delay)
    return _report(episodes[-1]["rc"] if episodes else 1,
                   "episode budget exhausted")


def _quarantine(evidence: str, site: str, streak: int,
                episodes: list[dict], argv: list[str]) -> str:
    """Write the quarantine bundle manifest next to the preserved
    post-mortems; returns its path (best-effort — quarantine must never
    fail because the evidence disk did)."""
    from graphdyn_torch.utils.io import write_json_atomic

    os.makedirs(evidence, exist_ok=True)
    bundle = os.path.join(evidence, "quarantine.json")
    doc = {
        "site": site,
        "crashes": streak,
        "argv": argv,
        "time_unix": time.time(),
        "episodes": episodes,
        "postmortems": sorted(
            os.path.join(evidence, f)
            for f in os.listdir(evidence) if f.startswith("postmortem.")
        ),
    }
    try:
        write_json_atomic(bundle, doc, indent=1)
    except OSError as e:
        log.warning("could not write quarantine bundle %s: %s", bundle, e)
    return bundle


# ---------------------------------------------------------------------------
# CLI: python -m graphdyn_torch.resilience.supervisor / graphdyn run-supervised
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m graphdyn_torch.resilience.supervisor",
        description="run a graphdyn_torch CLI command under the resilience "
                    "supervisor: heartbeat watchdog, run deadline, bounded "
                    "auto-restart with crash-loop quarantine "
                    "(exit codes: see below)",
        epilog="exit codes: 0 the workload completed; 75 episode budget "
               "exhausted while still preempting (requeue the supervisor); "
               "130 operator/watchdog abort; "
               f"{EX_QUARANTINE} quarantined crash loop (do NOT requeue); "
               "otherwise the child's final exit code",
    )
    ap.add_argument("--stall-timeout", type=float, default=None,
                    metavar="SECS",
                    help="forwarded to the child: its watchdog preempts "
                    "(snapshot + exit 75) when no chunk/rep/lambda boundary "
                    "heartbeat arrives for SECS, and hard-aborts (130) if "
                    "it stays wedged past the grace window")
    ap.add_argument("--deadline", type=float, default=None, metavar="SECS",
                    help="forwarded to the child: per-episode time budget — "
                    "graceful snapshot + exit 75 at SECS (a resumed episode "
                    "gets a fresh budget and continues from its snapshot)")
    ap.add_argument("--quarantine-after", type=int, default=3, metavar="N",
                    help="quarantine after N consecutive crashes at one "
                    "site (default: 3)")
    ap.add_argument("--max-crashes", type=int, default=10, metavar="N",
                    help="total crash-restart budget across sites "
                    "(default: 10)")
    ap.add_argument("--max-preempts", type=int, default=100, metavar="N",
                    help="consecutive preemption (exit-75) restarts before "
                    "the supervisor exits 75 itself — bounds the livelock "
                    "of a deadline/stall-timeout shorter than the run's "
                    "cold start (default: 100)")
    ap.add_argument("--backoff-base", type=float, default=0.5,
                    metavar="SECS", help="crash-restart backoff base "
                    "(seeded full-jitter exponential; default: 0.5)")
    ap.add_argument("--backoff-max", type=float, default=30.0,
                    metavar="SECS", help="crash-restart backoff cap "
                    "(default: 30)")
    ap.add_argument("--workdir", default=".", metavar="DIR",
                    help="episode working directories (ep<N>/) and the "
                    "supervise/ evidence directory live here (default: .)")
    ap.add_argument("--format", choices=["text", "json"], default="text")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="the graphdyn_torch CLI command to supervise "
                    "(conventionally after a '--' separator)")
    args = ap.parse_args(argv)

    cmd = list(args.command)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command to supervise (append e.g. -- sa --n 1000 ...)")

    policy = RestartPolicy(
        quarantine_after=max(1, args.quarantine_after),
        max_crashes=max(1, args.max_crashes),
        max_preempts=max(1, args.max_preempts),
        backoff=RetryPolicy(tries=max(2, args.max_crashes + 1),
                            base_delay_s=args.backoff_base,
                            max_delay_s=args.backoff_max, jitter=True),
    )
    report = supervise(
        cmd, workdir=args.workdir, policy=policy,
        stall_timeout_s=args.stall_timeout, deadline_s=args.deadline,
        diag=lambda s: print(s, file=sys.stderr, flush=True),
    )
    if args.format == "json":
        print(json.dumps(report, default=str))
    else:
        for ep in report["episodes"]:
            extra = "".join(
                f" {k}={ep[k]}" for k in ("kind", "site", "backoff_s")
                if k in ep
            )
            print(f"episode {ep['episode']}: exit {ep['rc']}{extra}")
        print(f"supervise: {report['reason']} after "
              f"{len(report['episodes'])} episode(s), exit {report['exit']}")
    return report["exit"]


if __name__ == "__main__":
    sys.exit(main())
