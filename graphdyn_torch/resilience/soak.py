"""Chaos soak harness: composed-fault schedules over real CLI workloads
(the port of ``graphdyn/resilience/soak.py``).

Each fault site is survivable on its own; production preemption delivers
sequences (a torn write, then a preemption, then a truncated read of the
very snapshot the requeue needs). This module runs seeded, randomized
compositions of the port's instrumented fault sites against the real CLI
(``graphdyn_torch.cli.main``, the entry a scheduler requeues) through
kill/requeue cycles, on ``--device`` (default the card; every workload gets
``--device``), and holds every run to the durability contract:

- the final results are **bit-exact** against a fault-free oracle run of
  the same command line on the same device;
- the run journal (``run_journal.jsonl``, :func:`graphdyn_torch.resilience.
  store.validate_journal`) is schema-valid and tells the whole story: saves
  with strictly increasing versions, the quarantine or failover the
  scenario forced, one manifest per (simulated) process;
- every preempted episode leaves a parseable flight post-mortem
  (``obs_postmortem.jsonl`` with an ``obs.crash`` event naming the site),
  and the final clean episode leaves none.

The catalogue (randomized per seed: fault positions, counts and schedules
come from the seed's stream) is the JAX package's, less two scenarios:

==================== ======================================================
scenario             composition
==================== ======================================================
``torn_write``       torn checkpoint temp file mid-run → preemption signal
                     → requeue resumes bit-exactly
``write_degrade``    a burst of save ENOSPC (retry → skip-save degrade) →
                     preemption → requeue
``truncated_read``   preempt → truncate the published snapshot → requeue
                     falls back to a retained version (quarantine +
                     failover in the journal)
``bitrot``           preempt → flip bytes inside the snapshot without
                     breaking the zip container → the SHA-256 manifest
                     catches it, fallback to a retained version
``mirror_failover``  preempt → the primary checkpoint directory dies →
                     requeue resumes from the ``--ckpt-mirror`` replica
``mirror_degraded``  mirror-path ENOSPC for the whole episode → primary
                     proceeds, the journal records the degraded mirror →
                     preempt → requeue
``requeue_storm``    repeated preemption signals at randomized boundaries,
                     several requeues in a row, then a clean finish
``hang_detect``      injected mid-run ``stall`` → the ``--stall-timeout``
                     watchdog requests a graceful shutdown (snapshot + exit
                     75) → the supervisor restarts → bit-exact finish
``deadline_preempt`` ``--deadline`` expires mid-run → snapshot + exit 75 →
                     requeue without the deadline finishes bit-exactly
``crash_loop_quarantine`` the run crashes at the same site on every
                     restart → the supervisor backs off, then quarantines
                     (journal ``supervise.quarantine``, bundled
                     post-mortems, exit 86)
``stream_churn``     the out-of-core streamed rollout preempted twice at
                     chunk boundaries mid-churn; each requeue replays the
                     journaled mutations from the journal alone
``stream_shard_requeue`` the sharded stream (``--shards 4``, churn-driven
                     repartition) preempted at a chunk boundary mid-churn,
                     requeued onto ``--shards 2``: the journal alone
                     replays the mutations and the repartitions
``race_mirror_exit`` the race checker's seeded schedule fuzzer
                     (``GRAPHDYN_RACECHECK=1`` + ``GRAPHDYN_RACEFUZZ``) on
                     the mirror-flush-vs-exit race, in real child
                     processes with every write-behind copy stalled: the
                     atexit ``flush_mirror`` delivers the last replica; at
                     the pinned seed a control child with that
                     registration undone must lose it
``race_prefetch_close`` prefetcher close-vs-emit under the same seeded
                     jitter: close mid-stream neither deadlocks nor leaks a
                     worker, the fuzzed stream equals the synchronous
                     builds, the overlap gauge lands exactly once
``serve_kill_requeue`` the multi-tenant job service: tenants submit to a
                     durable spool with no server alive (one oversized job
                     the byte model must refuse, one short-timeout job the
                     deadline must evict), a serving child process is
                     hard-killed mid-dispatch at a seeded position (the
                     claimed job left ``running`` on disk), a fresh child
                     recovers the orphan from disk alone and drains the
                     queue; every accepted job bit-exact to a fault-free
                     oracle, the spool journal carrying the whole
                     submit/refuse/requeue/evict/done story
==================== ======================================================

The workloads reach the port's kernels on the card: the ``entropy`` runs
the BDCM sweep kernel (K3′), ``stream`` and ``stream_shard`` the bucketed
step (KB); ``sa`` is plain PyTorch. A ``stream_shard`` episode is one job
of spawned gloo ranks (:func:`graphdyn_torch.scripts.halo_ranks.
run_ranks`), as many as its ``--shards``, each running the CLI with the
episode's fault plan; rank 0 runs in the episode's directory, where its
post-mortem lands. ``serve_kill_requeue``'s children serve on
``--device``'s device (K4′ on the card) from the one kernel build
directory of the checkout, so no child rebuilds a kernel, and under the
race checker's schedule fuzzer (:mod:`graphdyn_torch.analysis.racecheck`),
as the JAX package's children are. All fifteen of the JAX package's
scenarios are ported.

Run it: ``python -m graphdyn_torch.resilience.soak [--bounded] [--seeds N]
[--scenarios a,b,…] [--device cpu] [--list] [--format text|json]``.
``--bounded`` is the tier-1 configuration (small workloads, 3 seeds, every
ported scenario).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from graphdyn_torch.resilience import faults as _faults
from graphdyn_torch.resilience import store as _store

#: exit codes the harness accepts from an episode
EX_OK = 0
EX_TEMPFAIL = 75

#: default seeds of the bounded (tier-1) configuration
BOUNDED_SEEDS = (0, 1, 2)


@dataclasses.dataclass
class Episode:
    """One kill/requeue cycle: optional pre-op mutating on-disk state (the
    "between processes" fault), a fault plan for the run, extra top-level
    CLI flags for just this episode (e.g. ``--deadline``), and the exit the
    contract demands."""

    specs: list
    expect: int = EX_TEMPFAIL
    pre: str | None = None          # "truncate_current" | "nuke_primary"
    extra_args: tuple = ()
    #: subcommand flags appended AFTER the workload's own (argparse is
    #: last-wins, so an episode can override a workload default — e.g.
    #: requeue onto a shrunk ``--shards``)
    post_args: tuple = ()


@dataclasses.dataclass
class Scenario:
    name: str
    workload: str                   # "sa" | "entropy"
    summary: str
    mirror: bool = False
    #: journal ops that MUST appear for the scenario to count as exercised
    require_ops: tuple = ()
    #: flight events (counter/gauge names) that MUST appear in at least one
    #: preempted episode's post-mortem — the watchdog/deadline detection
    #: evidence is asserted, not hoped
    require_flight: tuple = ()
    #: "episodes" = the scheduler-requeue chain; "hang" / "crash_loop" =
    #: the run goes through the supervisor's own restart loop
    mode: str = "episodes"


def _plan_episodes(name: str, rng: np.random.Generator) -> list[Episode]:
    """The seeded composition for one scenario run — fault positions and
    burst lengths are drawn from the seed's stream, so three seeds exercise
    three different schedules of the same failure mode."""
    sig = {"site": "rep.boundary", "action": "signal",
           "at": int(rng.integers(1, 3))}
    lam = {"site": "lambda.boundary", "action": "signal",
           "at": int(rng.integers(1, 3))}
    if name == "torn_write":
        return [
            Episode(specs=[
                {"site": "checkpoint.write", "action": "torn",
                 "at": int(rng.integers(1, 4))},
                sig,
            ]),
            Episode(specs=[], expect=EX_OK),
        ]
    if name == "write_degrade":
        return [
            Episode(specs=[
                {"site": "checkpoint.write", "action": "raise",
                 "at": int(rng.integers(1, 3)),
                 "count": int(rng.integers(3, 7))},
                sig,
            ]),
            Episode(specs=[], expect=EX_OK),
        ]
    if name == "truncated_read":
        return [
            Episode(specs=[sig]),
            Episode(specs=[], expect=EX_OK, pre="truncate_current"),
        ]
    if name == "bitrot":
        return [
            Episode(specs=[sig]),
            Episode(specs=[
                {"site": "checkpoint.bitrot", "action": "bitrot", "at": 1},
            ], expect=EX_OK),
        ]
    if name == "mirror_failover":
        return [
            Episode(specs=[lam]),
            Episode(specs=[], expect=EX_OK, pre="nuke_primary"),
        ]
    if name == "mirror_degraded":
        return [
            Episode(specs=[
                {"site": "mirror.write", "action": "raise", "at": 1,
                 "count": 99},
                lam,
            ]),
            Episode(specs=[], expect=EX_OK),
        ]
    if name == "requeue_storm":
        eps = [
            Episode(specs=[{"site": "rep.boundary", "action": "signal",
                            "at": int(rng.integers(1, 3))}])
            for _ in range(int(rng.integers(2, 4)))
        ]
        return eps + [Episode(specs=[], expect=EX_OK)]
    if name == "stream_shard_requeue":
        # preempt the sharded stream at a chunk boundary mid-churn, then
        # requeue onto a shrunk shard count: the snapshot and the journal
        # alone give the global state back, the requeued job replays the
        # journaled mutations and partitions the replayed graph afresh
        return [
            Episode(specs=[{"site": "chunk.boundary", "action": "signal",
                            "at": int(rng.integers(2, 5))}]),
            Episode(specs=[], expect=EX_OK, post_args=("--shards", "2")),
        ]
    if name == "stream_churn":
        # preempt the out-of-core streamed rollout at chunk boundaries
        # while its churn schedule is live — twice, so the second resume
        # must replay journaled mutations written across TWO processes —
        # then a clean finish. The signal action takes the graceful
        # checkpoint path (deterministic, race-free); the stream.churn
        # journal is the replay evidence _check_journal asserts on.
        return [
            Episode(specs=[{"site": "chunk.boundary", "action": "signal",
                            "at": int(rng.integers(2, 5))}]),
            Episode(specs=[{"site": "chunk.boundary", "action": "signal",
                            "at": int(rng.integers(2, 5))}]),
            Episode(specs=[], expect=EX_OK),
        ]
    if name == "deadline_preempt":
        # the preemption is the --deadline timer taking the SIGTERM path
        # mid-run; the requeue runs without it. A side-effect-only `stall`
        # at the first lambda boundary (this is the ENTROPY workload) pins
        # the run PAST the deadline: the bounded workload warmed by an
        # in-suite run can finish in under 0.1 s wall on a fast container,
        # and a run that beats the timer exercises nothing (observed — the
        # scenario went red exactly that way). The stall only holds the
        # run alive while the timer fires; the preemption path under test
        # is untouched.
        return [
            Episode(specs=[{"site": "lambda.boundary", "action": "stall",
                            "secs": 0.3, "at": 1}],
                    extra_args=("--deadline", "0.1")),
            Episode(specs=[], expect=EX_OK),
        ]
    raise ValueError(f"unknown scenario {name!r}")


#: hang_detect tuning: the injected stall must dwarf the watchdog timeout
#: (detection happens mid-sleep) while the timeout stays far above any
#: legitimate inter-boundary gap of the warmed bounded workload
STALL_SECS = 2.0
STALL_TIMEOUT_S = 0.75


SCENARIOS: dict[str, Scenario] = {
    s.name: s for s in (
        Scenario("torn_write", "sa",
                 "torn save temp file, then preemption, then requeue",
                 require_ops=("save", "load")),
        Scenario("write_degrade", "sa",
                 "save ENOSPC burst (retry→skip-save), preemption, requeue",
                 require_ops=("save",)),
        Scenario("truncated_read", "sa",
                 "preempt, truncate the published snapshot, requeue falls "
                 "back to a retained version",
                 require_ops=("save", "quarantine", "failover")),
        Scenario("bitrot", "sa",
                 "preempt, silent byte flips in a valid container — the "
                 "checksum manifest must catch it 100% of the time",
                 require_ops=("save", "quarantine", "failover")),
        Scenario("mirror_failover", "entropy",
                 "preempt, primary checkpoint directory dies, requeue "
                 "resumes from the mirror", mirror=True,
                 require_ops=("save", "failover")),
        Scenario("mirror_degraded", "entropy",
                 "mirror ENOSPC: primary proceeds, journal records the "
                 "degraded mirror", mirror=True,
                 require_ops=("save", "mirror.degraded")),
        Scenario("requeue_storm", "sa",
                 "several preemptions at randomized boundaries in a row",
                 require_ops=("save", "load")),
        Scenario("hang_detect", "sa",
                 "injected mid-run stall: the watchdog detects the silent "
                 "heartbeat, preempts gracefully, the supervisor "
                 "auto-restarts, the finished run is bit-exact",
                 require_ops=("save", "load", "supervise.start",
                              "supervise.restart"),
                 require_flight=("supervise.stall_detected",),
                 mode="hang"),
        # require_ops carries no "load": a deadline firing before the first
        # λ completes leaves nothing resumable (cold starts re-derive — the
        # boundary hook's documented skip), and the requeue legitimately
        # starts fresh; the snapshot→load→resume proof under supervision is
        # hang_detect's job
        Scenario("deadline_preempt", "entropy",
                 "--deadline expires mid-ladder: graceful snapshot + exit "
                 "75 on a timer, requeue finishes bit-exactly",
                 require_ops=("save",),
                 require_flight=("supervise.deadline",)),
        Scenario("crash_loop_quarantine", "sa",
                 "same-site crash on every restart: the supervisor backs "
                 "off, then quarantines with bundled post-mortems instead "
                 "of restarting forever",
                 require_ops=("supervise.start", "supervise.restart",
                              "supervise.quarantine"),
                 mode="crash_loop"),
        Scenario("race_mirror_exit", "store",
                 "seeded schedule fuzz on the mirror-flush-vs-exit race: "
                 "the atexit flush must always deliver the last replica, "
                 "and the pinned-seed reverted-fix control leg must lose "
                 "it (the fuzzer detects the historical bug class)",
                 mirror=True, require_ops=("save", "mirror.save"),
                 mode="race_mirror"),
        Scenario("race_prefetch_close", "pipeline",
                 "seeded schedule fuzz on prefetcher close-vs-emit: no "
                 "deadlock or thread leak, fuzzed stream bit-exact with "
                 "synchronous builds, overlap gauge exactly once",
                 mode="race_prefetch"),
        Scenario("stream_churn", "stream",
                 "out-of-core streamed rollout with live edge churn: "
                 "preempted twice at chunk boundaries mid-churn, each "
                 "requeue replays the journaled mutations bit-exactly "
                 "from the journal alone (the schedule past the resume "
                 "point is never re-trusted)",
                 require_ops=("save", "load", "stream.churn")),
        Scenario("stream_shard_requeue", "stream_shard",
                 "sharded streamed rollout with churn-driven live "
                 "repartition: preempted at a chunk boundary mid-churn, "
                 "requeued onto a SHRUNK shard count — the journal alone "
                 "replays the mutations and the repartition story "
                 "bit-exactly at the new partition",
                 require_ops=("save", "load", "stream.churn",
                              "stream.repartition")),
        Scenario("serve_kill_requeue", "serve",
                 "multi-tenant serve spool: hard kill mid-dispatch, "
                 "restart recovers the orphaned job from disk, oversized "
                 "job refused by the byte model, short-timeout job "
                 "evicted, every accepted job bit-exact after requeue",
                 require_ops=("serve.submit", "serve.refuse",
                              "serve.requeue", "serve.evict",
                              "serve.done"),
                 mode="serve"),
    )
}

# ---------------------------------------------------------------------------
# workloads (real CLI command lines)
# ---------------------------------------------------------------------------


def _workload_args(kind: str, out: str, ckpt: str | None,
                   mirror: str | None, device: str = "cuda") -> list[str]:
    pre: list[str] = []
    if mirror:
        pre += ["--ckpt-mirror", mirror]
    if kind == "sa":
        args = ["sa", "--n", "40", "--d", "3", "--p", "1", "--c", "1",
                "--n-stat", "2", "--max-steps", "20000", "--seed", "0",
                "--out", out]
    elif kind == "entropy":
        args = ["entropy", "--n", "50", "--deg", "1.5", "--num-rep", "1",
                "--lmbd-max", "0.3", "--lmbd-step", "0.1",
                "--max-sweeps", "200", "--eps", "1e-5", "--seed", "1",
                "--out", out]
    elif kind == "stream":
        # bounded out-of-core run: 3 chunks, live churn every step — the
        # schedule is pure in its args, so the fault-free oracle and every
        # requeued episode chain derive the same mutations
        args = ["stream", "--n", "160", "--dmin", "2", "--steps", "10",
                "--churn-rate", "2.0", "--churn-seed", "3",
                "--chunks", "3", "--replicas", "32", "--seed", "0",
                "--out", out]
    elif kind == "stream_shard":
        # the sharded stream with churn-driven repartition: at these args
        # the seeded schedule crosses the hub threshold both ways over the
        # run (the JAX package's pinned pair), so the journal carries
        # stream.repartition next to stream.churn
        args = ["stream", "--n", "160", "--gamma", "2.3", "--dmin", "2",
                "--steps", "5", "--churn-rate", "12.0",
                "--churn-seed", "25", "--chunks", "2", "--replicas", "32",
                "--seed", "0", "--shards", "4", "--hub-threshold", "17",
                "--out", out]
    else:
        raise ValueError(f"unknown workload {kind!r}")
    args += ["--device", device]
    if ckpt is not None:
        args += ["--checkpoint", ckpt, "--checkpoint-interval", "0"]
    return pre + args


def _silence_stdout():
    """The CLI prints a result JSON line per run; dozens of soak episodes
    must not flood the harness's own stdout contract."""
    # graftlint: disable-next-line=GD007  os.devnull is not persistence — nothing can tear
    return contextlib.redirect_stdout(open(os.devnull, "w"))


def _run_cli(args: list[str], cwd: str) -> int | str:
    """One episode process: run the real CLI entry in ``cwd`` (where the
    flight recorder drops its post-mortem). Returns the exit code, or
    ``"preempt"`` for an injected hard kill."""
    from graphdyn_torch.cli import main as cli_main

    old = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        with _silence_stdout():
            try:
                return cli_main(args)
            except _faults.InjectedPreemption:
                return "preempt"
    finally:
        os.chdir(old)


def _ranked_episode(rank: int, world: int, args: list, cwd: str,
                    specs: list, plan_seed: int):
    """One rank of a ``stream_shard`` episode (run through
    :func:`graphdyn_torch.scripts.halo_ranks.run_ranks`): the CLI with the
    episode's fault plan, rank 0 in ``cwd`` and the others beside it."""
    if rank:
        cwd = os.path.join(cwd, f"rank{rank}")
    plan = (_faults.FaultPlan([_faults.FaultSpec(**sp) for sp in specs],
                              seed=plan_seed)
            if specs else contextlib.nullcontext())
    with plan:
        return _run_cli(args, cwd)


def _shards_of(args: list[str]) -> int:
    """The last ``--shards`` of a command line (argparse is last-wins)."""
    idx = [i for i, a in enumerate(args) if a == "--shards"]
    return int(args[idx[-1] + 1]) if idx else 1


def _run_episode(kind: str, args: list[str], cwd: str, specs: list,
                 plan_seed: int, device: str) -> int | str:
    """One episode: the CLI in this process under the fault plan, or for
    ``stream_shard`` one job of spawned gloo ranks (every rank must exit
    alike; a disagreement is reported as the rank codes)."""
    if kind == "stream_shard":
        from graphdyn_torch.scripts.halo_ranks import run_ranks

        os.makedirs(cwd, exist_ok=True)
        rcs = run_ranks(_ranked_episode, _shards_of(args), args, cwd,
                        specs, plan_seed, device=device, backend="gloo",
                        timeout=600)
        return rcs[0] if len(set(map(str, rcs))) == 1 else \
            f"ranks disagree: {rcs}"
    plan = (_faults.FaultPlan([_faults.FaultSpec(**sp) for sp in specs],
                              seed=plan_seed)
            if specs else contextlib.nullcontext())
    with plan:
        return _run_cli(args, cwd)


def _oracle(kind: str, root: str, cache: dict,
            device: str = "cuda") -> dict[str, np.ndarray]:
    """The fault-free reference run (no checkpointing, no faults), cached
    per workload kind — parity target for every episode chain."""
    if (kind, device) not in cache:
        from graphdyn_torch.utils.io import load_results_npz

        odir = os.path.join(root, "oracle", kind)
        out = os.path.join(odir, "res.npz")
        rc = _run_episode(kind, _workload_args(kind, out, None, None,
                                               device), odir, [], 0, device)
        if rc != 0:
            raise RuntimeError(f"oracle run for {kind!r} failed: rc={rc}")
        cache[(kind, device)] = load_results_npz(out)
    return cache[(kind, device)]


# ---------------------------------------------------------------------------
# the soak loop
# ---------------------------------------------------------------------------


def _apply_pre(pre: str | None, primary_dir: str, ckpt: str) -> None:
    if pre is None:
        return
    if pre == "truncate_current":
        _faults.truncate_file(ckpt + ".npz", 0.4)
    elif pre == "nuke_primary":
        # the primary checkpoint directory dies wholesale — snapshots,
        # versions, manifests AND the journal (a dead disk keeps nothing)
        shutil.rmtree(primary_dir, ignore_errors=True)
    else:
        raise ValueError(f"unknown pre-op {pre!r}")


def _flight_names(cwd: str) -> set:
    """Counter/gauge event names carried by the episode's flight
    post-mortem (empty when none exists / unparseable) — the detection
    evidence ``Scenario.require_flight`` asserts on."""
    from graphdyn_torch.obs.flight import POSTMORTEM_NAME
    from graphdyn_torch.obs.recorder import read_ledger

    path = os.path.join(cwd, POSTMORTEM_NAME)
    if not os.path.exists(path):
        return set()
    try:
        events, _ = read_ledger(path)
    except ValueError:
        return set()
    return {e.get("name") for e in events
            if e.get("ev") in ("counter", "gauge")}


def _check_journal(journal: str, require_ops: tuple,
                   problems: list) -> list[str]:
    """Validate the surviving run journal and assert the scenario's
    required ops appeared; returns the op list (appends problems)."""
    ops: list[str] = []
    if os.path.exists(journal):
        events, jproblems = _store.validate_journal(journal)
        problems += [f"journal: {p}" for p in jproblems]
        ops = [e.get("op") for e in events if e.get("ev") == "journal"]
    else:
        problems.append("no run journal was written")
    for op in require_ops:
        if op not in ops:
            problems.append(
                f"journal never recorded the scenario's {op!r} op "
                f"(saw {sorted(set(ops))})"
            )
    return ops


def _check_parity(kind: str, out: str, root: str, oracle_cache: dict,
                  problems: list, device: str = "cuda") -> None:
    """Bit-exact result parity against the fault-free oracle."""
    from graphdyn_torch.utils.io import load_results_npz

    oracle = _oracle(kind, root, oracle_cache, device)
    got = load_results_npz(out)
    if set(got) != set(oracle):
        problems.append(
            f"result keys differ: {sorted(got)} vs {sorted(oracle)}")
    else:
        for k in oracle:
            if not np.array_equal(got[k], oracle[k]):
                problems.append(f"result array {k!r} is not bit-exact")


def _postmortem_story(cwd: str, preempted: bool) -> str | None:
    """The flight-recorder contract per episode: a preempted episode leaves
    a parseable post-mortem naming the crash, a clean one leaves none.
    Returns a problem string or None."""
    from graphdyn_torch.obs.flight import POSTMORTEM_NAME
    from graphdyn_torch.obs.recorder import read_ledger

    path = os.path.join(cwd, POSTMORTEM_NAME)
    if not preempted:
        if os.path.exists(path):
            return f"clean episode left a post-mortem at {path}"
        return None
    if not os.path.exists(path):
        return "preempted episode left no flight post-mortem"
    try:
        events, _ = read_ledger(path)
    except ValueError as e:
        return f"unparseable post-mortem: {e}"
    crash = [e for e in events
             if e.get("ev") == "counter" and e.get("name") == "obs.crash"]
    if not crash:
        return "post-mortem carries no obs.crash event"
    if not (crash[-1].get("attrs") or {}).get("site"):
        return "obs.crash names no site"
    return None


def run_scenario(name: str, seed: int, root: str,
                 oracle_cache: dict, device: str = "cuda") -> dict:
    """One (scenario, seed) soak run: the episode chain, then the contract
    checks (oracle parity, journal validity + required ops, flight story +
    required detection events). Returns a report dict with ``ok`` +
    per-check details. Supervised scenarios (``mode`` = "hang" /
    "crash_loop") go through the supervisor's own restart loop instead of
    the scheduler-requeue episode chain."""
    scn = SCENARIOS[name]
    if scn.mode == "race_mirror":
        return _run_race_mirror(scn, seed, root)
    if scn.mode == "race_prefetch":
        return _run_race_prefetch(scn, seed, root)
    if scn.mode == "hang":
        return _run_hang_detect(scn, seed, root, oracle_cache, device)
    if scn.mode == "crash_loop":
        return _run_crash_loop(scn, seed, root, oracle_cache, device)
    if scn.mode == "serve":
        return _run_serve_kill_requeue(scn, seed, root, oracle_cache,
                                       device)
    rng = np.random.default_rng(seed)
    episodes = _plan_episodes(name, rng)
    workdir = os.path.join(root, name, f"seed{seed}")
    primary_dir = os.path.join(workdir, "primary")
    mirror_dir = os.path.join(workdir, "mirror") if scn.mirror else None
    ckpt = os.path.join(primary_dir, "ck")
    out = os.path.join(workdir, "res.npz")
    args = _workload_args(scn.workload, out, ckpt, mirror_dir, device)

    problems: list[str] = []
    ep_log: list[dict] = []
    flight_seen: set = set()
    for i, ep in enumerate(episodes):
        _apply_pre(ep.pre, primary_dir, ckpt)
        # each episode simulates a fresh requeued process: the journal
        # stamps a new manifest line (the exactly-once seam)
        _store._reset_journal_state()
        cwd = os.path.join(workdir, f"ep{i}")
        plan_seed = int(rng.integers(0, 2**31 - 1))
        rc = _run_episode(scn.workload,
                          list(ep.extra_args) + args + list(ep.post_args),
                          cwd, ep.specs, plan_seed, device)
        ep_log.append({"episode": i, "rc": rc, "specs": ep.specs,
                       "pre": ep.pre, "extra_args": list(ep.extra_args),
                       "post_args": list(ep.post_args)})
        early = rc == EX_OK and ep.expect == EX_TEMPFAIL
        if early:
            # a randomized schedule may plan its kill past the work that
            # remains after resume (e.g. the signal lands after the last
            # repetition) — completing early is a legitimate outcome of a
            # chaos chain, and the parity/journal checks below still hold
            # it to the full contract
            ep_log[-1]["early_finish"] = True
        elif rc != ep.expect:
            problems.append(
                f"episode {i}: exit {rc!r}, expected {ep.expect} "
                f"(specs {ep.specs}, pre {ep.pre})"
            )
            break
        story = _postmortem_story(cwd, preempted=(rc == EX_TEMPFAIL))
        if story:
            problems.append(f"episode {i}: {story}")
        if rc == EX_TEMPFAIL:
            flight_seen |= _flight_names(cwd)
        if early:
            break
    if not problems and not any(e["rc"] == EX_TEMPFAIL for e in ep_log):
        problems.append(
            "no episode was actually preempted — the scenario never "
            "exercised its fault composition"
        )
    # the detection evidence: e.g. deadline_preempt's post-mortem must
    # carry the watchdog's supervise.deadline event — the preemption being
    # CAUSED by the timer is asserted, not assumed
    for want in scn.require_flight:
        if not problems and want not in flight_seen:
            problems.append(
                f"no preempted episode's post-mortem carries the "
                f"{want!r} event (saw {sorted(flight_seen)})"
            )

    # 1. bit-exact parity with the fault-free oracle
    if not problems:
        _check_parity(scn.workload, out, root, oracle_cache, problems,
                      device)

    # 2. the journal story (the one that survived — after a primary nuke
    # that is the post-failover journal)
    journal = os.path.join(primary_dir, _store.JOURNAL_NAME)
    ops = _check_journal(journal, scn.require_ops, problems)
    # bitrot acceptance: detection must be unconditional — the quarantine
    # reason names the checksum layer, never an accepted wrong resume
    if name == "bitrot" and not problems:
        qs = [e for e in _store.validate_journal(journal)[0]
              if e.get("op") == "quarantine"]
        if not any("Checksum" in (q.get("reason") or "") for q in qs):
            problems.append("bitrot was not caught by the checksum layer")

    return {"scenario": name, "seed": seed, "workload": scn.workload,
            "episodes": ep_log, "journal_ops": sorted(set(ops)),
            "problems": problems, "ok": not problems}


def _supervise_policy():
    """The bounded-soak restart policy: tiny seeded-jitter backoffs (the
    schedule's SHAPE is the contract; production uses the CLI defaults)."""
    from graphdyn_torch.resilience.retry import RetryPolicy
    from graphdyn_torch.resilience.supervisor import RestartPolicy

    return RestartPolicy(
        quarantine_after=3, max_crashes=6, max_episodes=10,
        backoff=RetryPolicy(tries=8, base_delay_s=0.01, max_delay_s=0.05,
                            jitter=True),
    )


def _run_hang_detect(scn: Scenario, seed: int, root: str,
                     oracle_cache: dict, device: str = "cuda") -> dict:
    """The acceptance loop end to end: a mid-run ``stall`` fault stops the
    heartbeats → the ``--stall-timeout`` watchdog detects it mid-sleep and
    requests the graceful snapshot + exit-75 path → the SUPERVISOR
    auto-restarts from the durable snapshot → the finished run is bit-exact
    with the fault-free oracle, and journal + post-mortem tell the story."""
    from graphdyn_torch.resilience import supervisor as _sup

    rng = np.random.default_rng(seed)
    workdir = os.path.join(root, scn.name, f"seed{seed}")
    primary_dir = os.path.join(workdir, "primary")
    ckpt = os.path.join(primary_dir, "ck")
    out = os.path.join(workdir, "res.npz")
    args = _workload_args(scn.workload, out, ckpt, None, device)
    problems: list[str] = []
    # warm the oracle FIRST: it doubles as the kernel build and warm-up, so
    # the supervised run's watchdog times heartbeat gaps, never a cold start
    _oracle(scn.workload, root, oracle_cache, device)

    plan = _faults.FaultPlan(
        [_faults.FaultSpec("rep.boundary", "stall",
                           at=int(rng.integers(1, 3)), secs=STALL_SECS)],
        seed=seed,
    )
    _store._reset_journal_state()
    with plan:
        report = _sup.supervise(
            args, workdir=workdir, policy=_supervise_policy(),
            runner=_sup.run_inprocess, stall_timeout_s=STALL_TIMEOUT_S,
            journal_dir=primary_dir,
        )
    eps = report["episodes"]
    if report["exit"] != 0:
        problems.append(
            f"supervised run did not finish: exit {report['exit']} "
            f"({report['reason']}; episodes {eps})"
        )
    if not eps or eps[0]["rc"] != EX_TEMPFAIL:
        problems.append(
            f"first episode was not preempted by the watchdog "
            f"(episodes {eps})"
        )
    if len(eps) < 2:
        problems.append("the supervisor never restarted the run")
    # detection evidence: the preempted episode's post-mortem must carry
    # the watchdog's stall_detected event, with the stall older than the
    # timeout (i.e. the watchdog measured a real heartbeat gap)
    flight_seen: set = set()
    detected_ok = False
    for ep in eps:
        if ep["rc"] != EX_TEMPFAIL:
            continue
        cwd = ep["cwd"]
        story = _postmortem_story(cwd, preempted=True)
        if story:
            problems.append(f"episode {ep['episode']}: {story}")
        flight_seen |= _flight_names(cwd)
        from graphdyn_torch.obs.flight import POSTMORTEM_NAME
        from graphdyn_torch.obs.recorder import read_ledger

        try:
            events, _ = read_ledger(os.path.join(cwd, POSTMORTEM_NAME))
        except (OSError, ValueError):
            events = []
        stalls = [e for e in events
                  if e.get("name") == "supervise.stall_detected"]
        if stalls and (stalls[-1].get("attrs") or {}).get(
                "age_s", 0) >= STALL_TIMEOUT_S:
            detected_ok = True
    for want in scn.require_flight:
        if want not in flight_seen:
            problems.append(
                f"no preempted episode's post-mortem carries the "
                f"{want!r} event (saw {sorted(flight_seen)})"
            )
    if not detected_ok and not problems:
        problems.append(
            "stall_detected event carries no heartbeat age >= the timeout"
        )
    if not problems:
        _check_parity(scn.workload, out, root, oracle_cache, problems,
                      device)
    journal = os.path.join(primary_dir, _store.JOURNAL_NAME)
    ops = _check_journal(journal, scn.require_ops, problems)
    return {"scenario": scn.name, "seed": seed, "workload": scn.workload,
            "episodes": eps, "journal_ops": sorted(set(ops)),
            "problems": problems, "ok": not problems}


def _run_crash_loop(scn: Scenario, seed: int, root: str,
                    oracle_cache: dict, device: str = "cuda") -> dict:
    """The quarantine half of the acceptance: a run crash-looping at ONE
    site is restarted with backoff exactly ``quarantine_after - 1`` times,
    then quarantined — journal ``supervise.quarantine`` + bundled
    post-mortems present, exit :data:`~graphdyn_torch.resilience.supervisor
    .EX_QUARANTINE`, and NO results file (a quarantined run must not look
    completed)."""
    from graphdyn_torch.resilience import supervisor as _sup

    workdir = os.path.join(root, scn.name, f"seed{seed}")
    primary_dir = os.path.join(workdir, "primary")
    ckpt = os.path.join(primary_dir, "ck")
    out = os.path.join(workdir, "res.npz")
    # --group-size 0: the serial per-rep chain drives through
    # ChainCheckpointer.drive, whose chunk.boundary fault site fires BEFORE
    # the chunk's snapshot — so every restart re-crashes at the very same
    # chunk with zero progress: the genuine crash-on-same-input loop
    # (rep.boundary would fire after the prefix snapshot and "progress"
    # its way out of the loop)
    args = _workload_args(scn.workload, out, ckpt, None, device) + \
        ["--group-size", "0"]
    problems: list[str] = []
    policy = _supervise_policy()
    # the same organic crash on EVERY restart: a huge count keeps the spec
    # firing at the first chunk boundary of each episode
    plan = _faults.FaultPlan(
        [_faults.FaultSpec("chunk.boundary", "raise", at=1, count=10_000)],
        seed=seed,
    )
    _store._reset_journal_state()
    with plan:
        report = _sup.supervise(
            args, workdir=workdir, policy=policy,
            runner=_sup.run_inprocess, journal_dir=primary_dir,
        )
    eps = report["episodes"]
    if report["exit"] != _sup.EX_QUARANTINE or not report.get("quarantined"):
        problems.append(
            f"run was not quarantined: exit {report['exit']} "
            f"({report['reason']}; episodes {eps})"
        )
    if len(eps) != policy.quarantine_after:
        problems.append(
            f"expected exactly {policy.quarantine_after} crash episodes "
            f"(no N+1-th restart), got {len(eps)}: {eps}"
        )
    sites = {ep.get("site") for ep in eps}
    if len(sites) != 1:
        problems.append(f"crash episodes disagree on the site: {sites}")
    bundle = report.get("bundle")
    if not bundle or not os.path.exists(bundle):
        problems.append(f"no quarantine bundle was written ({bundle})")
    else:
        with open(bundle, encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("crashes") != policy.quarantine_after:
            problems.append(f"bundle crash count wrong: {doc.get('crashes')}")
        pms = doc.get("postmortems") or []
        if len(pms) != policy.quarantine_after:
            problems.append(
                f"bundle should carry {policy.quarantine_after} "
                f"post-mortems, has {len(pms)}"
            )
        for pm in pms:
            if not os.path.exists(pm):
                problems.append(f"bundled post-mortem missing: {pm}")
    if os.path.exists(out):
        problems.append(
            "a quarantined run must not leave a results file — it never "
            "completed"
        )
    journal = os.path.join(primary_dir, _store.JOURNAL_NAME)
    ops = _check_journal(journal, scn.require_ops, problems)
    restarts = ops.count("supervise.restart")
    if restarts != policy.quarantine_after - 1:
        problems.append(
            f"journal records {restarts} supervise.restart event(s), "
            f"expected {policy.quarantine_after - 1}"
        )
    return {"scenario": scn.name, "seed": seed, "workload": scn.workload,
            "episodes": eps, "journal_ops": sorted(set(ops)),
            "problems": problems, "ok": not problems}


# ---------------------------------------------------------------------------
# the race checker's seeded-schedule scenarios
# ---------------------------------------------------------------------------

#: lock-jitter cap for the race scenarios (GRAPHDYN_RACEFUZZ_MAX_MS)
RACE_FUZZ_MAX_MS = 30.0
#: the mirror.copy stall (seconds): it must dwarf the child's main-thread
#: runtime from its first save to its exit (well under 0.25 s with the
#: worst jitter), so the reverted-fix control leg loses the last replica
#: deterministically, while the atexit flush (timeout 10 s) always drains
RACE_STALL_SECS = 0.35
#: saves per child: enough that the write-behind queue is deep at exit
RACE_SAVES = 4
#: the control leg (fix reverted) runs at this seed only: pinned, so the
#: red outcome is one reproducible schedule
RACE_PIN_SEED = 0
#: the port's prefetch worker's thread name
PREFETCH_THREAD = "graphdyn-torch-prefetch"


def _race_mirror_child(primary: str, mirror: str, revert: bool) -> str:
    """The subprocess body of ``race_mirror_exit``: N durable saves with a
    write-behind mirror, then fall off the end — exit-vs-flush is the race
    under test. ``revert=True`` unregisters the atexit ``flush_mirror``
    (the historical bug) without touching shipped code."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    lines = [
        "import sys",
        f"sys.path.insert(0, {repo!r})",
        "import numpy as np",
        "from graphdyn_torch.analysis.racecheck import maybe_install",
        "from graphdyn_torch.resilience.store import (DurableCheckpoint, "
        "configure_store, flush_mirror)",
        "maybe_install()",
        f"configure_store(mirror={mirror!r}, keep={RACE_SAVES * 2})",
    ]
    if revert:
        lines += [
            "import atexit",
            "atexit.unregister(flush_mirror)   # the reverted fix",
        ]
    lines += [
        f"ck = DurableCheckpoint({os.path.join(primary, 'ck')!r})",
        f"for i in range({RACE_SAVES}):",
        "    ck.save({'state': np.arange(64) + i}, {'i': i})",
        "# fall off the end: interpreter teardown races the queue",
    ]
    return "\n".join(lines) + "\n"


def _race_mirror_env(seed: int) -> dict:
    env = dict(os.environ)
    env.update({
        "GRAPHDYN_RACECHECK": "1",
        "GRAPHDYN_RACEFUZZ": str(seed),
        "GRAPHDYN_RACEFUZZ_MAX_MS": str(RACE_FUZZ_MAX_MS),
        # a thread-side delay the lock proxy cannot reach: stall every
        # write-behind copy on the worker (an env plan is process-global,
        # so the WORKER thread polls it)
        "GRAPHDYN_FAULT_PLAN": json.dumps([{
            "site": "mirror.copy", "action": "stall",
            "secs": RACE_STALL_SECS, "at": 1, "count": 999,
        }]),
    })
    env.pop("GRAPHDYN_CKPT_MIRROR", None)
    return env


def _mirror_last_replica(primary: str, mirror: str) -> str:
    """The mirror-side path of the LAST save's immutable version, through
    the store's own namespacing (``_mirror_base``), so a layout change there
    can never read as a lost-replica race here."""
    mbase = _store.DurableCheckpoint(
        os.path.join(primary, "ck"), mirror=mirror)._mirror_base()
    return f"{mbase}.v{RACE_SAVES}.npz"


def _run_race_mirror(scn: Scenario, seed: int, root: str) -> dict:
    """Mirror-flush-vs-exit under the seeded schedule fuzzer, end to end in
    real subprocesses. Green leg (every seed): with the atexit
    ``flush_mirror`` registration present, the last save's replica is in
    the mirror after exit despite per-copy stalls and lock jitter. Control
    leg (pinned seed only): the same child with the registration undone
    must LOSE the last replica, so a future revert of the fix goes red."""
    import subprocess

    workdir = os.path.join(root, scn.name, f"seed{seed}")
    problems: list[str] = []
    ep_log: list[dict] = []

    def start(tag: str, revert: bool):
        d = os.path.join(workdir, tag)
        primary = os.path.join(d, "primary")
        mirror = os.path.join(d, "mirror")
        os.makedirs(primary, exist_ok=True)
        script = _race_mirror_child(primary, mirror, revert)
        proc = subprocess.Popen(
            [sys.executable, "-c", script], stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True, env=_race_mirror_env(seed),
            cwd=d)
        return tag, revert, proc, primary, mirror

    def finish(run) -> tuple[str, str]:
        tag, revert, proc, primary, mirror = run
        try:
            _, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        ep_log.append({"episode": tag, "rc": proc.returncode,
                       "revert": revert})
        if proc.returncode != 0:
            problems.append(
                f"{tag} child exited {proc.returncode}: {err[-500:]}")
        return primary, mirror

    # the two legs are independent children in their own directories: they
    # run side by side (the race is inside each child, between its main
    # thread's exit and its own write-behind worker)
    green = start("green", revert=False)
    control = start("reverted", revert=True) \
        if seed == RACE_PIN_SEED else None
    primary, mirror = finish(green)
    last = _mirror_last_replica(primary, mirror)
    if not problems and not os.path.exists(last):
        problems.append(
            f"atexit flush_mirror LOST the last write-behind replica "
            f"under fuzz seed {seed} (missing {last}) — the "
            f"flush-vs-exit race regressed")
    if not problems:
        pub = os.path.join(os.path.dirname(last), "ck.npz")
        got = np.load(pub)["state"][0] if os.path.exists(pub) else None
        if got != RACE_SAVES - 1:
            problems.append(
                f"published mirror replica is not the LAST save "
                f"(state[0]={got}, want {RACE_SAVES - 1})")
    journal = os.path.join(primary, _store.JOURNAL_NAME)
    ops = _check_journal(journal, scn.require_ops, problems)

    # control leg, pinned seed: reverting the fix must lose the race
    lost = None
    if control is not None:
        primary_r, mirror_r = finish(control)
        lost = not os.path.exists(_mirror_last_replica(primary_r, mirror_r))
        if not problems and not lost:
            problems.append(
                "control leg: with atexit flush_mirror REVERTED the last "
                "replica still reached the mirror — the fuzzer no longer "
                "detects the historical bug class (stall/jitter budget "
                "too small?)")

    return {"scenario": scn.name, "seed": seed, "workload": scn.workload,
            "episodes": ep_log, "journal_ops": sorted(set(ops)),
            "control_lost_replica": lost,
            "problems": problems, "ok": not problems}


def _run_race_prefetch(scn: Scenario, seed: int, root: str) -> dict:
    """Prefetcher close-vs-emit under the seeded schedule fuzzer,
    in-process: (a) close() mid-stream — worker mid-build or blocked on a
    full queue — returns without deadlock and releases the thread,
    idempotently; (b) the fuzzed threaded stream is bit-exact with the
    synchronous builds; (c) with a recorder, the overlap gauge lands exactly
    once per prefetcher. The inventoried locks the fuzzer jitters here are
    the flight ring's and the journal's: every obs emission the worker and
    the closer make is schedule-perturbed."""
    import threading

    from graphdyn_torch import obs
    from graphdyn_torch.analysis import racecheck as _rc
    from graphdyn_torch.obs import flight
    from graphdyn_torch.pipeline.prefetch import HostPrefetcher

    workdir = os.path.join(root, scn.name, f"seed{seed}")
    os.makedirs(workdir, exist_ok=True)
    problems: list[str] = []
    rng = np.random.default_rng(seed)
    delays = rng.uniform(0.0, 0.004, size=16)

    def build(k: int):
        # seeded build latency widens the emit-vs-close window; the value
        # is a pure function of k (the prefetcher's determinism premise)
        # graftrace: disable-next-line=GT005  injected build latency for the race scenario, not synchronization
        time.sleep(float(delays[k]))
        return np.arange(32, dtype=np.int64) + k

    def live_workers() -> list:
        return [t for t in threading.enumerate()
                if t.name == PREFETCH_THREAD and t.is_alive()]

    was_installed = _rc.installed()
    if not was_installed:
        _rc.install(fuzz_seed=seed, fuzz_max_ms=8.0)
    pre_workers = len(live_workers())
    flight.clear()                      # so the hung-counter check is ours
    leg_problems: list[str] = []

    def legs() -> None:
        # (a) close mid-stream: the depth-2 queue is full, the worker
        # blocked; close() always clears _thread (even for a hung worker it
        # merely abandons), so the leak checks run after the join below
        pf = HostPrefetcher(build, list(range(12)), depth=2)
        first = pf.get(0)
        if not np.array_equal(first, np.arange(32, dtype=np.int64)):
            leg_problems.append("mid-stream get returned the wrong build")
        pf.close()
        pf.close()                      # idempotent under fuzz
        # (b) full fuzzed stream == synchronous builds, bit-exact
        pf2 = HostPrefetcher(build, list(range(12)), depth=3)
        got = [pf2.get(k) for k in range(12)]
        pf2.close()
        if not all(np.array_equal(g, np.arange(32, dtype=np.int64) + k)
                   for k, g in enumerate(got)):
            leg_problems.append(
                "fuzzed prefetch stream diverged from synchronous builds")
        # (c) overlap gauge exactly once per prefetcher
        if not obs.enabled():
            from graphdyn_torch.obs.recorder import read_ledger

            ledger = os.path.join(workdir, "obs.jsonl")
            with obs.recording(ledger):
                pf3 = HostPrefetcher(build, list(range(6)), depth=2)
                for k in range(3):
                    pf3.get(k)
                pf3.close()
                pf3.close()
            events, _ = read_ledger(ledger)
            n = sum(1 for e in events
                    if e.get("name") == "pipeline.prefetch.overlap_util")
            if n != 1:
                leg_problems.append(
                    f"expected exactly one overlap gauge per closed "
                    f"prefetcher, got {n}")

    try:
        # the legs run on a bounded worker: get() blocks on an untimed
        # Queue.get, so the wedge this scenario exists to catch would
        # otherwise hang the soak; the join timeout is the deadline
        runner = threading.Thread(target=legs, name="graphdyn-soak-race-legs",
                                  daemon=True)
        runner.start()
        runner.join(timeout=60.0)
        if runner.is_alive():
            problems.append(
                "scenario WEDGED: the prefetch legs did not finish within "
                "60 s — a get/close/emit path deadlocked under fuzz")
        else:
            problems.extend(leg_problems)
            hung = [e for e in flight.snapshot()
                    if e.get("name") == "pipeline.prefetch.hung"]
            if hung:
                problems.append(
                    f"a prefetch worker wedged past close()'s join window "
                    f"under fuzz ({len(hung)} pipeline.prefetch.hung "
                    f"event(s))")
            if len(live_workers()) > pre_workers:
                problems.append(
                    f"a live {PREFETCH_THREAD} worker survived the scenario")
    finally:
        if not was_installed:
            _rc.uninstall()
    return {"scenario": scn.name, "seed": seed, "workload": scn.workload,
            "episodes": [{"episode": 0, "rc": 0}],
            "journal_ops": [], "problems": problems, "ok": not problems}


# ---------------------------------------------------------------------------
# serve_kill_requeue: the job service's kill/requeue soak
# ---------------------------------------------------------------------------

#: serve soak: the budget pinned in the child's environment, so the
#: oversized job's refusal does not depend on the device's memory
SERVE_HBM_BUDGET = 1 << 30

#: the short-timeout job's first slice: far below the job's runtime floor,
#: so the deadline always fires during attempt 1 and the eviction runs
SERVE_EVICT_TIMEOUT_S = 0.05

#: the short-timeout job: 4096 one-sweep chunks, each a launch and a
#: completion wait on the card (a chunk after every replica froze is a
#: no-op launch, still waited on), so on any device its runtime is far
#: above the first slice; the ×4 escalations finish it
SERVE_EVICT_SPEC = {"n": 128, "d": 3, "rule": "minority",
                    "max_sweeps": 4096, "chunk_sweeps": 1}


#: serve-specific schedule-fuzz jitter bound: the serve path heartbeats at
#: every chunk boundary, so its lock-acquisition rate is far above the
#: chain scenarios'. The JAX package bounds it at 3 ms; the port's evicted
#: job runs 4096 one-sweep chunks through its escalating slices, a few
#: traced locks a chunk, so 3 ms made the scenario ~5× longer (and 1 ms
#: ~3×) for no more schedules: any jittered sleep yields the thread, which
#: is what permutes the schedule
SERVE_FUZZ_MAX_MS = 0.25


def _serve_env(device: str, seed: int) -> dict:
    """The serving child's environment: the schedule fuzzer on (seeded lock
    jitter over every inventoried lock the child takes), a pinned admission
    budget, no inherited fault plan, the repo importable."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.update({
        "GRAPHDYN_RACECHECK": "1",
        "GRAPHDYN_RACEFUZZ": str(seed),
        "GRAPHDYN_RACEFUZZ_MAX_MS": str(SERVE_FUZZ_MAX_MS),
        "GRAPHDYN_SERVE_HBM_BUDGET": str(SERVE_HBM_BUDGET),
    })
    env.pop("GRAPHDYN_FAULT_PLAN", None)
    return env


def _serve_child_script(spool: str, device: str) -> str:
    """The serving child: the real service loop on ``device``. An
    InjectedPreemption from the dispatch fault site is the hard kill: the
    child dies with the claimed job left ``running`` on disk, as a SIGKILL
    leaves it, and exits 75 like a preempted scheduler slot."""
    return "\n".join([
        "import sys",
        "import torch",
        "torch.set_num_threads(1)",
        "from graphdyn_torch.analysis.racecheck import maybe_install",
        "maybe_install()",
        "from graphdyn_torch.resilience.faults import InjectedPreemption",
        "from graphdyn_torch.serve.lifecycle import run_service",
        "try:",
        f"    rc = run_service({spool!r}, idle_exit_s=0.25, "
        f"device={device!r})",
        "except InjectedPreemption:",
        "    sys.exit(75)",
        "sys.exit(rc)",
    ]) + "\n"


def _serve_oracle(spec: dict, oracle_cache: dict, device: str) -> dict:
    """Fault-free in-harness run of one fused job spec on ``device``, the
    parity reference: the requeue path is a full deterministic replay, so
    eviction, kill and requeue may cost time but never bits."""
    from graphdyn_torch.serve.bucketing import _sa_config
    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.ops.fused import build_fused_tables
    from graphdyn_torch.search.fused import fused_anneal

    key = ("serve", device) + tuple(sorted(spec.items()))
    if key not in oracle_cache:
        g = random_regular_graph(int(spec["n"]), int(spec["d"]),
                                 seed=int(spec["graph_seed"]))
        cfg = _sa_config(spec)
        # the serve convention: the coloring is the GRAPH's (graph_seed),
        # the counter-RNG chain the job's (seed)
        tables = build_fused_tables(g, cfg, seed=int(spec["graph_seed"]))
        res = fused_anneal(
            g, cfg, n_replicas=int(spec["replicas"]),
            seed=int(spec["seed"]), m_target=float(spec["m_target"]),
            max_sweeps=int(spec["max_sweeps"]),
            chunk_sweeps=int(spec["chunk_sweeps"]), tables=tables,
            device=device,
        )
        oracle_cache[key] = {
            "conf": np.asarray(res.s),
            "mag_reached": np.asarray(res.mag_reached),
            "m_end": np.asarray(res.m_end),
            "steps_to_target": np.asarray(res.steps_to_target),
        }
    return oracle_cache[key]


def _run_serve_kill_requeue(scn: Scenario, seed: int, root: str,
                            oracle_cache: dict, device: str = "cuda"
                            ) -> dict:
    """The serve soak: multi-tenant submissions to a durable spool, a
    serving child hard-killed mid-dispatch at a seeded position, a second
    child that must recover the orphaned job from disk alone and drain the
    queue. Contracts: the oversized job is REFUSED by the byte model, the
    short-timeout job is EVICTED and still finishes, every accepted job
    ends ``done`` and bit-exact to the fault-free oracle, and the spool
    journal is schema-valid with the whole story."""
    import subprocess

    from graphdyn_torch.serve.spool import Spool
    from graphdyn_torch.utils.io import load_results_npz

    rng = np.random.default_rng(seed)
    workdir = os.path.join(root, scn.name, f"seed{seed}")
    spool_dir = os.path.join(workdir, "spool")
    problems: list[str] = []
    ep_log: list[dict] = []

    # -- tenants submit (no server alive yet: the spool IS the API) -------
    spool = Spool(spool_dir)
    accepted = []
    for tenant in ("alice", "bob"):
        for _ in range(2):
            accepted.append(spool.submit(
                {"n": 24, "d": 3, "graph_seed": int(rng.integers(0, 4)),
                 "seed": int(rng.integers(0, 2**31 - 1)),
                 "max_sweeps": 32, "chunk_sweeps": 8}, tenant))
    accepted.append(spool.submit(
        {**SERVE_EVICT_SPEC, "seed": int(rng.integers(0, 2**31 - 1))},
        "tim", timeout_s=SERVE_EVICT_TIMEOUT_S))
    # the oversized job: ~20 GB modeled resident set against the pinned
    # 1 GiB budget, refused at admission, never on the device
    oversized = spool.submit(
        {"n": 200000, "d": 3, "replicas": 4096}, "carol")

    def episode(tag: str, fault_plan: list | None) -> int:
        env = _serve_env(device, seed)
        if fault_plan:
            env["GRAPHDYN_FAULT_PLAN"] = json.dumps(fault_plan)
        proc = subprocess.run(
            [sys.executable, "-c", _serve_child_script(spool_dir, device)],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=workdir)
        ep_log.append({"episode": tag, "rc": proc.returncode,
                       "specs": fault_plan or [],
                       "stderr": proc.stderr[-2000:]})
        return proc.returncode

    # episode 1: hard kill mid-dispatch at a seeded position (the 2nd-4th
    # dispatch, always mid-queue: five jobs pass admission)
    kill_at = int(rng.integers(2, 5))
    rc = episode("kill", [{"site": "serve.dispatch", "action": "preempt",
                           "at": kill_at}])
    if rc != EX_TEMPFAIL:
        problems.append(
            f"killed episode exited {rc}, expected {EX_TEMPFAIL} "
            f"(preempt at dispatch {kill_at}): {ep_log[-1]['stderr']}")
    orphans = [r["id"] for r in spool.jobs() if r["state"] == "running"]
    if not orphans:
        problems.append(
            "hard kill left no running orphan in the spool — the kill "
            "landed outside a claimed job")
    # episode 2: a fresh server against the same spool, recovering from
    # disk alone
    rc = episode("requeue", None)
    if rc != EX_OK:
        problems.append(f"recovery episode exited {rc}, expected {EX_OK}: "
                        f"{ep_log[-1]['stderr']}")

    # -- contracts --------------------------------------------------------
    recs = {r["id"]: r for r in spool.jobs()}
    over = recs[oversized]
    if over["state"] != "refused":
        problems.append(
            f"oversized job is {over['state']!r}, want refused")
    elif "exceeds the device budget" not in (over["reason"] or ""):
        problems.append(
            f"oversized refusal reason carries no byte-model verdict: "
            f"{over['reason']!r}")
    for jid in accepted:
        if recs[jid]["state"] != "done":
            problems.append(
                f"accepted job {jid} ended {recs[jid]['state']!r} "
                f"(reason {recs[jid]['reason']!r}), want done")
    journal = os.path.join(spool_dir, _store.JOURNAL_NAME)
    ops = _check_journal(journal, scn.require_ops, problems)
    recovered = [r for r in spool.jobs()
                 if r["id"] in orphans and r["requeues"] >= 1]
    if orphans and not recovered:
        problems.append(
            "the orphaned running job was never requeued by recovery")
    # bit-exact parity for every accepted job against the fault-free
    # oracle on the same device
    for jid in accepted:
        rec = recs[jid]
        if rec["state"] != "done":
            continue
        want = _serve_oracle(rec["spec"], oracle_cache, device)
        got = load_results_npz(rec["result"])
        if set(got) != set(want):
            problems.append(
                f"{jid}: result keys {sorted(got)} vs {sorted(want)}")
            continue
        for k in want:
            if not np.array_equal(got[k], want[k]):
                problems.append(
                    f"{jid}: result array {k!r} is not bit-exact after "
                    f"kill/requeue (requeues={rec['requeues']})")
    for ep in ep_log:
        ep.pop("stderr", None)
    return {"scenario": scn.name, "seed": seed, "workload": scn.workload,
            "episodes": ep_log, "journal_ops": sorted(set(ops)),
            "problems": problems, "ok": not problems}


def run_soak(scenarios=None, seeds=BOUNDED_SEEDS, root: str | None = None,
             diag=lambda s: None, device: str | None = None) -> dict:
    """The full soak matrix on ``device`` (default the card; raises without
    one unless ``device="cpu"``). Returns ``{"runs": [...], "ok": bool,
    "scenarios": N, "seeds": M, "failed": K, "device": ...}``."""
    from graphdyn_torch.utils.platform import resolve_device

    device = resolve_device(device).type
    names = list(scenarios or SCENARIOS)
    tmp = None
    if root is None:
        tmp = tempfile.mkdtemp(prefix="graphdyn_soak_")
        root = tmp
    oracle_cache: dict = {}
    runs = []
    try:
        for name in names:
            for seed in seeds:
                diag(f"soak: {name} seed={seed}")
                rep = run_scenario(name, int(seed), root, oracle_cache,
                                   device)
                diag(f"soak: {name} seed={seed} -> "
                     f"{'ok' if rep['ok'] else 'FAIL: ' + '; '.join(rep['problems'])}")
                runs.append(rep)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    failed = sum(1 for r in runs if not r["ok"])
    return {"runs": runs, "ok": failed == 0, "scenarios": len(names),
            "seeds": len(list(seeds)), "failed": failed, "device": device}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m graphdyn_torch.resilience.soak",
        description="chaos soak: composed-fault kill/requeue cycles over "
                    "real CLI workloads, bit-exact against a fault-free "
                    "oracle (ARCHITECTURE.md 'Chaos soak')",
    )
    ap.add_argument("--bounded", action="store_true",
                    help="the tier-1 / lint.sh soakcheck configuration "
                    "(all scenarios, 3 seeds, small workloads)")
    ap.add_argument("--seeds", type=int, default=None, metavar="N",
                    help="number of seeds per scenario (default: 3 bounded, "
                    "5 otherwise)")
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated subset (default: all; see "
                    "--list)")
    ap.add_argument("--list", action="store_true",
                    help="list the scenario catalogue and exit")
    ap.add_argument("--root", default=None, metavar="DIR",
                    help="keep the soak working tree here instead of a "
                    "deleted temp dir (post-mortem debugging)")
    ap.add_argument("--format", choices=["text", "json"], default="text")
    ap.add_argument("--device", default="cuda",
                    help="device every workload runs on (passed as "
                    "--device; default cuda, 'cpu' for the plain versions)")
    args = ap.parse_args(argv)

    if args.list:
        for s in SCENARIOS.values():
            print(f"{s.name:18s} [{s.workload}"
                  f"{', mirror' if s.mirror else ''}] {s.summary}")
        return 0
    names = args.scenarios.split(",") if args.scenarios else None
    if names:
        unknown = [n for n in names if n not in SCENARIOS]
        if unknown:
            ap.error(f"unknown scenario(s): {unknown}; "
                     f"known: {sorted(SCENARIOS)}")
    n_seeds = args.seeds if args.seeds is not None else (
        len(BOUNDED_SEEDS) if args.bounded else 5)
    report = run_soak(
        scenarios=names, seeds=range(n_seeds), root=args.root,
        diag=lambda s: print(s, file=sys.stderr, flush=True),
        device=args.device,
    )
    if args.format == "json":
        print(json.dumps(report))
    else:
        for r in report["runs"]:
            status = "ok" if r["ok"] else "FAIL"
            print(f"{r['scenario']:18s} seed={r['seed']} "
                  f"episodes={len(r['episodes'])} {status}")
            if r.get("skipped"):
                print(f"    skipped: {r['skipped']}")
            for p in r["problems"]:
                print(f"    {p}")
        print(f"soak: {report['scenarios']} scenario(s) x "
              f"{report['seeds']} seed(s) on {report['device']}, "
              f"{report['failed']} failed")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
