"""Deterministic fault injection: the trigger of every recovery path (the
port of ``graphdyn/resilience/faults.py``, same names, same plan format).

A :class:`FaultPlan` is a context manager holding :class:`FaultSpec`
entries, each naming an **injection site** (a stable string such as
``"checkpoint.write"``), an action and a deterministic firing schedule (the
``at``-th hit of the site, ``count`` consecutive hits, optionally a seeded
probability). The instrumented code calls :func:`maybe_fail` or
:func:`check_fault` at its sites; with no active plan both are one global
check.

Sites of the port:

===================  =====================================================
site                 instrumented in
===================  =====================================================
``checkpoint.write`` ``utils.io.Checkpoint.save`` — ``raise`` (ENOSPC) or
                     ``torn`` (a partial temp file left behind, then raise)
``checkpoint.read``  ``utils.io.Checkpoint.load`` — ``truncate`` corrupts
                     the npz on disk before the loader reads it
``checkpoint.bitrot`` ``resilience.store.DurableCheckpoint.load`` —
                     ``bitrot`` flips bytes inside a checkpoint while the
                     zip container stays valid: only the SHA-256 manifest
                     catches it
``mirror.write``     ``resilience.store.DurableCheckpoint._mirror_save`` —
                     ``raise``: the mirror's ENOSPC; the primary save
                     stands, the journal records the degraded mirror
``mirror.copy``      the write-behind worker's copy (env plans only);
                     ``stall`` delays it
``chunk.boundary``   ``utils.io.ChainCheckpointer.drive`` — ``preempt``
                     raises at the ``at``-th chunk boundary
``rep.boundary``     the SA and HPr ensemble drivers — ``preempt`` raises
                     after the ``at``-th repetition
``lambda.boundary``  the entropy λ-ladders — ``preempt`` raises after the
                     ``at``-th visited λ
``pallas.lower``     the BDCM sweep build (``ops.bdcm``), the HPr and
                     entropy group executors — ``raise``: a kernel build
                     failure. The port does not fall back to the plain
                     version: the run raises
``sweep.nan``        the BDCM sweep and the entropy fixed points — ``nan``
                     poisons the returned messages
``multihost.init``   ``parallel.mesh.init_distributed`` — ``raise``: the
                     rendezvous is not up yet
                     (:class:`InjectedUnavailable`), retried until the
                     deadline
===================  =====================================================

CLI-level tests inject through the ``GRAPHDYN_FAULT_PLAN`` environment
variable (a JSON list of spec dicts, or ``{"specs": [...], "seed": s}``);
it is consulted only when no in-process plan is active.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger("graphdyn_torch.resilience")

ENV_VAR = "GRAPHDYN_FAULT_PLAN"


class InjectedFault(Exception):
    """Base class of every injected failure (so tests and recovery code can
    tell injected faults from organic ones)."""


class InjectedWriteError(InjectedFault, OSError):
    """Simulated persistent-storage write failure (defaults to ENOSPC)."""

    def __init__(self, path: str = ""):
        OSError.__init__(self, errno.ENOSPC, "injected: no space left on device", path)


class InjectedPreemption(InjectedFault):
    """Simulated hard preemption: the process dies *here*, no cleanup."""


class InjectedLoweringError(InjectedFault):
    """Simulated kernel build/launch failure (the ``pallas.lower`` site)."""


class InjectedUnavailable(InjectedFault, RuntimeError):
    """Simulated transient service unavailability (e.g. the process-group
    rendezvous not up yet: the ``multihost.init`` site)."""


@dataclass
class FaultSpec:
    """One fault: fire ``count`` times starting at the ``at``-th hit of
    ``site`` (1-based, counted per plan activation). ``p`` < 1 makes each
    eligible hit fire with that probability from the plan's seeded stream —
    deterministic given the plan seed. ``match`` restricts firing to hits
    whose ``key`` context value contains it (e.g. a checkpoint path).

    Actions: ``raise`` (site-specific exception), ``preempt`` (hard kill —
    :class:`InjectedPreemption`), ``torn``/``truncate``/``nan``/``bitrot``
    (data transformations applied by the site), ``signal`` (deliver a
    graceful-shutdown request exactly as a SIGTERM handler would — the
    deterministic, race-free way to test the preemption protocol), and
    ``stall`` (sleep ``secs`` at the site then continue — a deterministic
    injectable hang, the watchdog's test primitive: the site stops
    heartbeating for exactly ``secs``)."""

    site: str
    action: str = "raise"   # raise | preempt | torn | truncate | nan | bitrot | signal | stall
    at: int = 1
    count: int = 1
    p: float = 1.0
    match: str | None = None
    secs: float = 0.05      # stall only: how long the site sleeps
    hits: int = field(default=0, init=False)    # per-plan-activation counter
    fired: int = field(default=0, init=False)


class FaultPlan:
    """A deterministic, seedable schedule of injected faults.

    Use as a context manager::

        with FaultPlan([FaultSpec("chunk.boundary", "preempt", at=2)]):
            solver(...)        # raises InjectedPreemption at chunk 2

    Plans nest (a stack); the innermost active plan is consulted. Entering
    the same plan twice resets its hit counters, so one plan object can
    drive several independent runs in a test.
    """

    def __init__(self, specs, *, seed: int = 0):
        self.specs = [
            FaultSpec(**s) if isinstance(s, dict) else s for s in specs
        ]
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_env(cls, env: str | None = None) -> "FaultPlan | None":
        """Plan from the ``GRAPHDYN_FAULT_PLAN`` JSON (or ``env`` override);
        None when unset/empty. Malformed JSON raises — a CLI test with a
        typo'd plan must fail loudly, not run fault-free and pass."""
        blob = os.environ.get(ENV_VAR, "") if env is None else env
        if not blob.strip():
            return None
        doc = json.loads(blob)
        specs = doc.get("specs", doc) if isinstance(doc, dict) else doc
        seed = doc.get("seed", 0) if isinstance(doc, dict) else 0
        return cls([FaultSpec(**s) for s in specs], seed=seed)

    def __enter__(self) -> "FaultPlan":
        for s in self.specs:
            s.hits = s.fired = 0
        self._rng = np.random.default_rng(self.seed)
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack().remove(self)
        if any(s.action == "signal" and s.fired for s in self.specs):
            # a fired 'signal' spec set the process-global shutdown flag;
            # clear it on plan exit so the injected request cannot outlive
            # the plan and poison every later solver call in this process
            # (inside a graceful_shutdown scope the request has already
            # been consumed as ShutdownRequested by the time we get here)
            from graphdyn_torch.resilience.shutdown import clear_shutdown

            clear_shutdown()

    def poll(self, site: str, key: str = "") -> FaultSpec | None:
        """The spec that fires on this hit of ``site``, or None. Counts the
        hit on every matching spec regardless of firing."""
        for s in self.specs:
            if s.site != site:
                continue
            if s.match is not None and s.match not in key:
                continue
            s.hits += 1
            in_window = s.at <= s.hits < s.at + s.count
            if in_window and s.fired < s.count:
                if s.p >= 1.0 or self._rng.random() < s.p:
                    s.fired += 1
                    return s
        return None


_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "plans"):
        _local.plans = []
    return _local.plans


_env_plan_cache: list = []      # [] = unparsed, [None] or [FaultPlan] = parsed
_env_plan_lock = threading.Lock()


def _env_plan() -> FaultPlan | None:
    if not _env_plan_cache:
        # env plans live for the process (never on the with-stack); their
        # hit counters run from the first consulted site onward. Parsed
        # under a lock: sites are polled from worker threads too (the
        # write-behind mirror's `mirror.copy`), and two first-pollers
        # racing the parse would each append a plan with its own hit
        # counters — split counters make `at=` schedules nondeterministic
        with _env_plan_lock:
            if not _env_plan_cache:
                _env_plan_cache.append(FaultPlan.from_env())
    return _env_plan_cache[0]


def current_plan() -> FaultPlan | None:
    """Innermost active plan: an explicit ``with FaultPlan(...)`` wins over
    the process-level ``GRAPHDYN_FAULT_PLAN`` env plan."""
    stack = _stack()
    if stack:
        return stack[-1]
    return _env_plan()


def check_fault(site: str, key: str = "") -> FaultSpec | None:
    """Poll ``site``: the firing :class:`FaultSpec` (for sites that apply a
    data transformation themselves — ``truncate``, ``torn``, ``nan``), or
    None. Near-free with no active plan."""
    plan = current_plan()
    if plan is None:
        return None
    spec = plan.poll(site, key)
    if spec is not None:
        log.warning("fault injected at %s: %s (hit %d)", site, spec.action,
                    spec.hits)
        # fault-site hits land in the event ledger too — a degraded run's
        # post-mortem should not require re-running with the plan
        from graphdyn_torch.resilience import hooks as obs

        obs.counter("resilience.fault", site=site, action=spec.action,
                    hit=spec.hits, key=key)
        if spec.action == "signal":
            import signal as _signal

            from graphdyn_torch.resilience.shutdown import request_shutdown

            request_shutdown(_signal.SIGTERM)
        elif spec.action == "stall":
            # an injectable hang: the site simply stops making progress (and
            # stops heartbeating) for spec.secs — what a wedged device call
            # or a dead NFS mount looks like from the watchdog's seat. The
            # sleep is the whole fault; execution then continues normally,
            # so an UNsupervised run is perturbed only in wall-clock time.
            time.sleep(spec.secs)
    return spec


def maybe_fail(site: str, key: str = "") -> None:
    """Poll ``site`` and raise the configured exception when a spec fires:
    ``preempt`` → :class:`InjectedPreemption` (a hard kill is a hard kill at
    EVERY site — never downgraded to a site-specific retryable error),
    ``raise`` → the site's specialized exception. Transform-type actions at
    a raise-only site also raise (a misconfigured plan must not silently
    no-op); ``signal``'s and ``stall``'s side effects already happened in
    :func:`check_fault`."""
    spec = check_fault(site, key)
    if spec is None or spec.action in ("signal", "stall"):
        return
    if spec.action == "preempt":
        raise InjectedPreemption(
            f"injected preempt at {site} (hit {spec.hits})"
        )
    if spec.action == "raise":
        if site == "checkpoint.write":
            raise InjectedWriteError(key)
        if site == "pallas.lower":
            raise InjectedLoweringError(
                f"injected lowering failure at {key or site}"
            )
        if site == "multihost.init":
            raise InjectedUnavailable("injected: coordinator unavailable")
    raise InjectedFault(f"injected {spec.action} at {site} (hit {spec.hits})")


def transform_spec(site: str, expected: str, key: str = "") -> FaultSpec | None:
    """:func:`check_fault` for sites whose firing spec applies a data
    transformation (``truncate``, ``torn``, ``nan``): returns the spec only
    when its action is ``expected``. ``preempt`` raises
    :class:`InjectedPreemption`, any other mismatched action raises
    :class:`InjectedFault` — a plan that names a site must never silently
    no-op; ``signal``/``stall`` return None (their side effects already
    happened)."""
    spec = check_fault(site, key)
    if spec is None or spec.action in ("signal", "stall"):
        return None
    if spec.action == expected:
        return spec
    if spec.action == "preempt":
        raise InjectedPreemption(f"injected preempt at {site} (hit {spec.hits})")
    raise InjectedFault(
        f"injected {spec.action} at {site} (hit {spec.hits}) — this site "
        f"only applies {expected!r}"
    )


def truncate_file(path: str, frac: float = 0.5) -> None:
    """Corrupt an on-disk file by truncating it to ``frac`` of its size —
    the ``checkpoint.read`` fault's payload (a torn download / partial
    flush). A 0-byte result is valid too (frac=0)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(0, int(size * frac)))


def flip_npz_bytes(path: str, seed: int = 0) -> None:
    """SILENT bit rot: flip bytes inside the largest array member of an npz
    while keeping the zip container valid — the ``checkpoint.bitrot``
    fault's payload.

    The members are rewritten through ``zipfile.writestr``, which recomputes
    each member's CRC-32, so ``np.load`` succeeds and returns wrong data —
    the corruption class only a content checksum (the durable store's
    SHA-256 manifest) can catch. Flips land past the 128-byte npy header so
    the array parses; XOR 0xFF guarantees every flipped byte changes."""
    import zipfile as _zipfile

    rng = np.random.default_rng(seed)
    with _zipfile.ZipFile(path) as z:
        names = z.namelist()
        blobs = {nm: z.read(nm) for nm in names}
    arrays = [nm for nm in names if not nm.startswith("__")] or names
    target = max(arrays, key=lambda nm: len(blobs[nm]))
    b = bytearray(blobs[target])
    lo = min(128, max(0, len(b) - 1))
    for i in rng.integers(lo, len(b), size=min(8, max(1, len(b) - lo))):
        b[i] ^= 0xFF
    blobs[target] = bytes(b)
    tmp = path + ".tmp-bitrot"
    with _zipfile.ZipFile(tmp, "w", _zipfile.ZIP_STORED) as z:
        for nm in names:
            z.writestr(nm, blobs[nm])
    os.replace(tmp, path)

