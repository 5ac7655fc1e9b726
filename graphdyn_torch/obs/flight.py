"""The always-on flight recorder, as the JAX package's
(``graphdyn/obs/flight.py``).

The event ledger is opt-in, so a crash without ``--obs-ledger`` would leave
no runtime evidence. This module keeps the last :data:`DEFAULT_CAPACITY`
counter/gauge events in a bounded in-memory ring **behind the null
recorder** — default
on, no I/O, allocation-bounded by construction (a ``deque(maxlen=N)`` of
small event dicts; regression-tested with tracemalloc) — and dumps them as
a schema-valid post-mortem ledger when a run dies:

- **unhandled driver exception** (the CLI re-raises after dumping),
- **``sweep.nan`` degrade** (the solver continues with the non-convergence
  sentinel, but the poisoned-state evidence is preserved at the moment it
  happened),
- **SIGTERM → exit 75 preemption** (the graceful-shutdown path —
  :class:`ShutdownRequested.where` names the boundary that honored the
  signal),
- **a stall abort** (the supervisor's watchdog, before it kills the run).

The dump target is ``<workdir>/obs_postmortem.jsonl`` — the same JSONL
schema as a real ledger (either package's ``read_ledger`` and ``python -m
graphdyn_torch.obs report`` work on it unchanged): a ``manifest`` stamped
``postmortem: true``, the ring's tail events, then one final ``obs.crash``
counter event naming the failure site. When a real recorder IS installed the ledger is already the
evidence: :func:`dump` emits the ``obs.crash`` event into it and writes no
file. A clean run triggers no dump and leaves no file.

``GRAPHDYN_FLIGHT=0`` disarms the ring (the only configuration knob — the
whole point is that nobody has to ask for it).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

_MONO = time.monotonic

DEFAULT_CAPACITY = 512
ENV_VAR = "GRAPHDYN_FLIGHT"
POSTMORTEM_NAME = "obs_postmortem.jsonl"

_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=DEFAULT_CAPACITY)
_t0 = _MONO()


def armed() -> bool:
    """True unless ``GRAPHDYN_FLIGHT=0`` — the null recorder forwards its
    counter/gauge events into the ring only then."""
    return os.environ.get(ENV_VAR) != "0"


def capacity() -> int:
    return _ring.maxlen or 0


def configure(capacity: int) -> None:
    """Resize the ring (tests; keeps the newest events)."""
    global _ring
    with _lock:
        _ring = collections.deque(_ring, maxlen=int(capacity))


def clear() -> None:
    with _lock:
        _ring.clear()


def snapshot() -> list[dict]:
    """The ring's current contents, oldest first."""
    with _lock:
        return list(_ring)


def record_counter(name: str, inc: int, attrs: dict) -> None:
    """Ring-append one counter event (called by the null recorder)."""
    doc = {"ev": "counter", "t": round(_MONO() - _t0, 6), "name": name,
           "inc": inc}
    if attrs:
        doc["attrs"] = attrs
    with _lock:
        _ring.append(doc)


def record_gauge(name: str, value, attrs: dict) -> None:
    """Ring-append one gauge event (called by the null recorder)."""
    doc = {"ev": "gauge", "t": round(_MONO() - _t0, 6), "name": name,
           "value": value}
    if attrs:
        doc["attrs"] = attrs
    with _lock:
        _ring.append(doc)


def _crash_attrs(reason: str, exc, site) -> dict:
    attrs = {"reason": reason}
    # the last liveness heartbeat (count / boundary / age): the ring holds
    # only the newest 512 events, so a long tail of non-heartbeat noise
    # could rotate the obs.heartbeat gauges out — the crash event itself
    # names the last boundary the run crossed, unconditionally
    try:
        from graphdyn_torch.resilience.supervisor import last_beat

        n, t, where = last_beat()
        if n > 0:
            attrs["heartbeat_n"] = n
            attrs["heartbeat_age_s"] = round(_MONO() - t, 3)
            if where is not None:
                attrs["heartbeat_where"] = where
    except Exception:  # noqa: BLE001 — crash-path telemetry never raises
        pass
    # with the racecheck runtime installed (GRAPHDYN_RACECHECK=1), stamp what
    # every thread currently HOLDS: the per-acquire ring events can rotate
    # out under a long tail, but the crash event itself names the lock a
    # wedged run died holding
    try:
        from graphdyn_torch.analysis import racecheck as _rc

        if _rc.installed():
            held = _rc.held_locks()
            if held:
                attrs["locks_held"] = {
                    t: "|".join(st) for t, st in sorted(held.items())
                }
    except Exception:  # noqa: BLE001 — crash-path telemetry never raises
        pass
    if exc is not None:
        attrs["exc_type"] = type(exc).__name__
        attrs["message"] = str(exc)[:500]
        if site is None:
            # the failure site: the innermost frame of the traceback
            tb = getattr(exc, "__traceback__", None)
            if tb is not None:
                import traceback

                frames = traceback.extract_tb(tb)
                if frames:
                    f = frames[-1]
                    site = f"{f.filename}:{f.lineno} in {f.name}"
    if site is not None:
        attrs["site"] = site
    return attrs


def dump(reason: str, *, exc=None, site=None, workdir=None) -> str | None:
    """Persist the flight evidence for a failing run.

    With a real recorder installed, the ``obs.crash`` counter event goes
    into the live ledger (the ledger IS the evidence) and no file is
    written. Otherwise the ring + crash event are written atomically to
    ``<workdir>/obs_postmortem.jsonl`` and the path is returned. Never
    raises — a broken dump must not mask the failure it is documenting —
    and returns None when nothing was written.
    """
    if not armed():
        return None
    try:
        from graphdyn_torch import obs

        attrs = _crash_attrs(reason, exc, site)
        rec = obs.current()
        if rec.enabled:
            rec.counter("obs.crash", **attrs)
            return None
        t = round(_MONO() - _t0, 6)
        run = {"schema": obs.SCHEMA, "pid": os.getpid(),
               "time_unix": time.time(), "postmortem": True,
               "reason": reason}
        try:
            run.update(obs.run_manifest_fields())
        except Exception:  # noqa: BLE001 — identity is best-effort
            pass
        events = [{"ev": "manifest", "t": t, "run": run}]
        events.extend(snapshot())
        events.append({"ev": "counter", "t": t, "name": "obs.crash",
                       "inc": 1, "attrs": attrs})
        path = os.path.join(workdir or os.getcwd(), POSTMORTEM_NAME)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("".join(
                json.dumps(e, separators=(",", ":"), default=str) + "\n"
                for e in events))
        os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001 — crash-path telemetry never raises
        return None
