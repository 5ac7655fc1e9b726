"""Preemption-safe shutdown: SIGTERM → checkpoint → exit 75 (the port of
``graphdyn/resilience/shutdown.py``).

A preempted machine gets a SIGTERM and a grace window. Whether the run
loses up to ``checkpoint_interval_s`` of work or nothing depends on the
solver noticing the signal and saving at the next chunk boundary; whether
the scheduler requeues the job or marks it failed depends on the exit code:
:data:`EX_TEMPFAIL` (75, ``sysexits.h``'s "temporary failure, retry
later") says preemption, not a bug.

- the CLI wraps its commands in :func:`graceful_shutdown`, which turns the
  first SIGTERM/SIGINT into a *request flag* (no exception: a handler that
  interrupts an ``np.savez`` would tear the state being saved);
- the chunked drivers poll :func:`shutdown_requested` at their boundary,
  force a checkpoint save and raise :class:`ShutdownRequested`;
- the CLI catches it and exits :data:`EX_TEMPFAIL`. A second signal in
  the grace window raises ``KeyboardInterrupt`` (exit :data:`EX_ABORT`).
"""

from __future__ import annotations

import contextlib
import logging
import signal
import threading

log = logging.getLogger("graphdyn_torch.resilience")

#: sysexits.h EX_TEMPFAIL — "preempted, requeue me" (vs 1 = real failure)
EX_TEMPFAIL = 75

#: 128 + SIGINT, the shell convention for "killed by the operator": the
#: second-signal hard abort (nothing saved — asking twice outranks the
#: checkpoint). Distinct from 75 so schedulers do NOT requeue it.
EX_ABORT = 130


class ShutdownRequested(Exception):
    """Raised by a driver at its chunk boundary after the shutdown snapshot
    is on disk. Carries ``signum`` for logging and ``where`` (the boundary
    that honored the signal — chunk/rep/λ) so the flight recorder's
    post-mortem can name the preemption site; the CLI maps it to exit
    code :data:`EX_TEMPFAIL`."""

    def __init__(self, signum: int | None = None, where: str | None = None):
        self.signum = signum
        self.where = where
        name = signal.Signals(signum).name if signum else "request"
        super().__init__(
            f"graceful shutdown on {name}: checkpointed at "
            f"{where or 'chunk'} boundary"
        )


_flag = threading.Event()
_signum: list = [None]
_requests: list = [0]
_depth = 0


def shutdown_requested() -> bool:
    """True once a signal arrived inside a :func:`graceful_shutdown` scope
    (or after :func:`request_shutdown`). Drivers poll this at chunk/rep/λ
    boundaries."""
    return _flag.is_set()


def request_shutdown(signum: int | None = None) -> None:
    """Programmatic equivalent of receiving SIGTERM (used by tests and by
    embedding schedulers that deliver preemption notice out-of-band)."""
    _signum[0] = signum
    _requests[0] += 1
    _flag.set()


def shutdown_requests() -> int:
    """How many requests stand behind the pending flag (0 when none): a
    caller that made one request itself tells from a count of 1 that no
    one else asked."""
    return _requests[0]


def clear_shutdown() -> None:
    """Clear a pending shutdown request — used by fault plans on exit (an
    injected 'signal' must not outlive its plan) and by embedding
    schedulers that cancel a preemption notice."""
    _flag.clear()
    _signum[0] = None
    _requests[0] = 0


def raise_if_requested(where: str | None = None) -> None:
    """Raise :class:`ShutdownRequested` if a shutdown is pending — for
    boundaries that have nothing to save (e.g. a driver whose in-flight
    chain already snapshotted). ``where`` names the boundary for the
    post-mortem (chunk/rep/lambda). Every call is also a liveness
    heartbeat (:func:`graphdyn_torch.resilience.supervisor.beat`): any
    ``where=``-annotated boundary a driver reaches tells the watchdog the
    run is alive."""
    from graphdyn_torch.resilience.supervisor import beat

    beat(where)
    if _flag.is_set():
        raise ShutdownRequested(_signum[0], where=where)


@contextlib.contextmanager
def graceful_shutdown(signals=(signal.SIGTERM, signal.SIGINT)):
    """Install handlers converting the first signal into the shutdown flag
    (second signal: immediate ``KeyboardInterrupt``). Re-entrant — nested
    scopes share one flag and only the outermost restores handlers — and a
    no-op off the main thread (Python only delivers signals there; worker
    threads simply inherit the flag)."""
    global _depth
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    prev = {}
    if _depth == 0:
        clear_shutdown()

        def handler(signum, frame):
            if _flag.is_set():
                log.warning("second signal %d: aborting immediately", signum)
                raise KeyboardInterrupt
            log.warning(
                "signal %d: will checkpoint at next chunk boundary and "
                "exit %d", signum, EX_TEMPFAIL,
            )
            request_shutdown(signum)

        for s in signals:
            prev[s] = signal.signal(s, handler)
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
        if _depth == 0:
            for s, h in prev.items():
                signal.signal(s, h)
            clear_shutdown()
