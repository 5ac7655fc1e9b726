"""Bounded exponential-backoff retry and the checkpoint-save policy (the port
of ``graphdyn/resilience/retry.py``).

A checkpoint save that meets a transient ENOSPC or EIO must not kill an
hours-long chain: the chain is the value, the snapshot is insurance.
:func:`retry` gives a small bounded budget; the callers then decide to give
up loudly or to degrade and keep computing. The checkpoint-save budget is
process-wide (:data:`SAVE_RETRY`, CLI ``--max-save-retries``). With
``jitter=True`` the delays are seeded from the retry site's key, so they
equal the JAX package's for the same key.
"""

from __future__ import annotations

import hashlib
import logging
import time
from dataclasses import dataclass

log = logging.getLogger("graphdyn_torch.resilience")


@dataclass
class RetryPolicy:
    """``tries`` total attempts (1 = no retry), exponential backoff
    ``base_delay_s * 2**k`` capped at ``max_delay_s``.

    ``jitter=True`` switches to **seeded full-jitter**: each delay is drawn
    uniformly from ``(0, bound]`` where ``bound`` is the exponential value
    above, seeded from the retry-site ``key`` passed to :meth:`delays`.
    Multihost ranks retrying the same operation (``multihost.init``, a
    shared-filesystem save) carry distinct keys (rank/pid in the site
    string), so their retries DE-correlate instead of synchronizing into
    storms — while any one site's schedule stays deterministic for tests.
    """

    tries: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: bool = False

    def delays(self, key: str = ""):
        rng = None
        if self.jitter:
            import numpy as _np

            seed = int.from_bytes(
                hashlib.sha256(key.encode()).digest()[:8], "big"
            )
            rng = _np.random.default_rng(seed)
        d = self.base_delay_s
        for _ in range(max(0, self.tries - 1)):
            bound = min(d, self.max_delay_s)
            if rng is None:
                yield bound
            else:
                # full-jitter over (0, bound]: never exceeds the exponential
                # bound, never a 0 that would hammer the resource
                yield float(bound * (1.0 - rng.random()))
            d *= 2.0


# the process-wide checkpoint-save budget (CLI: --max-save-retries). Jittered:
# many hosts retrying a shared-filesystem save must not fire in lockstep. A
# mutable singleton, updated in place — importers hold the object, not a
# snapshot of it.
SAVE_RETRY = RetryPolicy(jitter=True)


def set_save_retry(tries: int) -> None:
    """Set the checkpoint-save retry budget (``tries`` retries after the
    first attempt): the ``--max-save-retries`` knob."""
    SAVE_RETRY.tries = max(1, int(tries) + 1)


def retry(
    fn,
    *,
    policy: RetryPolicy | None = None,
    retry_on: tuple = (OSError,),
    retry_if=None,
    what: str = "operation",
    deadline_s: float | None = None,
    sleep=time.sleep,
):
    """Call ``fn()`` with bounded exponential backoff.

    Retries on ``retry_on`` exceptions only — further narrowed by
    ``retry_if(exc) -> bool`` when given (a deterministic failure dressed
    in a retryable class must surface immediately, not after the whole
    backoff budget); the last failure re-raises. ``deadline_s`` caps the
    total time spent waiting (attempts stop early when the next sleep
    would cross it) — the ``init_multihost`` "retry with deadline"
    contract. Each retry logs a warning with the failure, so a run that
    survived transient trouble says so in its log."""
    from graphdyn_torch.resilience import hooks as obs

    policy = policy or RetryPolicy()
    t0 = time.monotonic()
    # `what` doubles as the jitter seed key: distinct sites (and distinct
    # ranks, when the caller puts the rank in the site string) draw
    # de-correlated schedules
    delays = list(policy.delays(key=what)) + [None]  # None = no sleep after last
    backoff_total = 0.0
    for attempt, delay in enumerate(delays, start=1):
        try:
            return fn()
        except retry_on as e:
            if retry_if is not None and not retry_if(e):
                raise
            out_of_time = deadline_s is not None and delay is not None and (
                time.monotonic() - t0 + delay > deadline_s
            )
            if delay is None or out_of_time:
                raise
            backoff_total += delay
            # a degraded run must be diagnosable post-hoc: the SITE (what),
            # the attempt number, and the cumulative backoff ride in the
            # log record's fields AND in the obs counter, not only in the
            # formatted message
            log.warning(
                "%s failed (attempt %d/%d, cumulative backoff %.2gs): %s "
                "— retrying in %.2gs",
                what, attempt, len(delays), backoff_total, e, delay,
                extra={"retry_site": what, "retry_attempt": attempt,
                       "retry_backoff_s": delay,
                       "retry_cumulative_backoff_s": backoff_total},
            )
            obs.counter(
                "resilience.retry", site=what, attempt=attempt,
                backoff_s=delay, cumulative_backoff_s=round(backoff_total, 6),
                error=f"{type(e).__name__}: {e}"[:200],
            )
            sleep(delay)
    raise AssertionError("unreachable")         # pragma: no cover
