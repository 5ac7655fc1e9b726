"""Bounded host-side prefetcher (the port of
``graphdyn/pipeline/prefetch.py``, plain threading).

A single background thread builds repetition ``k+1 .. k+depth`` while the
device computes the current group. Every build is a pure function of its
repetition index (graphs and RNG streams derive from ``seed + k``), so
*when* a build happens cannot change *what* it produces: ``depth=0``
(synchronous) and any other depth give the same items. The queue holds at
most ``depth`` items.

Overlap accounting, as the JAX package keeps it: ``build_s`` is the time
spent in ``build`` and ``wait_s`` the time the consumer blocked in
:meth:`get` (at depth 0 every build is a wait), so ``1 - wait_s/build_s``
is the share of build time hidden behind the consumer's work.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Iterable

log = logging.getLogger("graphdyn_torch.pipeline")


class HostPrefetcher:
    """Build ``build(k)`` for each ``k`` in ``keys`` (in order) on a
    background thread, at most ``depth`` items ahead of the consumer.

    ``depth=0`` makes each :meth:`get` a synchronous call (no thread). An
    exception raised by ``build`` is re-raised from the matching
    :meth:`get`. Use as a context manager (or call :meth:`close`): closing
    unblocks a worker waiting on a full queue and joins it."""

    #: how long :meth:`close` waits for the worker before reporting it hung
    JOIN_TIMEOUT_S = 5.0

    def __init__(self, build: Callable[[int], object], keys: Iterable[int],
                 depth: int = 2):
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self._build = build
        self._keys = list(keys)
        self.depth = depth
        self._pos = 0
        self.build_s = 0.0
        self.wait_s = 0.0
        self._stop = threading.Event()
        self._q: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        if depth > 0 and self._keys:
            self._q = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(
                target=self._worker, name="graphdyn-torch-prefetch",
                daemon=True)
            self._thread.start()

    def _worker(self) -> None:
        for k in self._keys:
            if self._stop.is_set():
                return
            t0 = time.monotonic()
            try:
                item = (k, self._build(k), None)
            except BaseException as e:  # noqa: BLE001 — re-raised in get()
                item = (k, None, e)
            self.build_s += time.monotonic() - t0
            # bounded put that stays responsive to close()
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[2] is not None:
                return                      # a failed build ends the stream

    def get(self, k: int):
        """The built item for repetition ``k``; calls must follow the
        ``keys`` order (enforced)."""
        if self._pos >= len(self._keys) or self._keys[self._pos] != k:
            expected = (self._keys[self._pos] if self._pos < len(self._keys)
                        else "<end>")
            raise ValueError(f"prefetcher consumed out of order: expected "
                             f"{expected}, got {k}")
        self._pos += 1
        if self._q is None:
            t0 = time.monotonic()
            out = self._build(k)
            self.build_s += time.monotonic() - t0
            self.wait_s = self.build_s      # synchronous: no overlap
            return out
        t0 = time.monotonic()
        got_k, value, exc = self._q.get()
        self.wait_s += time.monotonic() - t0
        if got_k != k:
            raise RuntimeError(f"prefetch stream desync: {got_k} != {k}")
        if exc is not None:
            raise RuntimeError(f"prefetch build for repetition {k} failed") \
                from exc
        return value

    def close(self, timeout_s: float | None = None) -> None:
        """Stop the worker, drain the queue and join the thread
        (idempotent); a worker still alive after ``timeout_s`` is logged
        as hung, counted (``pipeline.prefetch.hung``) and abandoned (it is
        a daemon). The first close of a prefetcher that built something
        emits the ``pipeline.prefetch.overlap_util`` gauge while recording:
        the share of build time hidden behind the consumer (1 − wait/build).
        """
        from graphdyn_torch import obs

        if obs.enabled() and self.build_s > 0 and not self._stop.is_set():
            obs.gauge("pipeline.prefetch.overlap_util",
                      max(0.0, 1.0 - self.wait_s / self.build_s),
                      build_s=round(self.build_s, 6),
                      wait_s=round(self.wait_s, 6), depth=self.depth,
                      items=self._pos)
        self._stop.set()
        if self._q is not None:
            while True:                     # drain so a blocked put exits
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
        if self._thread is not None:
            timeout_s = self.JOIN_TIMEOUT_S if timeout_s is None else timeout_s
            self._thread.join(timeout=timeout_s)
            if self._thread.is_alive():
                log.warning("prefetch worker %s is still alive %.3gs after "
                            "close(); abandoning the daemon thread",
                            self._thread.name, timeout_s)
                obs.counter("pipeline.prefetch.hung", depth=self.depth,
                            items=self._pos, timeout_s=timeout_s)
            self._thread = None

    def __enter__(self) -> "HostPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
