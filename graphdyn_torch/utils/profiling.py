"""Timing and profiling shims, the port of ``graphdyn/utils/profiling.py``.

The one timing idiom of the port is :func:`graphdyn_torch.obs.timed`, an
always-measuring span whose event also lands in the ledger while recording.
``StepTimer`` and ``wall_clock`` are deprecated shims over it, and
``device_trace`` one over :func:`graphdyn_torch.obs.trace.profiling`, as in
the JAX package."""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass, field

from graphdyn_torch import obs


def _deprecated(name: str, replacement: str) -> None:
    warnings.warn(
        f"graphdyn_torch.utils.profiling.{name} is deprecated — use "
        f"{replacement} (the one timing idiom)",
        DeprecationWarning, stacklevel=3,
    )


@dataclass
class StepTimer:
    """Deprecated shim: accumulates wall time and work counts through
    :func:`graphdyn_torch.obs.timed` spans (``profiling.step_timer`` events
    while recording); reports updates/sec. A span around queued launches
    measures their issue, not the card: close the block after a host read."""

    seconds: float = 0.0
    updates: int = 0
    _warned: bool = field(default=False, repr=False)

    @contextlib.contextmanager
    def measure(self, n_updates: int):
        if not self._warned:
            _deprecated("StepTimer", "graphdyn_torch.obs.timed")
            self._warned = True
        with obs.timed("profiling.step_timer", n_updates=n_updates) as sw:
            yield
        self.seconds += sw.wall_s
        self.updates += n_updates

    @property
    def updates_per_sec(self) -> float:
        return self.updates / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def device_trace(logdir: str):
    """Deprecated shim over :func:`graphdyn_torch.obs.trace.profiling`:
    ``with device_trace('/tmp/trace'):`` captures a ``torch.profiler`` trace
    of the block into ``logdir``, with every obs span inside it opening a
    ledger-named ``record_function`` range."""
    _deprecated("device_trace", "graphdyn_torch.obs.trace.profiling")
    from graphdyn_torch.obs import trace

    with trace.profiling(logdir):
        yield


@contextlib.contextmanager
def wall_clock():
    """Deprecated shim over :func:`graphdyn_torch.obs.timed`: yields a dict
    filled with ``seconds`` on exit (``profiling.wall_clock`` span event
    while recording)."""
    _deprecated("wall_clock", "graphdyn_torch.obs.timed")
    out = {}
    sw = obs.timed("profiling.wall_clock").start()
    try:
        yield out
    finally:
        out["seconds"] = sw.stop().wall_s
