"""Aligned ``torch.profiler`` capture, the port's counterpart of the JAX
package's ``graphdyn/obs/trace.py``.

The JSONL event ledger (:mod:`graphdyn_torch.obs.recorder`) says where host
time went; a profiler trace says what the card was doing. This module makes
the two share one vocabulary:

- :func:`profiling` runs a ``torch.profiler.profile`` around a scope (CLI
  ``--profile DIR`` on every command, ``GRAPHDYN_PROFILE=DIR``, as
  ``--obs-ledger``/``GRAPHDYN_OBS``) and writes its chrome trace into
  ``DIR`` (``trace_<pid>_<ns>.json``: Perfetto, ``chrome://tracing``). The
  activities are the CPU and, when a card is present, CUDA (CUPTI).
- While profiling, every :class:`graphdyn_torch.obs.recorder.Span` also
  opens a ``torch.profiler.record_function`` range named with the span's
  ledger **name path** (the report's key: ``"run > pipeline.hpr.chunk"``),
  so a chunk span and the kernels launched under it carry the same name.
- The name path comes from a thread-local name stack kept here, pushed and
  popped by ``Span.start``/``Span.stop``, so it works with or without a
  recorder installed.

When profiling is off (the default), a span pays one module-global ``is
None`` check and allocates nothing. A span must not open inside a CUDA
graph capture: the drivers keep their spans around ``replay()`` and around
the call that captures, never inside the captured function.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

ENV_VAR = "GRAPHDYN_PROFILE"

#: separator joining span names into a path; the ledger report's key
#: (graphdyn_torch.obs.report.summarize) joins them the same way
PATH_SEP = " > "

_DIR: str | None = None
_local = threading.local()


def active() -> bool:
    """True while a :func:`profiling` scope is capturing."""
    return _DIR is not None


def trace_dir() -> str | None:
    """The active capture directory (None when not profiling)."""
    return _DIR


def _stack() -> list:
    st = getattr(_local, "names", None)
    if st is None:
        st = _local.names = []
    return st


def current_path(name: str) -> str:
    """The range name ``name`` would get right now on this thread: the
    enclosing span names joined the way the ledger report joins them."""
    return PATH_SEP.join([*_stack(), name])


def push(name: str):
    """Open a ``record_function`` range for a span entering ``name`` (called
    by ``Span.start`` when :func:`active`); returns the handle for
    :func:`pop`."""
    import torch

    path = current_path(name)
    _stack().append(name)
    rf = torch.profiler.record_function(path)
    rf.__enter__()
    return rf


def pop(rf) -> None:
    """Close a span's range (called by ``Span.stop``)."""
    st = _stack()
    if st:
        st.pop()
    rf.__exit__(None, None, None)


def activities() -> list:
    """The profiler's activities: the CPU, and CUDA when a card is present."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profiling(logdir: str | None = None):
    """Capture a ``torch.profiler`` trace of the scope into ``logdir``.

    ``logdir=None`` falls back to ``GRAPHDYN_PROFILE``; when that is unset
    too the scope is a no-op. Yields the active directory or None. Nested
    scopes are an error only when both name a directory (one trace per run);
    re-entering with no directory keeps the outer capture."""
    global _DIR
    if logdir is None and _DIR is None:
        logdir = os.environ.get(ENV_VAR) or None
    if logdir is None or _DIR is not None:
        if logdir is not None and _DIR is not None:
            raise RuntimeError(
                "nested obs.trace.profiling() with an explicit directory — "
                f"one trace per run (active: {_DIR!r})")
        yield _DIR
        return
    import torch

    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities())
    prof.start()
    _DIR = logdir
    try:
        yield logdir
    finally:
        _DIR = None
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def trace_files(logdir: str) -> list[str]:
    """The chrome traces :func:`profiling` wrote into ``logdir``, sorted by
    name."""
    names = sorted(f for f in os.listdir(logdir)
                   if f.startswith("trace_") and f.endswith(".json"))
    return [os.path.join(logdir, f) for f in names]
