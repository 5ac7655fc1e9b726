"""graphdyn_torch.obs — the port's runtime telemetry, the counterpart of the
JAX package's ``graphdyn/obs``: the same surface, the same JSONL ledger
schema and the same event names, so either package's reader and report take
the other's ledgers and post-mortems.

Surface (module-level, delegating to the installed recorder):

- :func:`span` — a recording span (nested, monotonic clock, wall and
  process-CPU time). On the default :data:`NULL` recorder it returns one
  shared no-op object: one attribute check, no allocation.
- :func:`timed` — an always-measuring span: callers that need the duration
  for their own results get it whether or not a ledger is written.
- :func:`counter` / :func:`gauge` — occurrence counts and point-in-time
  values.
- :func:`manifest` — the per-run identity event (backend, torch and CUDA
  versions, the card and its power limit, git sha, config).
- :func:`recording` — install a :class:`Recorder` writing the ledger for a
  scope (CLI ``--obs-ledger PATH`` / ``GRAPHDYN_OBS=PATH``).

A span's wall time includes the card's time only where the span closes
after a host read: the chunk spans of the drivers close after the one read
per chunk their loops already make, and no site adds a synchronize.

Device-side eyes, on the same surface:

- :mod:`graphdyn_torch.obs.trace` — ``torch.profiler`` capture (``--profile
  DIR`` / ``GRAPHDYN_PROFILE``), every span opening a ``record_function``
  range named with its ledger name path.
- :mod:`graphdyn_torch.obs.memband` — the caching allocator's
  ``obs.mem.bytes_in_use``/``obs.mem.peak`` gauges at the chunk boundaries,
  and the memcheck rows against the byte models.
- :mod:`graphdyn_torch.obs.flight` — the bounded flight-recorder ring
  behind the null recorder, dumped as ``obs_postmortem.jsonl`` on an
  unhandled exception, a ``sweep.nan`` degrade, a preemption (exit 75) or a
  stall abort.
- :mod:`graphdyn_torch.obs.roofline` — the H100's rates and the bound models
  of the kernels, and the obscheck rows.

The JAX package's ``jax.compile`` counter (XLA cache misses) has the
``kernel.build`` counter as its counterpart: one per CUDA library that
``ops/cuda_build.py`` compiles rather than finds built. Render a ledger with
``python -m graphdyn_torch.obs report LEDGER``.
"""

from __future__ import annotations

import contextlib
import os
import subprocess

from graphdyn_torch.obs.recorder import (  # noqa: F401  (re-exports)
    NULL,
    NULL_SPAN,
    SCHEMA,
    NullRecorder,
    Recorder,
    Span,
    read_ledger,
)
from graphdyn_torch.obs import flight, memband, trace  # noqa: F401

ENV_VAR = "GRAPHDYN_OBS"

_REC = NULL


def current():
    """The installed recorder (:data:`NULL` unless inside
    :func:`recording`)."""
    return _REC


def enabled() -> bool:
    """True when a real recorder is installed. Sites gate work that needs a
    device value (a host read, a reduction) on this, never the span call."""
    return _REC.enabled


def span(name: str, **attrs):
    """A recording span for the current recorder (no-op, no allocation on
    :data:`NULL`)."""
    return _REC.span(name, **attrs)


def timed(name: str, **attrs) -> Span:
    """An always-measuring span: ``with obs.timed("x") as sp: ...`` then read
    ``sp.wall_s``, or ``sw = obs.timed("x").start(); ...; sw.stop()``. Emits
    a span event only when a recorder is installed."""
    return Span(_REC if _REC.enabled else None, name, attrs)


def counter(name: str, inc: int = 1, **attrs) -> None:
    _REC.counter(name, inc, **attrs)


def gauge(name: str, value, **attrs) -> None:
    _REC.gauge(name, value, **attrs)


def manifest(**fields):
    """Emit the per-run manifest event; returns the ``run`` dict (None on the
    null recorder)."""
    return _REC.manifest(**fields)


def git_sha() -> str | None:
    """Best-effort repo sha for the manifest (None outside a checkout)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
        )
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` gives it (``"700.00 W"``);
    None where there is no card or no ``nvidia-smi``."""
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def run_manifest_fields(**extra) -> dict:
    """The standard manifest payload: the environment's identity (the
    backend, torch and CUDA versions, the card's name and power limit; the
    last two null off the card)."""
    import platform

    import torch

    cuda = torch.cuda.is_available()
    return {
        "backend": "cuda" if cuda else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "power_limit": power_limit(),
        "python": platform.python_version(),
        "git_sha": git_sha(),
        **extra,
    }


@contextlib.contextmanager
def recording(path: str | None = None):
    """Install a :class:`Recorder` writing to ``path`` for the scope.

    ``path=None`` falls back to ``GRAPHDYN_OBS``; when that is unset too,
    the scope runs on the null recorder. Yields the active recorder either
    way. Nested scopes are an error only when both would install a
    recorder; re-entering with no path keeps the outer one."""
    global _REC
    path = path or os.environ.get(ENV_VAR) or None
    if path is None or _REC.enabled:
        if path is not None and _REC.enabled:
            raise RuntimeError(
                "nested obs.recording() with an explicit path — one ledger "
                f"per run (active: {getattr(_REC, 'path', '?')!r})")
        yield _REC
        return
    rec = Recorder(path)
    _REC = rec
    try:
        yield rec
    finally:
        _REC = NULL
        rec.close()
