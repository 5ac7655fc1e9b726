"""Runtime host-aliasing sanitizer (the port of
``graphdyn/analysis/sanitize.py``: ``alias_sanitizer``,
``maybe_alias_sanitizer``, ``AliasRaceError`` and the
``GRAPHDYN_SANITIZE=alias`` hook, which ``graphdyn_torch.cli.main`` wraps
around every command).

The port crosses the host/device line in two ways, each with its own
hazard window:

- **A CPU alias.** ``torch.from_numpy(a)`` always, and ``torch.as_tensor(a)``
  of a numpy array when the result stays on the CPU with ``a``'s dtype,
  return a tensor that IS ``a``'s memory for the tensor's whole life: a
  write to ``a`` while the tensor lives changes what the tensor holds (on
  the CPU path, what every later op reads). The window is the tensor's
  lifetime, as in the JAX package: the digest taken at the crossing is
  verified when the tensor is collected, at :meth:`AliasSanitizer.verify`
  and when the context exits.
- **A pinned asynchronous copy.** ``Tensor.to(..., non_blocking=True)``,
  ``Tensor.cuda(..., non_blocking=True)`` and
  ``dst.copy_(src, non_blocking=True)`` from a CPU source to the card
  return before the copy has read the source: a host write to it before
  the copy runs is copied (or half copied). The window ends when the copy's
  stream passes a CUDA event that the sanitizer records right after the
  copy. The digest taken at dispatch is verified as soon as the host is
  seen to wait for the card (``Event.synchronize``/``Event.query``,
  ``Stream.synchronize``, ``torch.cuda.synchronize``, the next crossing)
  and the event has completed, and every record still pending is verified
  at exit. A write made after the host waited for the event is outside the
  window; one made before is an :class:`AliasRaceError` naming the
  crossing.

Only ``non_blocking`` passed by keyword is seen (the port's only
spelling). Implicit waits (``.item()``, ``.cpu()``) are not hooked: a
record whose event completed behind one is verified at the next hooked
point, so a host that rewrites a source after such a wait without any
hooked point in between would read as a race — the port's staging code
makes a fresh slab per chunk and never rewrites a staged tensor.

Opt-in: with ``GRAPHDYN_SANITIZE=alias`` in the environment,
:func:`maybe_alias_sanitizer` is the real context; otherwise it is a no-op
that costs one environment lookup and patches nothing. Tests use
:func:`alias_sanitizer` directly.
"""

from __future__ import annotations

import os
import sys
import threading
import weakref
import zlib
from contextlib import contextmanager

ENV_VAR = "GRAPHDYN_SANITIZE"
ENV_VALUE = "alias"


class AliasRaceError(RuntimeError):
    """A host buffer was written inside the hazard window of a crossing
    that reads it (a live CPU alias, or a pending asynchronous copy)."""


def _digest(buf) -> tuple[int, int]:
    """CRC-32 and size of a numpy array's or a CPU tensor's bytes, read in
    place (the digest is the snapshot: taken now, it is immune to a later
    write). A change detector, not a cryptographic hash: CRC-32 runs ~6×
    faster than blake2b here, and the stream digests every staged slab."""
    import numpy as np
    import torch

    if isinstance(buf, np.ndarray):
        raw = np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
    else:
        raw = buf.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return zlib.crc32(memoryview(raw)), raw.size


def _call_site() -> str:
    """file:line of the crossing, skipping this module and torch frames
    (a frame walk: no source lines are read, the stream crosses thousands
    of times a run)."""
    frame = sys._getframe(1)
    while frame is not None:
        fn = frame.f_code.co_filename.replace("\\", "/")
        if "/analysis/sanitize.py" not in fn and "/torch/" not in fn:
            return f"{frame.f_code.co_filename}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


class _Record:
    __slots__ = ("source", "digest", "site", "dead", "finalizer", "event",
                 "done")

    def __init__(self, source, digest, site, event=None, done=None):
        self.source = source
        self.digest = digest
        self.site = site
        self.event = event
        self.done = done
        self.dead = False
        self.finalizer = None


class AliasSanitizer:
    """The active sanitizer: crossing records plus verification. Not
    re-entrant (one active context at a time — :func:`alias_sanitizer`
    enforces it)."""

    def __init__(self):
        self.records: list[_Record] = []
        self.pending: list[_Record] = []
        self.violations: list[str] = []
        self.crossings = 0
        self._saved = None
        # the prefetch thread issues copies while the main thread polls
        self._lock = threading.Lock()

    # -- record / verify -------------------------------------------------

    def _track_alias(self, source, out) -> None:
        """Record ``out`` (a tensor) if it shares ``source``'s (a numpy
        array's) memory on the CPU."""
        import numpy as np
        import torch

        if not isinstance(source, np.ndarray) or not isinstance(
                out, torch.Tensor):
            return
        if not source.flags.writeable or source.size == 0 \
                or source.dtype == object:
            return                      # read-only / empty: cannot race
        if out.device.type != "cpu" or out.data_ptr() != \
                source.__array_interface__["data"][0]:
            return                      # a copy: cannot race
        self.crossings += 1
        rec = _Record(source, _digest(source), _call_site())
        # the alias window closes at the tensor's death: a buffer that
        # already changed inside it is a race whatever happens later
        rec.finalizer = weakref.finalize(out, self._on_dead, rec)
        self.records.append(rec)

    def _track_async(self, source, dst_device) -> None:
        """Record a ``non_blocking`` copy of the CPU tensor ``source`` to
        ``dst_device``, with an event recorded after it on the current
        stream."""
        import torch

        if not isinstance(source, torch.Tensor) \
                or source.device.type != "cpu" or source.numel() == 0:
            return
        dev = torch.device(dst_device)
        if dev.type != "cuda":
            return
        self.poll()
        self.crossings += 1
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        query = self._saved["ev_query"]
        self.track_pending(source, event, _call_site(),
                           done=lambda: query(event))

    def track_pending(self, source, event, site: str, done=None) -> None:
        """Register a pending asynchronous read of ``source`` that ends when
        ``event`` (anything with ``query()`` and ``synchronize()``)
        completes; ``done()`` asks it (default ``event.query``)."""
        rec = _Record(source, _digest(source), site, event,
                      done or event.query)
        with self._lock:
            self.pending.append(rec)

    def poll(self) -> None:
        """Verify and release every pending copy whose event completed."""
        if not self.pending:
            return
        with self._lock:
            batch, self.pending = self.pending, []
        left = []
        for rec in batch:
            if rec.done():
                self._verify_record(rec)
                rec.source = None
            else:
                left.append(rec)
        with self._lock:
            self.pending[:0] = left

    def _on_dead(self, rec: _Record) -> None:
        if not rec.dead:
            rec.dead = True
            self._verify_record(rec)
            # the window is closed and the verdict recorded: release the
            # source so a long sanitized run pins no buffer it crossed
            rec.source = None
            try:
                self.records.remove(rec)
            except ValueError:
                pass

    def _verify_record(self, rec: _Record) -> None:
        if rec.source is None:
            return                      # already verified and released
        if _digest(rec.source) != rec.digest:
            if rec.event is not None:
                msg = (f"host tensor written while its non_blocking copy to "
                       f"the card could still read it (crossing at "
                       f"{rec.site}, shape={tuple(rec.source.shape)}, "
                       f"dtype={rec.source.dtype}) — record an event after "
                       f"the copy and wait on it before writing, or stage "
                       f"into a fresh buffer (graftlint GD010)")
            else:
                msg = (f"host buffer mutated while a tensor sharing its "
                       f"memory was alive (crossing at {rec.site}, "
                       f"shape={rec.source.shape}, dtype={rec.source.dtype})"
                       f" — copy at the crossing (torch.tensor / .clone()) "
                       f"or drop the tensor before mutating (graftlint "
                       f"GD010)")
            if msg not in self.violations:
                self.violations.append(msg)

    def verify(self, *, wait: bool = False) -> None:
        """Re-verify every live alias and every completed copy now (with
        ``wait``, wait for every pending copy first); raise on any
        violation seen so far."""
        for rec in list(self.records):
            if not rec.dead:
                self._verify_record(rec)
        if wait:
            for rec in list(self.pending):
                rec.event.synchronize()
        self.poll()
        if self.violations:
            raise AliasRaceError("GRAPHDYN_SANITIZE=alias: "
                                 + "; ".join(self.violations))

    # -- patching --------------------------------------------------------

    def _patch(self) -> None:
        import torch

        T = torch.Tensor
        saved = {
            "from_numpy": torch.from_numpy, "as_tensor": torch.as_tensor,
            "to": T.to, "cuda": T.cuda, "copy_": T.copy_,
            "cuda_sync": torch.cuda.synchronize,
            "ev_sync": torch.cuda.Event.synchronize,
            "ev_query": torch.cuda.Event.query,
            "st_sync": torch.cuda.Stream.synchronize,
        }
        san = self

        def from_numpy(a):
            out = saved["from_numpy"](a)
            san._track_alias(a, out)
            return out

        def as_tensor(data, *args, **kwargs):
            out = saved["as_tensor"](data, *args, **kwargs)
            san._track_alias(data, out)
            return out

        def to(self, *args, **kwargs):
            out = saved["to"](self, *args, **kwargs)
            if kwargs.get("non_blocking") and out is not self:
                san._track_async(self, out.device)
            return out

        def cuda(self, *args, **kwargs):
            out = saved["cuda"](self, *args, **kwargs)
            if kwargs.get("non_blocking") and out is not self:
                san._track_async(self, out.device)
            return out

        def copy_(self, src, *args, **kwargs):
            out = saved["copy_"](self, src, *args, **kwargs)
            if kwargs.get("non_blocking"):
                san._track_async(src, self.device)
            return out

        def waited(name):
            def fn(*args, **kwargs):
                out = saved[name](*args, **kwargs)
                san.poll()
                return out
            return fn

        torch.from_numpy = from_numpy
        torch.as_tensor = as_tensor
        T.to, T.cuda, T.copy_ = to, cuda, copy_
        def query(ev):
            done = saved["ev_query"](ev)
            if done:
                san.poll()
            return done

        torch.cuda.synchronize = waited("cuda_sync")
        torch.cuda.Event.synchronize = waited("ev_sync")
        torch.cuda.Stream.synchronize = waited("st_sync")
        torch.cuda.Event.query = query
        self._saved = saved

    def _unpatch(self) -> None:
        import torch

        s = self._saved
        torch.from_numpy, torch.as_tensor = s["from_numpy"], s["as_tensor"]
        torch.Tensor.to, torch.Tensor.cuda = s["to"], s["cuda"]
        torch.Tensor.copy_ = s["copy_"]
        torch.cuda.synchronize = s["cuda_sync"]
        torch.cuda.Event.synchronize = s["ev_sync"]
        torch.cuda.Event.query = s["ev_query"]
        torch.cuda.Stream.synchronize = s["st_sync"]
        self._saved = None


_ACTIVE: list[AliasSanitizer] = []


@contextmanager
def alias_sanitizer():
    """Context manager: patch the crossings, yield the
    :class:`AliasSanitizer`, verify on clean exit (pending copies waited
    for first; an exception already propagating is not masked by a
    verification failure)."""
    if _ACTIVE:
        raise RuntimeError("alias_sanitizer() is already active "
                           "(not re-entrant)")
    san = AliasSanitizer()
    san._patch()
    _ACTIVE.append(san)
    try:
        yield san
    except BaseException:
        raise
    else:
        san.verify(wait=True)
    finally:
        _ACTIVE.pop()
        san._unpatch()
        # verification ends with the context: a late collection must not
        # re-verify against legitimately reused buffers
        for rec in list(san.records):
            rec.dead = True
            if rec.finalizer is not None:
                rec.finalizer.detach()
        san.pending = []


@contextmanager
def maybe_alias_sanitizer():
    """The env-gated wrapper the CLI runs every command under: the real
    sanitizer when ``GRAPHDYN_SANITIZE=alias``, a no-op otherwise."""
    if os.environ.get(ENV_VAR, "") == ENV_VALUE:
        with alias_sanitizer() as san:
            yield san
    else:
        yield None
