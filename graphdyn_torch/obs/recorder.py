"""The event recorder behind :mod:`graphdyn_torch.obs`: the JAX package's
recorder (``graphdyn/obs/recorder.py``) with the same JSONL schema, field for
field, so either package's reader and report take the other's ledgers.

One run → one append-only **JSONL event ledger**: every line is a complete
JSON object, written and flushed atomically per event, so a preemption
(SIGTERM → exit 75) or even a hard kill leaves a parseable prefix — at worst
the final line is torn, and :func:`read_ledger` tolerates exactly that (plus
the sealed seam a requeued run leaves when it reopens the same path: the
torn fragment gets its own line, followed by the new run's manifest).

Event kinds (the ``ev`` field; ``schema`` is stamped in the manifest):

``manifest``
    One per run, first: ``{"ev": "manifest", "t": 0.0, "run": {...}}`` —
    backend, torch/CUDA/python versions, the card, git sha, argv, config,
    pid, wall-clock epoch. Everything needed to interpret the rest of the file offline.
``span``
    Emitted when a span *closes*: ``{"ev": "span", "name", "id", "parent",
    "t0", "t", "wall_s", "cpu_s", "attrs"}``. ``t0``/``t`` are
    monotonic-clock offsets from the recorder's start (ordering-safe across
    system clock steps), ``wall_s`` is the monotonic duration, ``cpu_s``
    the process-CPU time consumed inside the span (wall ≫ cpu = the span
    waited — on the device, the disk, or a lock). ``parent`` is the id of
    the enclosing span on the same thread (spans nest via a thread-local
    stack), or null at top level.
``counter``
    ``{"ev": "counter", "name", "inc", "attrs"}`` — monotonically
    accumulating occurrences (retry attempts, kernel builds, fault hits).
    The report CLI sums ``inc`` per name.
``gauge``
    ``{"ev": "gauge", "name", "value", "attrs"}`` — point-in-time
    measurements (rates, utilization, latencies). The report CLI keeps
    last/min/max/mean per name.

The default recorder is :data:`NULL` — every method is a no-op and
``span()`` returns one shared, preallocated context manager, so an
uninstrumented run pays **one attribute check per site and allocates
nothing** (regression-tested). A real :class:`Recorder` is installed for a
scope by :func:`graphdyn_torch.obs.recording` (CLI ``--obs-ledger`` /
``GRAPHDYN_OBS=PATH``).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

from graphdyn_torch.obs import flight as _flight
from graphdyn_torch.obs import trace as _trace

_MONO = time.monotonic
_CPU = time.process_time

#: ledger schema version, stamped in the manifest event
SCHEMA = 1

EVENT_KINDS = ("manifest", "span", "counter", "gauge")


class _NullSpan:
    """The shared no-op span: one instance serves every ``span()`` call on
    the null recorder (no per-call allocation), and its timing surface reads
    zero — callers that need real measurements regardless of recording use
    :func:`graphdyn_torch.obs.timed`, which always measures."""

    __slots__ = ()

    wall_s = 0.0
    cpu_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def start(self):
        return self

    def stop(self):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """A measuring span. As a context manager it times its block; the
    imperative ``start()``/``stop()`` surface serves call sites that cannot
    be restructured into a ``with`` block (``stop()`` is idempotent).
    ``set(**attrs)`` attaches attributes any time before the span closes.
    When ``rec`` is None the span measures but emits nothing — the
    always-measuring :func:`graphdyn_torch.obs.timed` handle."""

    __slots__ = ("rec", "name", "attrs", "id", "parent", "t0",
                 "_c0", "wall_s", "cpu_s", "_open", "_ann")

    def __init__(self, rec, name: str, attrs: dict):
        self.rec = rec
        self.name = name
        self.attrs = attrs
        self.id = None
        self.parent = None
        self.t0 = 0.0
        self._c0 = 0.0
        self.wall_s = 0.0
        self.cpu_s = 0.0
        self._open = False
        self._ann = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def start(self) -> "Span":
        if self.rec is not None:
            self.id, self.parent = self.rec._push_span()
        # device-profiler alignment: while a torch.profiler trace is being
        # captured (obs.trace.profiling), the span also opens a
        # record_function range named with its ledger name PATH, so the
        # device timeline and the JSONL ledger share one vocabulary
        if _trace.active():
            self._ann = _trace.push(self.name)
        self._open = True
        self._c0 = _CPU()
        self.t0 = _MONO()
        return self

    def stop(self) -> "Span":
        if not self._open:
            return self
        self.wall_s = _MONO() - self.t0
        self.cpu_s = _CPU() - self._c0
        self._open = False
        if self._ann is not None:
            _trace.pop(self._ann)
            self._ann = None
        if self.rec is not None:
            self.rec._pop_span(self)
        return self

    def __enter__(self) -> "Span":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class NullRecorder:
    """The default: does nothing, costs (almost) nothing. Hot paths hold the
    module-level accessor and pay one attribute check (``rec.enabled``) plus
    — for ``span`` — one shared-object return per site.

    Two always-on device-side hooks live *behind* the null object (both
    off the hot path's allocation budget):

    - while a :func:`graphdyn_torch.obs.trace.profiling` capture is active,
      ``span()`` returns a measuring (non-emitting) :class:`Span` so the
      device timeline still gets the ledger-vocabulary trace annotations;
    - counter/gauge events are forwarded into the bounded flight-recorder
      ring (:mod:`graphdyn_torch.obs.flight`) so a crash without a ledger is
      still diagnosable post-mortem. ``GRAPHDYN_FLIGHT=0`` disarms it.
    """

    enabled = False

    def span(self, name: str, **attrs):
        if _trace.active():
            return Span(None, name, attrs)
        return NULL_SPAN

    def counter(self, name: str, inc: int = 1, **attrs) -> None:
        if _flight.armed():
            _flight.record_counter(name, inc, attrs)
        return None

    def gauge(self, name: str, value, **attrs) -> None:
        if _flight.armed():
            _flight.record_gauge(name, value, attrs)
        return None

    def manifest(self, **fields):
        return None

    def event(self, doc: dict) -> None:
        return None

    def close(self) -> None:
        return None


NULL = NullRecorder()


class Recorder(NullRecorder):
    """Appends one JSON line per event to ``path``, flushed per event.

    Thread-safe (prefetch threads emit too): writes serialize on an RLock
    and the span stack is thread-local, so spans nest per thread. Attribute
    values that are not JSON types serialize via ``str`` — an attrs dict can
    carry numpy scalars or paths without the emit raising."""

    enabled = True

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # seal a torn tail before appending: a hard-killed prior run (same
        # GRAPHDYN_OBS path across a requeue) may have died mid-line, and
        # appending straight onto the fragment would glue this run's first
        # event to it — destroying the event and turning a tolerated
        # final-line tear into mid-file corruption
        sealed = False
        try:
            with open(path, "rb") as prev:
                prev.seek(-1, os.SEEK_END)
                sealed = prev.read(1) != b"\n"
        except (OSError, ValueError):
            pass                        # absent or empty file: nothing to seal
        # append-only: each event is one flushed line (a torn final line
        # is the designed failure mode, which read_ledger tolerates)
        # graftlint: disable-next-line=GD007  append-only JSONL ledger: each event is one flushed line, a torn final line is the designed failure mode (read_ledger tolerates it)
        self._f = open(path, "a", encoding="utf-8")
        if sealed:
            self._f.write("\n")
            self._f.flush()
        self._lock = threading.RLock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._t0 = _MONO()

    # -- span bookkeeping (thread-local nesting) ------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "spans", None)
        if st is None:
            st = self._local.spans = []
        return st

    def _push_span(self):
        st = self._stack()
        parent = st[-1] if st else None
        sid = next(self._ids)
        st.append(sid)
        return sid, parent

    def _pop_span(self, span: Span) -> None:
        st = self._stack()
        # tolerate non-LIFO stops: truncate from this span's position, so a
        # descendant whose stop() was skipped (an exception unwound past an
        # imperative start()) is cleaned up when its enclosing span closes
        # instead of misparenting every later span on the thread
        if span.id in st:
            del st[st.index(span.id):]
        self.event({
            "ev": "span",
            "t": round(_MONO() - self._t0, 6),
            "name": span.name,
            "id": span.id,
            "parent": span.parent,
            "t0": round(span.t0 - self._t0, 6),
            "wall_s": round(span.wall_s, 6),
            "cpu_s": round(span.cpu_s, 6),
            **({"attrs": span.attrs} if span.attrs else {}),
        })

    # -- public surface -------------------------------------------------

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def counter(self, name: str, inc: int = 1, **attrs) -> None:
        self.event({
            "ev": "counter",
            "t": round(_MONO() - self._t0, 6),
            "name": name,
            "inc": inc,
            **({"attrs": attrs} if attrs else {}),
        })

    def gauge(self, name: str, value, **attrs) -> None:
        self.event({
            "ev": "gauge",
            "t": round(_MONO() - self._t0, 6),
            "name": name,
            "value": value,
            **({"attrs": attrs} if attrs else {}),
        })

    def manifest(self, **fields) -> dict:
        """Emit the per-run manifest event and return the ``run`` dict (the
        caller may hash it)."""
        run = {
            "schema": SCHEMA,
            "pid": os.getpid(),
            "time_unix": time.time(),
            **fields,
        }
        self.event({"ev": "manifest", "t": round(_MONO() - self._t0, 6),
                    "run": run})
        return run

    def event(self, doc: dict) -> None:
        """Append one event: one complete JSON line, flushed — the
        truncation-safety unit of the ledger."""
        line = json.dumps(doc, separators=(",", ":"), default=str)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def read_ledger(path: str) -> tuple[list[dict], int]:
    """Parse a JSONL ledger into ``(events, torn_lines)``.

    Every well-formed line yields one event dict. A torn line (the process
    died mid-write) is counted, not fatal, in the two places a crash can
    legitimately leave one: the FINAL line, and a line immediately followed
    by a ``manifest`` event — the seam a requeued run seals when it reopens
    the same ledger path after a hard kill (``Recorder.__init__``) before
    stamping its manifest. A torn line anywhere else means the file is not
    append-only JSONL and raises. Events whose ``ev`` kind is unknown are
    kept (forward compatibility) — validators that want strictness filter
    on :data:`EVENT_KINDS`."""
    events: list[dict] = []
    torn = 0
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()

    def _is_manifest(line: str) -> bool:
        try:
            return json.loads(line).get("ev") == "manifest"
        except (json.JSONDecodeError, AttributeError):
            return False

    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1 or _is_manifest(lines[i + 1]):
                torn += 1
                continue
            raise ValueError(
                f"{path}:{i + 1}: torn JSON line in the middle of the "
                f"ledger — not an append-only JSONL file"
            )
    return events, torn
