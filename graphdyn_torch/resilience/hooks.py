"""The one hook through which the durability layer reports its events.

The JAX package sends the counters, gauges and spans of its checkpoint
store, retry loop and supervisor to its telemetry recorder, and writes a
flight post-mortem (``obs_postmortem.jsonl``) when a run dies. The port's
telemetry comes later (ROADMAP A17); until then every call here records
nothing, at the cost of one function call. :func:`read_ledger` is the JSONL
reader the journal validator and the supervisor need now, so it is real.
"""

from __future__ import annotations

import contextlib
import json

#: the post-mortem file name of the JAX package's flight recorder
POSTMORTEM_NAME = "obs_postmortem.jsonl"


def enabled() -> bool:
    """Whether a recorder is on (never, yet)."""
    return False


def counter(name: str, value: float = 1, **attrs) -> None:
    """A counter event (recorded nowhere yet)."""


def gauge(name: str, value: float, **attrs) -> None:
    """A gauge event (recorded nowhere yet)."""


def dump(reason: str, exc: BaseException | None = None,
         site: str | None = None) -> None:
    """A flight post-mortem at a crash, stall or poisoned sweep (written
    nowhere yet)."""


class _Span:
    def set(self, **attrs) -> None:
        pass


class _Recorder:
    enabled = False

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        yield _Span()


_RECORDER = _Recorder()


def current() -> _Recorder:
    """The active recorder: a null one."""
    return _RECORDER


def read_ledger(path: str) -> tuple[list[dict], int]:
    """Parse a JSONL ledger (a run journal, a post-mortem) into ``(events,
    torn_lines)``, as the JAX package's reader does. A torn line (the
    process died mid-write) is counted, not fatal, where a crash can leave
    one: the last line, and a line followed by a ``manifest`` event (the
    seam a requeued run seals before stamping its manifest). A torn line
    anywhere else raises ``ValueError``."""
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
                f"ledger — not an append-only JSONL file")
    return events, torn
