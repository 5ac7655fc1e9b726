"""Result files, checkpoints and exact resume (the port of
``graphdyn/utils/io.py``).

Result files are written atomically (temp file + ``os.replace``), so a run
cut off during its end-of-run save cannot leave a torn file. Checkpoints
are one ``<path>.npz`` of the solver state's arrays plus its metadata as a
JSON ``__meta__`` entry, the JAX package's format; every consumer opens
them through :func:`open_checkpoint`, the durable store of
:mod:`graphdyn_torch.resilience.store`. :func:`run_fingerprint` gives the
JAX package's digest for the same numpy arrays and strings; the drivers put
the port's own identity into what they fingerprint, so a JAX-package
snapshot, whose RNG state means something else here, is refused.

The JAX package's ``save_pytree_orbax``/``load_pytree_orbax`` store JAX
pytrees through a JAX library and are not ported (ROADMAP A18).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
import zipfile
import zlib
from typing import Any

import numpy as np

from graphdyn_torch.resilience import faults as _faults
from graphdyn_torch.resilience.retry import SAVE_RETRY, retry as _retry_call
from graphdyn_torch.resilience.shutdown import raise_if_requested, shutdown_requested
from graphdyn_torch.resilience.supervisor import beat as _beat

log = logging.getLogger("graphdyn.io")


def _fingerprint_repr(p) -> str:
    """``repr`` for fingerprinting. For config dataclasses, fields named in
    the class's ``_fingerprint_optional`` tuple are omitted when they hold
    their default value — so ADDING an opt-in field (at a
    semantics-preserving default) does not invalidate checkpoints written
    before the field existed. At the defaults the produced string is
    byte-identical to the pre-field dataclass repr."""
    import dataclasses

    if dataclasses.is_dataclass(p) and not isinstance(p, type):
        skip = getattr(p, "_fingerprint_optional", ())
        parts = []
        for f in dataclasses.fields(p):
            v = getattr(p, f.name)
            if f.name in skip:
                if f.default is not dataclasses.MISSING and v == f.default:
                    continue
                if (f.default_factory is not dataclasses.MISSING
                        and v == f.default_factory()):
                    continue
            parts.append(f"{f.name}={_fingerprint_repr(v)}")
        return f"{type(p).__name__}({', '.join(parts)})"
    return repr(p)


def run_fingerprint(*parts) -> str:
    """Stable hex digest identifying a solver run's full identity — graph
    arrays hash by bytes+shape, everything else by ``repr`` (config
    dataclasses have stable field reprs; opt-in fields at their defaults
    are excluded, see :func:`_fingerprint_repr`). Stored in
    chain-checkpoint metadata so a resume under a different graph, config,
    dtype, or budget is refused instead of silently producing a chimera
    chain."""
    h = hashlib.sha1()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(str(p.shape).encode())
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(_fingerprint_repr(p).encode())
        h.update(b"|")
    return h.hexdigest()


def _atomic_savez(path: str, payload: dict) -> str:
    """``np.savez`` with the temp-file + ``os.replace`` discipline: a reader
    (or a preemption mid-write) sees either the old file or the new one,
    never a torn npz. Preserves ``np.savez``'s append-``.npz`` semantics;
    returns the final path. The one savez both :func:`save_results_npz` and
    :class:`Checkpoint` go through."""
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final[:-len(".npz")] + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, final)
    return final


def save_results_npz(path: str, **arrays) -> str:
    """Reference-compatible npz result file (the keys are the caller's, as
    in ``graphdyn/utils/io.py:save_results_npz``), written atomically: a
    preemption during the end-of-run save cannot leave a torn file. Like
    ``np.savez`` it appends ``.npz`` to a path without it; returns the
    final path."""
    return _atomic_savez(path, {k: np.asarray(v) for k, v in arrays.items()})


def load_results_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def write_json_atomic(path: str, doc, **dump_kwargs) -> None:
    """JSON result file via temp + ``os.replace`` — the torn-write
    discipline of the npz writers."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(json.dumps(doc, **dump_kwargs))
    os.replace(tmp, path)


class Checkpoint:
    """Minimal atomic checkpoint of a solver-state dict of arrays + metadata.

    Layout: one ``<path>.npz`` holding the arrays plus the metadata as a
    JSON-encoded ``__meta__`` entry. The single file goes through a temp
    file + ``os.replace``, so arrays and metadata can never be torn apart by
    a preemption — a reader sees either the old checkpoint or the new one.

    The durable store (:class:`graphdyn_torch.resilience.store.DurableCheckpoint`,
    reached through :func:`open_checkpoint`) subclasses this with checksums,
    retention and mirroring — same file format, same fault sites.
    """

    _META_KEY = "__meta__"

    #: structural-corruption exceptions (vs transient OSError, which must
    #: propagate): what quarantine-and-fall-back is allowed to swallow
    _STRUCTURAL = (zipfile.BadZipFile, zlib.error, EOFError, ValueError)

    #: quarantined corruption evidence retained per checkpoint path (oldest
    #: cleaned first) — bounded so an unattended requeue loop cannot fill
    #: the disk with .corrupt files
    _QUARANTINE_KEEP = 5

    def __init__(self, path: str):
        self.path = path

    def _payload(self, arrays: dict[str, Any],
                 meta: dict[str, Any]) -> dict[str, np.ndarray]:
        """Validate + assemble the npz payload (arrays + JSON meta entry)."""
        if self._META_KEY in arrays:
            raise ValueError(f"array key {self._META_KEY!r} is reserved")
        payload = {k: np.asarray(v) for k, v in arrays.items()}
        for k, v in payload.items():
            if v.dtype == object:
                # savez would pickle it and SUCCEED, but the default
                # allow_pickle=False load then raises ValueError — which the
                # corruption handler would read as a corrupt file and
                # quarantine on every resume. Fail at write time instead.
                raise TypeError(
                    f"checkpoint array {k!r} has dtype=object (ragged or "
                    f"mixed) — not loadable without pickle; use a "
                    f"fixed-width dtype"
                )
        payload[self._META_KEY] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
        return payload

    def _write_fault_gate(self) -> None:
        """The ``checkpoint.write`` fault site (raise-ENOSPC / torn temp
        file / preempt), shared by the plain and durable save paths."""
        spec = _faults.check_fault("checkpoint.write", key=self.path)
        if spec is not None and spec.action != "signal":
            if spec.action == "preempt":
                raise _faults.InjectedPreemption(
                    f"injected preempt during checkpoint write ({self.path})"
                )
            if spec.action == "torn":
                # what a real preemption mid-savez leaves behind: a partial
                # temp file (never the published .npz — os.replace is atomic)
                with open(self.path + ".tmp.npz", "wb") as f:
                    f.write(b"PK\x03\x04 torn by injected preemption")
            raise _faults.InjectedWriteError(self.path)

    def save(self, arrays: dict[str, Any], meta: dict[str, Any]) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        payload = self._payload(arrays, meta)
        self._write_fault_gate()
        self._persist(payload, meta)

    def _persist(self, payload: dict[str, np.ndarray],
                 meta: dict[str, Any]) -> None:
        """One complete persistence of the assembled payload — the subclass
        hook. The durable store overrides THIS, not :meth:`save`, so every
        checkpoint write (plain or durable) flows through the one ``save``
        entry point — wrappers patched onto ``Checkpoint.save`` (the test
        suite's abort-after-save preemption fixture, retry shims) observe
        durable saves too."""
        from graphdyn_torch.resilience import hooks as obs

        with obs.current().span("io.ckpt.write", path=self.path) as sp:
            _atomic_savez(self.path + ".npz", payload)
            if obs.enabled():
                sp.set(bytes=int(os.path.getsize(self.path + ".npz")))

    def remove(self) -> None:
        """Delete the checkpoint file if present (end-of-run cleanup), plus
        any stale temp file a preemption between ``np.savez`` and
        ``os.replace`` may have left behind."""
        for p in (self.path + ".npz", self.path + ".tmp.npz"):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass

    def _read_npz(self, path: str) -> tuple[dict[str, np.ndarray], dict]:
        """One structural npz read (arrays + decoded meta); raises the
        :data:`_STRUCTURAL` exceptions on corruption, ``OSError`` on
        transient trouble — classification is the caller's policy."""
        with np.load(path) as f:
            arrays = {k: f[k] for k in f.files if k != self._META_KEY}
            if self._META_KEY in f.files:
                meta = json.loads(f[self._META_KEY].tobytes().decode())
            else:
                # foreign/legacy npz (e.g. a reference-style results
                # file): still loadable, just with empty metadata
                meta = {}
        return arrays, meta

    def _quarantine_file(self, path: str) -> str:
        """Move ``path`` aside as corruption evidence with a MONOTONIC
        suffix (``.corrupt.1.npz``, ``.corrupt.2.npz``, …) so a second
        corruption can never overwrite the first's evidence; at most
        :data:`_QUARANTINE_KEEP` are retained (oldest removed first)."""
        import glob as _glob
        import re as _re

        pat = _re.compile(_re.escape(self.path) + r"\.corrupt\.(\d+)\.npz$")
        existing = sorted(
            (int(m.group(1)), f)
            for f in _glob.glob(_glob.escape(self.path) + ".corrupt.*.npz")
            if (m := pat.match(f))
        )
        nxt = (existing[-1][0] + 1) if existing else 1
        quarantine = f"{self.path}.corrupt.{nxt}.npz"
        try:
            os.replace(path, quarantine)
        except OSError:
            return "<unquarantined: rename failed>"
        retained = existing + [(nxt, quarantine)]
        for _, f in retained[:-self._QUARANTINE_KEEP]:
            try:
                os.remove(f)
            except OSError:
                pass
        return quarantine

    def load(self) -> tuple[dict[str, np.ndarray], dict[str, Any]] | None:
        path = self.path + ".npz"
        if not os.path.exists(path):
            return None
        spec = _faults.transform_spec("checkpoint.read", "truncate",
                                      key=self.path)
        if spec is not None:
            _faults.truncate_file(path)          # torn flush / partial copy
        from graphdyn_torch.resilience import hooks as obs

        try:
            with obs.current().span("io.ckpt.read", path=self.path):
                arrays, meta = self._read_npz(path)
        # structural corruption ONLY — a transient read error (plain
        # OSError: EIO, EACCES, network blip) must propagate, not destroy a
        # perfectly good checkpoint by quarantining it
        except self._STRUCTURAL as e:
            # a corrupted/truncated checkpoint is a first-class condition
            # (torn write on a dying node, partial object-store copy), not
            # a crash: quarantine it for post-mortem and start fresh. The
            # quarantine file is deliberately NOT cleaned by remove().
            quarantine = self._quarantine_file(path)
            log.warning(
                "checkpoint at %s is corrupt (%s: %s) — quarantined to %s, "
                "starting fresh", path, type(e).__name__, e, quarantine,
            )
            obs.counter("io.ckpt.quarantine", path=self.path,
                        quarantine=quarantine,
                        error=f"{type(e).__name__}: {e}"[:200])
            return None
        return arrays, meta


def open_checkpoint(path: str) -> Checkpoint:
    """The checkpoint factory every consumer goes through
    (:class:`ChainCheckpointer`, :class:`PeriodicCheckpointer`,
    :func:`load_validated`, the grouped drivers): returns the durable store
    (:class:`graphdyn_torch.resilience.store.DurableCheckpoint` — checksum-verified
    loads, keep-last-K retention, optional ``--ckpt-mirror`` replication,
    run journal) wrapping the same on-disk snapshot format. Plain
    :class:`Checkpoint` remains available for format-level tests."""
    from graphdyn_torch.resilience.store import DurableCheckpoint

    return DurableCheckpoint(path)


def load_resume_prefix(ck: Checkpoint, expect: dict[str, Any]):
    """Load an ensemble-driver resume snapshot and validate its identity.

    The shared half of the driver resume protocol (used by ``sa_ensemble``
    and ``hpr_ensemble``): returns ``(arrays, next_rep)``, or ``None`` when
    no checkpoint exists; raises ``ValueError`` when any ``expect`` key
    disagrees with the stored metadata — a checkpoint from a different run
    must be refused, never silently mixed in."""
    loaded = ck.load()
    if loaded is None:
        return None
    arrays, meta = loaded
    bad = {k: (meta.get(k), v) for k, v in expect.items() if meta.get(k) != v}
    if bad:
        raise ValueError(
            f"checkpoint at {ck.path!r} is from a different run "
            f"(stored vs expected: {bad}); refusing to resume"
        )
    return arrays, int(meta["next_rep"])


def load_validated(path: str, id_key: str, id_value, what: str):
    """Load a checkpoint and refuse it unless ``meta[id_key]`` equals the
    caller's run identity — the shared load-or-refuse half of the λ-driver
    resume protocol (``entropy_grid``, ``entropy_ensemble_union``). Returns
    ``(arrays, meta)`` or None when no checkpoint exists."""
    loaded = open_checkpoint(path).load()
    if loaded is None:
        return None
    arrays, meta = loaded
    if meta.get(id_key) != id_value:
        raise ValueError(
            f"checkpoint at {path!r} is from a different {what} run "
            f"(meta {meta}); refusing to resume"
        )
    return arrays, meta


class ChainCheckpointer:
    """The chain-level exact-resume protocol shared by the solvers
    (``simulated_annealing``, ``temper_search``, ``hpr_solve``,
    ``hpr_solve_batch``): a fingerprint-validated load that refuses foreign
    snapshots, a due-gated periodic save stamping identical metadata, and
    remove-on-completion. One implementation so the protocol cannot drift
    between solvers.

    ``extra_meta``: additional identity fields (e.g. replica count) checked
    for equality on load and stamped on save alongside kind/seed/fp.

    ``sync`` (a :class:`graphdyn_torch.parallel.mesh.WorldSync`) makes the
    protocol a sharded run's: only rank 0 (``sync.writer``) reads, writes
    and removes the file, the loaded snapshot (or the refusal) is broadcast
    to every rank, and each chunk boundary's save and shutdown decisions are
    or-reduced over the ranks, so a SIGTERM on any rank snapshots and stops
    every rank at the same boundary. ``payload`` is then called on every
    rank (it gathers the global state, a collective).
    """

    def __init__(self, path: str, *, kind: str, seed: int, fp: str,
                 interval_s: float, extra_meta: dict | None = None,
                 sync=None):
        self.path = path
        self.sync = sync
        self._meta = {"kind": kind, "seed": int(seed), "fp": fp,
                      **(extra_meta or {})}
        self.ckpt = open_checkpoint(path)
        self._pc = PeriodicCheckpointer(path, interval_s=interval_s)

    @property
    def writer(self) -> bool:
        return self.sync is None or self.sync.writer

    def load_state(self, check=None) -> dict | None:
        """Load and validate; returns the arrays dict, or None when no
        checkpoint exists. ``check(arrays) -> bool`` adds shape/content
        validation. Raises ValueError on any identity mismatch (on every
        rank, under ``sync``)."""
        if self.sync is None:
            return self._load_state(check)
        got = None
        if self.sync.writer:
            try:
                got = ("ok", self._load_state(check))
            except ValueError as e:
                got = ("refused", str(e))
        got = self.sync.bcast(got)
        if got[0] == "refused":
            raise ValueError(got[1])
        return got[1]

    def _load_state(self, check=None) -> dict | None:
        loaded = self.ckpt.load()
        if loaded is None:
            return None
        arrays, meta = loaded
        ok = all(meta.get(k) == v for k, v in self._meta.items())
        if ok and check is not None:
            ok = bool(check(arrays))
        if not ok:
            raise ValueError(
                f"checkpoint at {self.path!r} is not a matching "
                f"{self._meta['kind']} snapshot for this graph/config/seed "
                f"(meta {meta}); refusing to resume"
            )
        return arrays

    def due(self) -> bool:
        return self._pc.due()

    def maybe_save(self, arrays: dict) -> bool:
        return self._pc.maybe_save(arrays, self._meta)

    def save_now(self, arrays: dict) -> bool:
        """Immediate save bypassing the interval gate — the shutdown
        snapshot. Same retry/degrade policy as periodic saves."""
        return self._pc.save_now(arrays, self._meta)

    def remove(self) -> None:
        self._pc.remove()

    def drive(self, state, *, advance, active, payload):
        """The shared chunk loop: run ``advance(state)`` until
        ``active(state)`` is False, saving a due snapshot between chunks —
        never of a finished state, so an abort in the final window cannot
        leave a stale done-snapshot — then remove the file. ``payload`` is
        only called when a save is actually due (snapshots can be large
        device-to-host copies). Returns the final state.

        Preemption-safe: when a graceful shutdown is pending (SIGTERM under
        :func:`graphdyn_torch.resilience.graceful_shutdown`), the chunk boundary
        forces an immediate snapshot and raises
        :class:`~graphdyn_torch.resilience.ShutdownRequested` — so the on-disk
        checkpoint is never older than one chunk when the CLI exits 75.
        Fault site ``chunk.boundary`` simulates a hard preemption here."""
        if self.sync is not None:
            return self._drive_synced(state, advance=advance, active=active,
                                      payload=payload)
        k = 0
        while active(state):
            state = advance(state)
            k += 1
            _beat("chunk")
            _faults.maybe_fail("chunk.boundary", key=f"{self.path}#{k}")
            if active(state):
                if shutdown_requested():
                    if not self.save_now(payload(state)):
                        log.warning(
                            "shutdown snapshot for %s could not be written "
                            "— resume will fall back to the last periodic "
                            "checkpoint (if any)", self.path,
                        )
                    raise_if_requested(where="chunk")
                elif self.due():
                    self.maybe_save(payload(state))
        self.remove()
        return state

    def _drive_synced(self, state, *, advance, active, payload):
        """:meth:`drive` over the ranks of ``sync``: the same boundaries,
        with the shutdown flag of any rank and rank 0's save clock or-reduced
        into one decision that every rank takes."""
        from graphdyn_torch.resilience.shutdown import ShutdownRequested

        k = 0
        while active(state):
            state = advance(state)
            k += 1
            _beat("chunk")
            _faults.maybe_fail("chunk.boundary", key=f"{self.path}#{k}")
            if active(state):
                stop, due = self.sync.any(shutdown_requested(),
                                          self.writer and self.due())
                if stop or due:
                    arrays = payload(state)
                    if self.writer:
                        if not self.save_now(arrays) and stop:
                            log.warning(
                                "shutdown snapshot for %s could not be "
                                "written — resume will fall back to the "
                                "last periodic checkpoint (if any)",
                                self.path)
                if stop:
                    raise_if_requested(where="chunk")
                    raise ShutdownRequested(None, where="chunk")
        if self.writer:
            self.remove()
        return state


def save_with_retry(ckpt: Checkpoint, arrays: dict, meta: dict) -> bool:
    """``ckpt.save`` under the process-wide retry budget
    (:data:`graphdyn_torch.resilience.retry.SAVE_RETRY`, CLI
    ``--max-save-retries``), degrading to **skip-save** when retries are
    exhausted: a transient (or even persistent) write failure must not kill
    an hours-long chain — the snapshot is insurance, the chain is the
    value. Returns False (with a logged warning) on the degrade path."""
    try:
        # the pid in the site key seeds SAVE_RETRY's full-jitter: N hosts
        # retrying a save to the same shared-filesystem path must draw
        # DE-correlated backoff schedules (path alone would give every
        # rank the identical seed — the lockstep stampede the jitter
        # exists to prevent)
        _retry_call(
            lambda: ckpt.save(arrays, meta),
            policy=SAVE_RETRY,
            retry_on=(OSError,),
            what=f"checkpoint save ({ckpt.path}, pid {os.getpid()})",
        )
        return True
    except OSError as e:
        log.warning(
            "checkpoint save to %s failed after %d attempt(s) — SKIPPING "
            "this snapshot and continuing the run: %s",
            ckpt.path, SAVE_RETRY.tries, e,
        )
        from graphdyn_torch.resilience import hooks as obs

        obs.counter("resilience.retry.degrade", site=f"checkpoint save "
                    f"({ckpt.path})", attempts=SAVE_RETRY.tries,
                    decision="skip-save",
                    error=f"{type(e).__name__}: {e}"[:200])
        return False


class PeriodicCheckpointer:
    """Time-triggered checkpointing (the notebook's ``saving_time`` sketch,
    `ipynb:439-445`): call ``maybe_save`` inside the solver loop; it writes at
    most every ``interval_s`` seconds. Writes go through
    :func:`save_with_retry` — after the retry budget, the snapshot is
    skipped (logged) and the next one is attempted an interval later."""

    def __init__(self, path: str, interval_s: float = 30.0, max_saves: int | None = None):
        self.ckpt = open_checkpoint(path)
        self.interval_s = interval_s
        self.max_saves = max_saves
        self._last = time.monotonic()
        self._count = 0

    def due(self) -> bool:
        """True when the next ``maybe_save`` would actually write — callers
        with expensive payloads (device-to-host copies) should gate payload
        construction on this."""
        if self.max_saves is not None and self._count >= self.max_saves:
            return False
        return time.monotonic() - self._last >= self.interval_s

    def maybe_save(self, arrays: dict[str, Any], meta: dict[str, Any]) -> bool:
        if not self.due():
            return False
        return self.save_now(arrays, meta)

    def save_now(self, arrays: dict[str, Any], meta: dict[str, Any]) -> bool:
        """Immediate save bypassing the interval gate — the graceful-
        shutdown snapshot (same retry/degrade policy). On the degrade path
        the clock still resets: retry next interval, don't hammer a full
        disk on every chunk."""
        ok = save_with_retry(self.ckpt, arrays, meta)
        self._last = time.monotonic()
        if ok:
            self._count += 1
        return ok

    def remove(self) -> None:
        self.ckpt.remove()
