"""Durable checkpoint store: checksums, rolling retention, mirror failover
(the port of ``graphdyn/resilience/store.py``; its files are the JAX
package's: the npz with ``__meta__``, the manifest, the journal).

- **Checksum-verified loads.** Every save writes a sidecar manifest
  (``<path>.manifest.json``) with per-array and metadata SHA-256 digests;
  every load recomputes and compares them. Flipped bytes inside a valid
  zip container, which ``np.load`` returns without complaint, become a
  quarantine and a fallback instead of a wrong resume. A manifest-less
  snapshot still loads, unverified.
- **Versioned rolling retention.** A save lands as ``<path>.v<N>.npz``
  (and its manifest), then is promoted to ``<path>.npz`` by one hard link
  and one atomic rename; the last ``keep`` versions are retained, so a
  corrupt current file falls back to the newest verifiable version.
- **Mirror replication** (``--ckpt-mirror DIR`` / ``GRAPHDYN_CKPT_MIRROR``):
  versions and manifests are copied write-behind to a second directory by
  a background worker; a load fails over to the mirror (verified there
  too) when no primary candidate verifies.
- **Run journal** (``run_journal.jsonl`` beside the checkpoints): every
  save, load, quarantine, failover and mirror event is one appended JSON
  line; a torn tail is sealed on reopen and each process stamps a
  ``manifest`` line first.

Load order (the first verifiable candidate wins): ``<path>.npz``, then the
retained versions newest first, then the mirror's copy and its versions;
none: a fresh start, or the first transient ``OSError`` re-raised when every
candidate failed with one.
"""

from __future__ import annotations

import atexit
import dataclasses
import glob
import hashlib
import json
import logging
import os
import queue
import re
import shutil
import sys
import threading
import time

import numpy as np

from graphdyn_torch.resilience import faults as _faults
# Safe despite the io→resilience package import: this module is only ever
# imported lazily (utils.io.open_checkpoint, the resilience.__getattr__
# export, the CLI, tests) — never while utils.io is itself half-initialized.
from graphdyn_torch.utils.io import Checkpoint, _atomic_savez, write_json_atomic

log = logging.getLogger("graphdyn_torch.resilience")

#: manifest schema version, stamped in every sidecar manifest
MANIFEST_SCHEMA = 1

#: journal file name, one per checkpoint directory
JOURNAL_NAME = "run_journal.jsonl"

#: journal event ops (validators reject anything else): the JAX package's
#: whole set, so each package validates the other's journals. The
#: ``supervise.*`` ops are appended by the restart loop of
#: :mod:`graphdyn_torch.resilience.supervisor`, the ``serve.*`` ops by the
#: job service (:mod:`graphdyn_torch.serve.spool`).
JOURNAL_OPS = (
    "save", "load", "quarantine", "reject", "failover", "read-error",
    "mirror.save", "mirror.degraded", "remove",
    "supervise.start", "supervise.restart", "supervise.quarantine",
    "serve.submit", "serve.done", "serve.refuse", "serve.requeue",
    "serve.evict", "serve.quarantine",
    "stream.churn", "stream.repartition",
)

_VERSION_RE = re.compile(r"\.v(\d+)\.npz$")


class ChecksumError(Exception):
    """A checkpoint's content disagrees with its manifest — silent bit rot
    or a stale/foreign manifest. Treated like structural corruption:
    quarantine + fall back, never resume the wrong state."""


# ---------------------------------------------------------------------------
# store configuration (process-wide, CLI --ckpt-mirror/--ckpt-keep)
# ---------------------------------------------------------------------------


def _env_keep() -> int:
    try:
        return max(1, int(os.environ.get("GRAPHDYN_CKPT_KEEP", "") or 2))
    except ValueError:
        return 2


@dataclasses.dataclass
class StoreConfig:
    """Process-wide durable-store knobs. A mutable singleton like
    :data:`graphdyn_torch.resilience.retry.SAVE_RETRY` — the CLI flags reach every
    solver without threading parameters through ten signatures."""

    mirror: str | None = None   # second directory for write-behind replicas
    keep: int = 2               # retained versions per checkpoint (>= 1)


CONFIG = StoreConfig(
    mirror=os.environ.get("GRAPHDYN_CKPT_MIRROR") or None,
    keep=_env_keep(),
)

_UNSET = object()


def configure_store(mirror=_UNSET, keep=_UNSET) -> StoreConfig:
    """Set the process-wide store config (CLI ``--ckpt-mirror`` /
    ``--ckpt-keep``; omitted fields keep their current value). Returns the
    live singleton."""
    if mirror is not _UNSET:
        CONFIG.mirror = mirror or None
    if keep is not _UNSET:
        CONFIG.keep = max(1, int(keep))
    return CONFIG


# ---------------------------------------------------------------------------
# checksums + manifest
# ---------------------------------------------------------------------------


def array_sha256(a: np.ndarray) -> str:
    """SHA-256 over dtype + shape + bytes — the unit the manifest stores per
    array and every load recomputes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256()
    h.update(a.dtype.str.encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def meta_sha256(meta: dict) -> str:
    return hashlib.sha256(
        json.dumps(meta, sort_keys=True, default=str).encode()
    ).hexdigest()


def _manifest_self_sha(doc: dict) -> str:
    body = {k: v for k, v in doc.items() if k != "manifest_sha256"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()
    ).hexdigest()


def build_manifest(version: int, payload: dict, meta: dict,
                   meta_key: str) -> dict:
    """The sidecar manifest for one snapshot: per-array + metadata SHA-256
    plus a self-digest (so manifest bit rot is itself detectable)."""
    doc = {
        "schema": MANIFEST_SCHEMA,
        "version": int(version),
        "time_unix": time.time(),
        "arrays": {
            k: {"sha256": array_sha256(v), "dtype": v.dtype.str,
                "shape": list(v.shape)}
            for k, v in payload.items() if k != meta_key
        },
        "meta_sha256": meta_sha256(meta),
    }
    doc["manifest_sha256"] = _manifest_self_sha(doc)
    return doc


def verify_manifest(arrays: dict, meta: dict, manifest: dict) -> None:
    """Raise :class:`ChecksumError` unless ``arrays``/``meta`` match the
    manifest exactly — including the array *set* (a dropped or injected
    array is as wrong as a flipped byte)."""
    if manifest.get("manifest_sha256") != _manifest_self_sha(manifest):
        raise ChecksumError("manifest self-checksum mismatch (manifest rot)")
    want = manifest.get("arrays", {})
    if set(want) != set(arrays):
        raise ChecksumError(
            f"array set mismatch: manifest {sorted(want)} vs "
            f"snapshot {sorted(arrays)}"
        )
    for k, rec in want.items():
        got = array_sha256(arrays[k])
        if got != rec["sha256"]:
            raise ChecksumError(
                f"array {k!r} checksum mismatch "
                f"(stored {rec['sha256'][:12]}…, loaded {got[:12]}…)"
            )
    if meta_sha256(meta) != manifest.get("meta_sha256"):
        raise ChecksumError("metadata checksum mismatch")


def _read_manifest(path: str) -> dict | None:
    """The sidecar manifest, or None when absent/unparseable (an unreadable
    manifest downgrades the snapshot to unverifiable, it does not crash the
    load)."""
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


# ---------------------------------------------------------------------------
# run journal (append-only JSONL, obs read_ledger-compatible)
# ---------------------------------------------------------------------------

_journal_lock = threading.RLock()
_journal_manifested: set[str] = set()


def journal_path_for(ckpt_path: str) -> str:
    """The journal shared by every checkpoint in ``ckpt_path``'s directory."""
    return os.path.join(os.path.dirname(ckpt_path) or ".", JOURNAL_NAME)


def _reset_journal_state() -> None:
    """Forget which journals this process already stamped (tests simulating
    a requeued process)."""
    with _journal_lock:
        _journal_manifested.clear()


def journal_event(jpath: str, op: str, **fields) -> None:
    """Append one journal event; **never raises** — the journal is evidence,
    not the value. The first event a process appends to a given journal is
    preceded by sealing any torn tail (a hard-killed prior run may have died
    mid-line) and a ``manifest`` line, exactly the seam
    :func:`graphdyn_torch.resilience.hooks.read_ledger` tolerates."""
    try:
        with _journal_lock:
            os.makedirs(os.path.dirname(jpath) or ".", exist_ok=True)
            # re-stamp when the file vanished (the directory died and was
            # recreated mid-process): every journal FILE starts with a
            # manifest, not merely every process
            first = (jpath not in _journal_manifested
                     or not os.path.exists(jpath))
            sealed = False
            if first:
                try:
                    with open(jpath, "rb") as prev:
                        prev.seek(-1, os.SEEK_END)
                        sealed = prev.read(1) != b"\n"
                except (OSError, ValueError):
                    pass            # absent or empty: nothing to seal
            # graftlint: disable-next-line=GD007  append-only journal: one flushed JSON line per event, a torn last line is skipped on read
            with open(jpath, "a", encoding="utf-8") as f:
                if sealed:
                    f.write("\n")
                if first:
                    _journal_manifested.add(jpath)
                    f.write(json.dumps({
                        "ev": "manifest", "t": 0.0,
                        "run": {"schema": MANIFEST_SCHEMA, "journal": True,
                                "pid": os.getpid(),
                                "time_unix": time.time(),
                                "argv": sys.argv[:8]},
                    }, separators=(",", ":"), default=str) + "\n")
                f.write(json.dumps({
                    "ev": "journal", "t_unix": round(time.time(), 6),
                    "pid": os.getpid(), "op": op, **fields,
                }, separators=(",", ":"), default=str) + "\n")
                f.flush()
    except Exception as e:  # noqa: BLE001 — evidence must not kill the run
        log.warning("run journal append to %s failed: %s", jpath, e)


def validate_journal(path: str) -> tuple[list[dict], list[str]]:
    """Parse + schema-check a run journal. Returns ``(events, problems)`` —
    an empty ``problems`` list is a clean journal.

    Checks: parseable under the obs torn-line contract, a ``manifest``
    first, every ``journal`` event carries a known ``op`` + its required
    fields, and per-checkpoint save versions are strictly increasing
    (exactly-once: a requeued run never re-publishes an old version)."""
    from graphdyn_torch.resilience.hooks import read_ledger

    problems: list[str] = []
    try:
        events, torn = read_ledger(path)
    except (OSError, ValueError) as e:
        return [], [f"unreadable journal: {e}"]
    if torn:
        problems.append(f"{torn} torn line(s) (sealed seams are tolerated)")
    if not events or events[0].get("ev") != "manifest":
        problems.append("journal does not start with a manifest event")
    last_version: dict[str, int] = {}
    required = {
        "save": ("path", "version"),
        "load": ("path", "source", "verified"),
        "quarantine": ("path", "to", "reason"),
        "reject": ("path", "file", "reason"),
        "failover": ("path", "source"),
        "read-error": ("path", "file", "error"),
        "mirror.save": ("path", "version"),
        "mirror.degraded": ("path", "error"),
        "remove": ("path",),
        # the supervisor's restart-loop chapter (no checkpoint path: a
        # supervised run may not checkpoint at all)
        "supervise.start": ("argv",),
        "supervise.restart": ("episode", "rc", "kind"),
        "supervise.quarantine": ("site", "crashes"),
        # the JAX package's job-service chapter:
        # every spool transition is journalled, so "what happened to my
        # job" is answerable from the evidence trail alone
        "serve.submit": ("job", "tenant"),
        "serve.done": ("job", "tenant", "requeues"),
        "serve.refuse": ("job", "tenant", "reason"),
        "serve.requeue": ("job", "tenant", "requeues", "reason"),
        "serve.evict": ("job", "tenant", "requeues"),
        "serve.quarantine": ("job", "tenant", "site", "crashes"),
        # the streamed rollout's churn chapter (:mod:`graphdyn_torch.ops
        # .streamed`): every APPLIED mutation batch is recorded, so a
        # requeued run replays the identical churn from the journal alone
        "stream.churn": ("step", "seq", "adds", "drops"),
        # the JAX package's sharded streamed engine's repartition: hub promotions/demotions
        # decided at a chunk boundary — deterministic given the churn
        # history, journaled so replay re-derives the identical layout
        # even on a different shard count
        "stream.repartition": ("step", "seq", "promotes", "demotes"),
    }
    for i, ev in enumerate(events):
        kind = ev.get("ev")
        if kind == "manifest":
            continue
        if kind != "journal":
            problems.append(f"event {i}: unknown ev kind {kind!r}")
            continue
        op = ev.get("op")
        if op not in JOURNAL_OPS:
            problems.append(f"event {i}: unknown op {op!r}")
            continue
        for field in required[op]:
            if field not in ev:
                problems.append(f"event {i} ({op}): missing field {field!r}")
        if op == "save":
            p, v = ev.get("path", ""), int(ev.get("version", 0))
            if v <= last_version.get(p, 0):
                problems.append(
                    f"event {i}: save version {v} for {p!r} not above "
                    f"{last_version.get(p, 0)} — re-published version"
                )
            last_version[p] = max(last_version.get(p, 0), v)
    return events, problems


# ---------------------------------------------------------------------------
# write-behind mirror worker
# ---------------------------------------------------------------------------

_mirror_q: queue.Queue = queue.Queue()
_mirror_thread: threading.Thread | None = None
_mirror_thread_lock = threading.Lock()


def _mirror_worker() -> None:
    while True:
        job = _mirror_q.get()
        try:
            job()
        except Exception as e:  # noqa: BLE001 — a mirror is best-effort
            log.warning("mirror job failed: %s", e)
        finally:
            _mirror_q.task_done()


def _ensure_mirror_worker() -> None:
    global _mirror_thread
    with _mirror_thread_lock:
        if _mirror_thread is None or not _mirror_thread.is_alive():
            # graftrace: disable-next-line=GT003  daemon LOOP thread, never joined by design — the bounded close path is flush_mirror(timeout_s): it drains the queue (the thread's whole observable effect) under a deadline
            _mirror_thread = threading.Thread(
                target=_mirror_worker, name="graphdyn-ckpt-mirror",
                daemon=True,
            )
            _mirror_thread.start()


def flush_mirror(timeout_s: float | None = None) -> None:
    """Block until every enqueued mirror write has drained — called before
    any failover read, on remove, by tests that assert mirror state, and
    at interpreter exit (a run that saves and then returns must not drop
    its queued write-behind replicas on the floor — the whole point of the
    mirror is to survive exactly the runs that end abruptly).

    ``timeout_s`` bounds the wait (the atexit hook uses it: a mirror job
    wedged on a dead filesystem must not hang process shutdown forever —
    it is logged and abandoned instead)."""
    # gate on QUEUE state, not worker liveness (
    # the old worker-liveness read raced _ensure_mirror_worker's re-arm —
    # a save on another thread could enqueue between our check and our
    # return, and a liveness gate skips a queue with writes in flight).
    # unfinished_tasks only moves enqueue→drain, so a zero here means
    # every write that was enqueued before this call has drained.
    if not _mirror_q.unfinished_tasks:
        return
    # writes ARE in flight: make sure a live worker exists to drain them
    # (covers the enqueue-before-arm window, and a queue stranded by a
    # dead worker — re-arming is exactly what the next save would do)
    try:
        _ensure_mirror_worker()
    except RuntimeError:
        # interpreter shutdown can refuse new threads; nothing can drain
        log.warning(
            "mirror flush: cannot (re)start the worker with %d write(s) "
            "queued — abandoning them (mirror may be stale)",
            _mirror_q.unfinished_tasks,
        )
        return
    if timeout_s is None:
        _mirror_q.join()
        return
    deadline = time.monotonic() + timeout_s
    while _mirror_q.unfinished_tasks:
        if time.monotonic() >= deadline:
            log.warning(
                "mirror flush timed out after %.3gs with %d write(s) still "
                "queued — abandoning them (mirror may be stale)",
                timeout_s, _mirror_q.unfinished_tasks,
            )
            return
        # graftrace: disable-next-line=GT005  bounded drain poll, not synchronization: queue.Queue.join() has no timeout parameter, so the deadline-capped poll IS the bounded join
        time.sleep(0.02)


# registered unconditionally at import: a no-op when no mirror worker ever
# started, and the difference between "the mirror has every published save"
# and "the last few replicas silently vanished" when a run exits right
# after saving (regression-tested end to end in tests/test_store.py)
atexit.register(flush_mirror, timeout_s=10.0)


# ---------------------------------------------------------------------------
# the durable checkpoint
# ---------------------------------------------------------------------------


class DurableCheckpoint(Checkpoint):
    """:class:`graphdyn_torch.utils.io.Checkpoint` + the durability contract
    (module docstring): checksum-verified loads, keep-last-K retention with
    atomic promote, write-behind mirror failover, and the run journal.

    A ``Checkpoint`` subclass, so every call site — and every test that
    types ``Checkpoint`` — works unchanged; the published snapshot at
    ``<path>.npz`` keeps the plain checkpoint's format (plain ``Checkpoint`` reads
    it, and a plain-written snapshot loads here, just unverified).
    """

    def __init__(self, path: str, *, mirror=_UNSET, keep: int | None = None,
                 journal: bool = True):
        super().__init__(path)
        self._mirror = mirror           # _UNSET → follow CONFIG at call time
        self._keep = keep
        self._journal_enabled = journal

    # -- configuration ---------------------------------------------------

    def _mirror_base(self) -> str | None:
        m = CONFIG.mirror if self._mirror is _UNSET else self._mirror
        if not m:
            return None
        # one subdirectory per primary DIRECTORY (short digest of its
        # absolute path — stable across requeues of the same job): two jobs
        # pointing same-named checkpoints (runA/ck, runB/ck) at one shared
        # mirror would otherwise interleave version sequences, have each
        # job's retention prune the other's newest copies, and offer job
        # B's snapshot to job A on failover. The subdir also gives every
        # job its own mirror run_journal.jsonl (journal_path_for walks up
        # to the dirname).
        d = hashlib.sha256(
            os.path.abspath(os.path.dirname(self.path)).encode()
        ).hexdigest()[:8]
        return os.path.join(m, d, os.path.basename(self.path))

    def _keep_n(self) -> int:
        return max(1, self._keep if self._keep is not None else CONFIG.keep)

    def _journal(self, op: str, **fields) -> None:
        if not self._journal_enabled:
            return
        journal_event(journal_path_for(self.path), op,
                      path=self.path, **fields)
        mbase = self._mirror_base()
        if mbase is not None:
            journal_event(journal_path_for(mbase), op,
                          path=self.path, **fields)

    # -- version bookkeeping --------------------------------------------

    def _versions(self, base: str | None = None) -> list[tuple[int, str]]:
        """Retained ``(version, file)`` pairs for ``base`` (default: the
        primary path), newest first."""
        base = self.path if base is None else base
        out = []
        for f in glob.glob(glob.escape(base) + ".v*.npz"):
            m = _VERSION_RE.search(f)
            if m:
                out.append((int(m.group(1)), f))
        return sorted(out, reverse=True)

    def _next_version(self) -> int:
        """One above the newest retained version — consulting the MIRROR
        too: after a primary-directory death the requeued process sees an
        empty primary, and restarting at v1 would (a) make the surviving
        mirror journal read as a version regression and (b) let mirror
        retention prune the *newest* copies as "oldest". The sequence stays
        monotonic as long as any replica survives, which is the failover
        premise."""
        vs = [v for v, _ in self._versions()]
        mbase = self._mirror_base()
        if mbase is not None:
            vs += [v for v, _ in self._versions(mbase)]
        return (max(vs) + 1) if vs else 1

    def _prune(self, base: str | None = None) -> None:
        for v, f in self._versions(base)[self._keep_n():]:
            for p in (f, f[:-len(".npz")] + ".manifest.json"):
                try:
                    os.remove(p)
                except OSError:
                    pass

    # -- save: version → manifest → promote → retention → mirror ---------

    def _persist(self, payload: dict, meta: dict) -> None:
        # the makedirs / payload validation / checkpoint.write fault gate
        # already ran in the shared Checkpoint.save entry point — overriding
        # _persist (not save) keeps save-patching wrappers (the test
        # suite's abort-after-save fixture) watching durable writes too
        from graphdyn_torch.resilience import hooks as obs

        with obs.current().span("io.ckpt.write", path=self.path) as sp:
            version = self._next_version()
            vfile = f"{self.path}.v{version}.npz"
            _atomic_savez(vfile, payload)
            man = build_manifest(version, payload, meta, self._META_KEY)
            write_json_atomic(vfile[:-len(".npz")] + ".manifest.json", man)
            self._promote(vfile, man)
            self._prune()
            if obs.enabled():
                sp.set(bytes=int(os.path.getsize(vfile)), version=version)
        self._journal("save", version=version,
                      bytes=int(os.path.getsize(vfile)),
                      manifest_sha=man["manifest_sha256"][:16])
        self._mirror_save(version, vfile, man)

    def _promote(self, vfile: str, man: dict) -> None:
        """Publish ``vfile`` as the current ``<path>.npz``: one hard link +
        one atomic rename (the whole hot-path cost of retention), then the
        current manifest. A crash anywhere in between leaves the version
        file + its manifest intact — the load path's fallback scan finds
        it, so no window destroys the only good state."""
        tmp = self.path + ".promote.tmp.npz"
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
            os.link(vfile, tmp)
        except OSError:
            shutil.copyfile(vfile, tmp)     # filesystems without hard links
        os.replace(tmp, self.path + ".npz")
        write_json_atomic(self.path + ".manifest.json", man)

    def _mirror_save(self, version: int, vfile: str, man: dict) -> None:
        mbase = self._mirror_base()
        if mbase is None:
            return
        # the fault site is polled on the CALLER thread (fault plans are
        # thread-local) — an injected mirror ENOSPC degrades right here,
        # before anything is enqueued; the primary save above already
        # succeeded and the run proceeds
        spec = _faults.check_fault("mirror.write", key=self.path)
        if spec is not None:
            if spec.action == "preempt":
                raise _faults.InjectedPreemption(
                    f"injected preempt at mirror.write ({self.path})"
                )
            self._mirror_degraded(_faults.InjectedWriteError(mbase))
            return
        keep = self._keep_n()

        def job(vfile=vfile, man=man, mbase=mbase, version=version,
                keep=keep):
            try:
                self._do_mirror_copy(vfile, man, mbase, version, keep)
            except OSError as e:
                self._mirror_degraded(e)

        _ensure_mirror_worker()
        _mirror_q.put(job)

    def _do_mirror_copy(self, vfile: str, man: dict, mbase: str,
                        version: int, keep: int) -> None:
        # fault site on the WORKER thread (env-plan injectable: in-process
        # plans are thread-local and never reach here) — `stall` delays the
        # write-behind copy itself, the primitive a schedule
        # fuzzer uses to widen the flush-vs-exit race deterministically
        _faults.check_fault("mirror.copy", key=mbase)
        os.makedirs(os.path.dirname(mbase) or ".", exist_ok=True)
        mv = f"{mbase}.v{version}.npz"
        tmp = mv + ".tmp"
        shutil.copyfile(vfile, tmp)
        os.replace(tmp, mv)
        write_json_atomic(mv[:-len(".npz")] + ".manifest.json", man)
        ptmp = mbase + ".promote.tmp.npz"
        try:
            if os.path.exists(ptmp):
                os.remove(ptmp)
            os.link(mv, ptmp)
        except OSError:
            shutil.copyfile(mv, ptmp)
        os.replace(ptmp, mbase + ".npz")
        write_json_atomic(mbase + ".manifest.json", man)
        for v, f in self._versions(mbase)[keep:]:
            for p in (f, f[:-len(".npz")] + ".manifest.json"):
                try:
                    os.remove(p)
                except OSError:
                    pass
        self._journal("mirror.save", version=version)

    def _mirror_degraded(self, err: Exception) -> None:
        from graphdyn_torch.resilience import hooks as obs

        log.warning(
            "mirror replication for %s DEGRADED (%s: %s) — primary "
            "checkpoint is intact, the run continues unmirrored",
            self.path, type(err).__name__, err,
        )
        obs.counter("io.ckpt.mirror.degrade", path=self.path,
                    error=f"{type(err).__name__}: {err}"[:200])
        self._journal("mirror.degraded",
                      error=f"{type(err).__name__}: {err}"[:200])

    # -- load: verify → fall back → fail over ----------------------------

    def load(self):
        flush_mirror()
        cur = self.path + ".npz"
        cur_exists = os.path.exists(cur)
        if cur_exists:
            if _faults.transform_spec("checkpoint.read", "truncate",
                                      key=self.path) is not None:
                _faults.truncate_file(cur)
            if _faults.transform_spec("checkpoint.bitrot", "bitrot",
                                      key=self.path) is not None:
                _faults.flip_npz_bytes(cur)
        candidates: list[tuple[str, str, str]] = []
        if cur_exists:
            candidates.append(("primary", cur, self.path + ".manifest.json"))
        for v, f in self._versions():
            candidates.append(
                ("version", f, f[:-len(".npz")] + ".manifest.json"))
        mbase = self._mirror_base()
        if mbase is not None:
            if os.path.exists(mbase + ".npz"):
                candidates.append(
                    ("mirror", mbase + ".npz", mbase + ".manifest.json"))
            for v, f in self._versions(mbase):
                candidates.append(
                    ("mirror", f, f[:-len(".npz")] + ".manifest.json"))
        if not candidates:
            return None
        from graphdyn_torch.resilience import hooks as obs

        oserrors: list[OSError] = []
        structural = 0
        with obs.current().span("io.ckpt.read", path=self.path):
            for source, file, manfile in candidates:
                try:
                    arrays, meta = self._read_npz(file)
                    man = _read_manifest(manfile)
                    if man is not None:
                        verify_manifest(arrays, meta, man)
                        verified = True
                    elif source == "primary":
                        # manifest-less legacy/foreign snapshot: loadable,
                        # just unverified (format compatibility)
                        verified = False
                    else:
                        # a FALLBACK candidate exists to prevent a wrong
                        # resume — falling back to something unverifiable
                        # would defeat it
                        raise ChecksumError(
                            "fallback candidate has no manifest")
                except self._STRUCTURAL + (ChecksumError,) as e:
                    structural += 1
                    reason = f"{type(e).__name__}: {e}"[:200]
                    if source == "primary":
                        quarantine = self._quarantine_file(file)
                        log.warning(
                            "checkpoint at %s failed verification (%s) — "
                            "quarantined to %s, trying retained/mirror "
                            "fallbacks", file, reason, quarantine,
                        )
                        obs.counter("io.ckpt.quarantine", path=self.path,
                                    quarantine=quarantine, error=reason)
                        self._journal("quarantine", to=quarantine,
                                      reason=reason)
                    else:
                        log.warning(
                            "checkpoint fallback candidate %s rejected "
                            "(%s)", file, reason,
                        )
                        self._journal("reject", file=file, reason=reason)
                    continue
                except OSError as e:
                    oserrors.append(e)
                    self._journal("read-error", file=file,
                                  error=f"{type(e).__name__}: {e}"[:200])
                    continue
                self._journal("load", source=source, file=file,
                              verified=verified)
                if source != "primary":
                    log.warning(
                        "checkpoint FAILOVER for %s: resuming from %s "
                        "copy %s", self.path, source, file,
                    )
                    obs.counter("io.ckpt.failover", path=self.path,
                                source=source, file=file)
                    self._journal("failover", source=source, file=file)
                return arrays, meta
        if oserrors and not structural:
            # every candidate failed with a transient read error and none
            # was structurally bad: surface it — a disk blip must not
            # silently restart an hours-long run
            raise oserrors[0]
        return None

    # -- cleanup ---------------------------------------------------------

    def remove(self) -> None:
        """End-of-run cleanup: the published snapshot, temp files, every
        retained version + manifest, and the mirror's copies. Quarantined
        evidence (``.corrupt.<k>.npz``) is deliberately kept."""
        flush_mirror()
        removed = False
        bases = [self.path]
        mbase = self._mirror_base()
        if mbase is not None:
            bases.append(mbase)
        for base in bases:
            targets = [base + ".npz", base + ".tmp.npz",
                       base + ".promote.tmp.npz", base + ".manifest.json"]
            for v, f in self._versions(base):
                targets += [f, f[:-len(".npz")] + ".manifest.json",
                            f + ".tmp"]
            for p in targets:
                try:
                    os.remove(p)
                    removed = True
                except FileNotFoundError:
                    pass
        if removed:
            self._journal("remove")
