"""The durable filesystem job spool — the serve queue that survives kills
(the port of ``graphdyn/serve/spool.py``: the same states, record fields,
job ids and journal ops, so either package reads the other's spool).

One JSON record per job under ``<root>/jobs/``, written atomically
(temp + ``os.replace`` through
:func:`graphdyn_torch.utils.io.write_json_atomic`), so a reader or a restarted server sees either the
old record or the new one, never a torn job. The spool IS the queue: a
server restarted against an existing root recovers every pending job from
disk alone, and any job left ``running`` by a killed worker is requeued on
recovery (the job's result is a pure function of its spec — the fused
chain's counter RNG makes a replayed job bit-exact, so requeue-from-zero
is exact resume).

Job state machine::

    pending ──claim──▶ running ──finish──▶ done
       ▲                  │
       │   requeue        │ evict (per-job timeout) /
       └──────────────────┤ requeue (dispatch retry exhausted, preempt,
                          │          crash below the quarantine bar)
                          ├──────▶ quarantined (N same-site crashes)
    pending ──refuse──▶ refused   (admission: byte model over budget)
    running ──refuse──▶ refused   (bucketed engine: built graph exceeds
                                   the declared edge count's admitted
                                   model — under-priced, never dispatched)

Every transition lands in the run journal (``run_journal.jsonl``,
:func:`graphdyn_torch.resilience.store.journal_event`) under the ``serve.*``
ops.
"""

from __future__ import annotations

import json
import os
import threading

from graphdyn_torch.resilience.store import JOURNAL_NAME, journal_event
from graphdyn_torch.utils.io import write_json_atomic

#: job states (the record's ``state`` field)
PENDING = "pending"
RUNNING = "running"
DONE = "done"
REFUSED = "refused"
QUARANTINED = "quarantined"

STATES = (PENDING, RUNNING, DONE, REFUSED, QUARANTINED)

#: job-record schema version, stamped in every record
SPOOL_SCHEMA = 1

#: spec defaults — a submitted spec is normalized ONCE at submit time, so
#: the on-disk record (not the server's code version) defines the job
SPEC_DEFAULTS: dict = {
    # 'fused' (the annealer on an RRG) or 'bucketed' (the degree-bucketed
    # packed rollout on a power-law graph — the edge-proportional engine;
    # graphdyn_torch.serve.admission prices each by the model of the program it
    # actually runs)
    "solver": "fused",
    "n": 64,
    "d": 3,                  # fused: RRG degree; bucketed: power-law dmin
    "graph_seed": 0,
    "seed": 0,
    "rule": "majority",
    "tie": "stay",
    "replicas": 32,
    "m_target": 0.9,
    "max_sweeps": 64,
    "chunk_sweeps": 16,
    # bucketed-solver declarations: 'edges' (REQUIRED for
    # solver='bucketed') prices admission with the edge-proportional byte
    # model, and the worker re-validates it against the built graph's
    # table before dispatch; 'gamma' is the power-law exponent of the
    # served graph. Both are inert on fused jobs — the fused annealer's
    # resident set is padded-dmax-bound whatever a tenant declares, so no
    # declaration can discount its price. ('degree_cv' is retained so
    # pre-existing on-disk records still parse; it no longer affects
    # admission.)
    "edges": None,
    "degree_cv": 0.0,
    "gamma": 2.5,
    # streamed-solver declaration: the worst hub degree, input to the
    # single-node-chunk feasibility floor (solver='streamed'; optional —
    # admission defaults to the min(n-1, edges) worst case). Worker-
    # validated against the built graph like 'edges'.
    "dmax": None,
    # streamed-solver shard count: the job is priced by the PER-SHARD
    # streamed_state_bytes model (each of S shards owns ~n/S nodes and
    # ~edges/S adjacency against its own device budget, so the admission
    # frontier scales ~S×); the worker re-validates the built shard
    # plan's double-buffered peak against that promise before any device
    # work, and refuses declarations exceeding the worker's device count.
    "shards": 1,
}


def normalize_spec(spec: dict) -> dict:
    """Fill defaults and reject unknown keys — the one spec parser, shared
    by submit (CLI/API) and the worker's replay path, so a record written
    by an older server still means the same job."""
    unknown = sorted(set(spec) - set(SPEC_DEFAULTS))
    if unknown:
        raise ValueError(
            f"unknown job spec key(s) {unknown}; known: "
            f"{sorted(SPEC_DEFAULTS)}"
        )
    out = dict(SPEC_DEFAULTS)
    out.update(spec)
    return out


class Spool:
    """The filesystem job store. All mutation goes through atomic
    whole-record replacement under one in-process lock; cross-process
    consumers (a status poll racing the worker) read consistent records by
    construction. One worker per spool root is the deployment contract —
    the restart-recovery path (not file locking) is what makes a killed
    worker's jobs safe."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.jobs_dir = os.path.join(self.root, "jobs")
        self.results_dir = os.path.join(self.root, "results")
        self.journal = os.path.join(self.root, JOURNAL_NAME)
        self._lock = threading.Lock()
        os.makedirs(self.jobs_dir, exist_ok=True)
        os.makedirs(self.results_dir, exist_ok=True)

    # -- paths ------------------------------------------------------------

    def record_path(self, job_id: str) -> str:
        return os.path.join(self.jobs_dir, job_id + ".json")

    def result_path(self, job_id: str) -> str:
        return os.path.join(self.results_dir, job_id + ".npz")

    # -- reads ------------------------------------------------------------

    def load(self, job_id: str) -> dict:
        with open(self.record_path(job_id), encoding="utf-8") as f:
            return json.load(f)

    def jobs(self) -> list[dict]:
        """Every job record, submit-ordered (ids embed the sequence)."""
        out = []
        for name in sorted(os.listdir(self.jobs_dir)):
            if name.endswith(".json"):
                out.append(self.load(name[:-len(".json")]))
        return out

    def counts(self) -> dict:
        c: dict = {s: 0 for s in STATES}
        for rec in self.jobs():
            c[rec["state"]] = c.get(rec["state"], 0) + 1
        return c

    # -- transitions ------------------------------------------------------

    def _write(self, rec: dict) -> None:
        write_json_atomic(self.record_path(rec["id"]), rec, indent=1)

    def submit(self, spec: dict, tenant: str, *,
               timeout_s: float | None = None) -> str:
        """Durably enqueue one job; returns its id. The record on disk is
        the submission — a server that boots later serves it."""
        spec = normalize_spec(spec)
        with self._lock:
            seqs = [int(n[1:7]) for n in os.listdir(self.jobs_dir)
                    if n.endswith(".json") and n[1:7].isdigit()]
            job_id = f"j{(max(seqs) + 1 if seqs else 1):06d}-{tenant}"
            self._write({
                "schema": SPOOL_SCHEMA, "id": job_id, "tenant": tenant,
                "state": PENDING, "spec": spec,
                "timeout_s": timeout_s, "requeues": 0, "crashes": 0,
                "reason": None, "result": self.result_path(job_id),
            })
        journal_event(self.journal, "serve.submit",
                      job=job_id, tenant=tenant)
        return job_id

    def claim(self) -> dict | None:
        """Lowest-id pending job → running, or None when drained."""
        with self._lock:
            for rec in self.jobs():
                if rec["state"] == PENDING:
                    rec["state"] = RUNNING
                    self._write(rec)
                    return rec
        return None

    def _transition(self, job_id: str, state: str, *, reason=None,
                    bump_requeues=False, bump_crashes=False) -> dict:
        with self._lock:
            rec = self.load(job_id)
            rec["state"] = state
            if reason is not None:
                rec["reason"] = reason
            if bump_requeues:
                rec["requeues"] += 1
            if bump_crashes:
                rec["crashes"] += 1
            self._write(rec)
            return rec

    def finish(self, job_id: str) -> dict:
        rec = self._transition(job_id, DONE)
        journal_event(self.journal, "serve.done",
                      job=job_id, tenant=rec["tenant"],
                      requeues=rec["requeues"])
        return rec

    def refuse(self, job_id: str, reason: str) -> dict:
        rec = self._transition(job_id, REFUSED, reason=reason)
        journal_event(self.journal, "serve.refuse",
                      job=job_id, tenant=rec["tenant"], reason=reason)
        return rec

    def requeue(self, job_id: str, reason: str, *,
                crashed: bool = False) -> dict:
        rec = self._transition(job_id, PENDING, reason=reason,
                               bump_requeues=True, bump_crashes=crashed)
        journal_event(self.journal, "serve.requeue",
                      job=job_id, tenant=rec["tenant"],
                      requeues=rec["requeues"], reason=reason)
        return rec

    def quarantine(self, job_id: str, site: str, crashes: int) -> dict:
        rec = self._transition(
            job_id, QUARANTINED,
            reason=f"{crashes} crash(es) at {site}")
        journal_event(self.journal, "serve.quarantine",
                      job=job_id, tenant=rec["tenant"],
                      site=site, crashes=crashes)
        return rec

    # -- restart recovery --------------------------------------------------

    def recover(self) -> list[str]:
        """Requeue every job a killed worker left ``running`` — the boot
        path of a restarted server. Returns the requeued ids."""
        requeued = []
        for rec in self.jobs():
            if rec["state"] == RUNNING:
                self.requeue(rec["id"],
                             "recovered: worker died while running")
                requeued.append(rec["id"])
        return requeued
