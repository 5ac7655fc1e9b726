"""The client face of the service: submit / status / queue / result over
the spool (the port of ``graphdyn/serve/api.py``).

A library over the durable spool rather than a socket protocol: the
filesystem is the API surface (atomic whole-record reads, the run journal
as the audit log), so a client needs no live server to submit: jobs
enqueued against a dead server are served the moment one boots. Nothing
here touches a device: submitting a job does not initialise CUDA.
"""

from __future__ import annotations

import os

from graphdyn_torch.serve.spool import DONE, Spool


def submit(root: str, spec: dict, tenant: str = "default", *,
           timeout_s: float | None = None) -> str:
    """Durably enqueue one job; returns its id (usable at once for
    :func:`status` / :func:`result`, even before any server boots)."""
    return Spool(root).submit(spec, tenant, timeout_s=timeout_s)


def status(root: str, job_id: str) -> dict:
    """The job's full record: state, spec, requeue and crash counts, and
    the reason of any refusal, requeue or quarantine."""
    return Spool(root).load(job_id)


def queue(root: str) -> dict:
    """Queue-depth summary: job counts per state."""
    return Spool(root).counts()


def result(root: str, job_id: str) -> dict:
    """The finished job's arrays (fused: ``conf``, ``m_end``,
    ``mag_reached``, ``steps_to_target``; bucketed and streamed: ``conf``,
    ``m_end``, ``steps`` and, streamed, ``chunks`` and ``shards``). Raises
    if the job is not done; the record's state and reason say why."""
    from graphdyn_torch.utils.io import load_results_npz

    rec = Spool(root).load(job_id)
    if rec["state"] != DONE:
        raise RuntimeError(
            f"job {job_id} is {rec['state']!r}, not done"
            + (f" (reason: {rec['reason']})" if rec.get("reason") else ""))
    path = rec["result"]
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"job {job_id} is done but its result file is missing: {path}")
    return load_results_npz(path)
