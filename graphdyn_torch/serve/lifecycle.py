"""Service lifecycle: boot → recover → warm → serve → drain (the port of
``graphdyn/serve/lifecycle.py``).

The one entry point behind ``python -m graphdyn_torch.serve`` and
``python -m graphdyn_torch serve run``. Boot order:

1. **recover**: any job a killed worker left ``running`` is requeued before
   anything else happens (the spool is the queue);
2. **warm**: the hottest fused shape classes among the pending jobs that
   admission admits (an oversized spec is refused by the byte model, never
   warmed), so the first job after a restart pays a bucket hit and, on the
   card, finds the kernel libraries loaded;
3. **serve**: the worker loop on the MAIN thread, the one consumer of the
   process-wide shutdown flag: a SIGTERM lands at the next chunk boundary,
   the in-flight job is requeued, and the process exits 75 for its
   supervisor to restart.

``max_jobs`` / ``idle_exit_s`` bound the loop for tests and the soak; a
production server passes neither and runs until preempted.
"""

from __future__ import annotations

import time

from graphdyn_torch.resilience.shutdown import (
    EX_TEMPFAIL,
    ShutdownRequested,
    shutdown_requested,
)
from graphdyn_torch.serve.bucketing import BucketCache
from graphdyn_torch.serve.spool import PENDING, Spool
from graphdyn_torch.serve.worker import Worker


def run_service(root: str, *, job_timeout_s: float | None = None,
                max_jobs: int | None = None,
                idle_exit_s: float | None = None,
                warm: bool = True, poll_s: float = 0.05, device=None,
                n_devices: int | None = None,
                cache: BucketCache | None = None) -> int:
    """Serve the spool at ``root`` on ``device`` (default CUDA; raises
    without one unless given ``device="cpu"``; ``n_devices`` as in
    :class:`~graphdyn_torch.serve.worker.Worker`); returns the process exit
    code (0 = drained or idle-exited cleanly, 75 = preempted mid-serve with
    the in-flight job requeued). ``cache``: a :class:`BucketCache` to serve
    from (default a fresh one)."""
    from graphdyn_torch import obs
    from graphdyn_torch.serve.admission import admit

    spool = Spool(root)
    worker = Worker(spool, cache=cache or BucketCache(),
                    default_timeout_s=job_timeout_s, poll_s=poll_s,
                    device=device, n_devices=n_devices)
    recovered = spool.recover()
    if recovered:
        obs.counter("serve.recovered", jobs=len(recovered))
    # warm only what admission admits: an oversized pending spec must be
    # refused by the byte model, not built by the warm-up
    pending = [r["spec"] for r in spool.jobs()
               if r["state"] == PENDING
               and admit(r["spec"], device=worker.device,
                         n_devices=worker.n_devices).admitted]
    if warm and pending:
        with obs.timed("serve.boot_warm", jobs=len(pending)):
            worker.cache.warm(pending, device=worker.device)
    served = 0
    idle_since = time.monotonic()
    try:
        while not shutdown_requested():
            if worker.step():
                served += 1
                idle_since = time.monotonic()
                if max_jobs is not None and served >= max_jobs:
                    return 0
                continue
            if idle_exit_s is not None and (
                    time.monotonic() - idle_since) >= idle_exit_s:
                return 0
            # idle poll of the durable queue between submissions (the spool
            # is a filesystem, there is no condition variable)
            # graftrace: disable-next-line=GT005  idle poll of the durable queue between submissions — the spool is a filesystem, there is no condition variable
            time.sleep(poll_s)
    except ShutdownRequested:
        # the in-flight job was requeued by the worker before the re-raise;
        # exit 75 tells the supervisor "restart me"
        return EX_TEMPFAIL
    return EX_TEMPFAIL
