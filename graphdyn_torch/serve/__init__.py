"""graphdyn_torch.serve: the always-on multi-tenant job service (the port
of ``graphdyn/serve/``, the same module names and public names).

A long-lived process accepts jobs, survives bad ones, and keeps one warm
device busy for every tenant:

- :mod:`~graphdyn_torch.serve.spool`: the durable filesystem job store
  (submit/status/result survive a server restart from disk alone);
- :mod:`~graphdyn_torch.serve.admission`: static byte-model admission: an
  oversized job is refused with a reason, never exhausts the card;
- :mod:`~graphdyn_torch.serve.bucketing`: shape classes with table reuse
  and a boot-time warm-up of the hot classes;
- :mod:`~graphdyn_torch.serve.worker`: the persistent worker loop: per-job
  timeout → eviction → requeue, per-tenant crash quarantine, heartbeats at
  job boundaries; fused jobs on K4′, bucketed and streamed jobs on KB;
- :mod:`~graphdyn_torch.serve.lifecycle`: boot/recover/drain behind
  ``python -m graphdyn_torch.serve`` and ``python -m graphdyn_torch serve``;
- :mod:`~graphdyn_torch.serve.api`: the thin client face over the spool.

The service runs on the card unless given ``device="cpu"``. The solvers are
imported inside functions: submitting a job touches no device.
"""

from graphdyn_torch.serve.spool import (  # noqa: F401
    DONE,
    PENDING,
    QUARANTINED,
    REFUSED,
    RUNNING,
    Spool,
    normalize_spec,
)
from graphdyn_torch.serve.admission import AdmissionDecision, admit  # noqa: F401
from graphdyn_torch.serve.bucketing import BucketCache, shape_key  # noqa: F401
from graphdyn_torch.serve.worker import Worker  # noqa: F401
from graphdyn_torch.serve.lifecycle import run_service  # noqa: F401
