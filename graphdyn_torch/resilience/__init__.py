"""graphdyn_torch.resilience — durability for the long-running solvers (the
port of ``graphdyn/resilience``: the same names, exit codes, environment
variables and file formats, so a scheduler or supervisor set up for the JAX
package drives the port unchanged).

- :mod:`~graphdyn_torch.resilience.faults` — seedable fault injection at
  named sites (``GRAPHDYN_FAULT_PLAN``);
- :mod:`~graphdyn_torch.resilience.retry` — bounded backoff and the
  checkpoint-save budget (``--max-save-retries``);
- :mod:`~graphdyn_torch.resilience.shutdown` — SIGTERM → snapshot at the
  next boundary → exit 75;
- :mod:`~graphdyn_torch.resilience.supervisor` — heartbeats, the watchdog
  (``--stall-timeout``, ``--deadline``) and the restart loop
  (``run-supervised``, exit 86 on a crash loop);
- :mod:`~graphdyn_torch.resilience.store` — the durable checkpoint store
  (manifests, retained versions, the mirror, ``run_journal.jsonl``),
  exported lazily below;
- :mod:`~graphdyn_torch.resilience.hooks` — the telemetry hook: the
  layer's counters, gauges and spans go to :mod:`graphdyn_torch.obs`, its
  post-mortems to :mod:`graphdyn_torch.obs.flight`.
"""

from graphdyn_torch.resilience.faults import (  # noqa: F401
    FaultPlan,
    FaultSpec,
    InjectedFault,
    InjectedLoweringError,
    InjectedUnavailable,
    InjectedPreemption,
    InjectedWriteError,
    check_fault,
    current_plan,
    maybe_fail,
    transform_spec,
    truncate_file,
)
from graphdyn_torch.resilience.retry import (  # noqa: F401
    SAVE_RETRY,
    RetryPolicy,
    retry,
    set_save_retry,
)
from graphdyn_torch.resilience.shutdown import (  # noqa: F401
    EX_ABORT,
    EX_TEMPFAIL,
    ShutdownRequested,
    clear_shutdown,
    graceful_shutdown,
    raise_if_requested,
    request_shutdown,
    shutdown_requested,
)
from graphdyn_torch.resilience.supervisor import (  # noqa: F401
    EX_QUARANTINE,
    RestartPolicy,
    Watchdog,
    beat,
    last_beat,
    supervise,
    supervision,
)

# store.py imports graphdyn_torch.utils.io at module level, and utils.io imports
# THIS package — so the store surface is re-exported lazily (PEP 562): by
# the time anyone asks for these attributes, utils.io is fully initialized.
_STORE_EXPORTS = (
    "ChecksumError",
    "DurableCheckpoint",
    "StoreConfig",
    "configure_store",
    "flush_mirror",
    "validate_journal",
)


def __getattr__(name: str):
    if name in _STORE_EXPORTS:
        from graphdyn_torch.resilience import store as _store

        return getattr(_store, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )
