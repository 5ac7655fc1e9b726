"""The one hook through which the durability layer reports its events.

The checkpoint store, the retry loop, the fault plan and the supervisor
send their counters, gauges and spans to the port's telemetry
(:mod:`graphdyn_torch.obs`) through these names, and a crash, a stall or a
poisoned sweep writes a flight post-mortem (``obs_postmortem.jsonl``, or an
``obs.crash`` event in a live ledger) through :func:`dump`, as the JAX
package's durability layer does. :func:`read_ledger` is the JSONL reader of
the run journals and post-mortems.
"""

from __future__ import annotations

from graphdyn_torch.obs import (  # noqa: F401  (re-exports)
    counter,
    current,
    enabled,
    gauge,
)
from graphdyn_torch.obs.flight import POSTMORTEM_NAME, dump  # noqa: F401
from graphdyn_torch.obs.recorder import read_ledger  # noqa: F401
