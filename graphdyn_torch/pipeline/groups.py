"""Group bookkeeping of the ensemble drivers (the port of
``graphdyn/pipeline/groups.py``).

:class:`GroupDriver` is the one implementation of what every ensemble
driver needs between its repetitions and groups: the resume prefix,
interval-gated snapshots, the ``rep.boundary`` fault site and the
graceful-shutdown poll.

- Snapshots carry the serial drivers' metadata (``run_id`` + ``next_rep``),
  so a checkpoint written by the serial path resumes under the grouped path
  and the other way round, and a resume may use another ``group_size``:
  each repetition depends only on ``seed + k``.
- The ``rep.boundary`` site and the shutdown poll fire once per repetition,
  in repetition order, at each group boundary: a fault plan written against
  the serial driver sees the same hits.
- Inside a group the chunks poll :func:`shutdown_requested`: a SIGTERM
  during a long group snapshots the completed prefix (``next_rep`` = the
  group's first repetition) and exits 75; the resumed run runs the
  interrupted group again from its start, bit for bit.
"""

from __future__ import annotations

from typing import Iterator

from graphdyn_torch import obs
from graphdyn_torch.resilience import faults as _faults
from graphdyn_torch.resilience.shutdown import (
    raise_if_requested,
    shutdown_requested,
)
from graphdyn_torch.resilience.supervisor import beat as _beat


def group_ranges(start: int, stop: int, size: int) -> Iterator[list[int]]:
    """Partition ``range(start, stop)`` into consecutive groups of at most
    ``size`` repetitions (the tail group may be shorter; the group runners
    pad it back to ``size`` with inactive rows)."""
    if size < 1:
        raise ValueError(f"group_size must be >= 1, got {size}")
    k = start
    while k < stop:
        ks = list(range(k, min(k + size, stop)))
        yield ks
        k = ks[-1] + 1


class GroupDriver:
    """Checkpoint/fault/shutdown bookkeeping for one ensemble run, grouped
    or serial (the serial drivers use it at each repetition boundary).

    ``payload()`` must return the driver's result-array dict (the completed
    prefix is what matters; rows past ``next_rep`` are garbage exactly as in
    the serial drivers). ``run_id`` is the identity dict stamped into every
    snapshot and validated on resume."""

    def __init__(self, checkpoint_path: str | None, interval_s: float,
                 run_id: dict, payload, sync=None):
        from graphdyn_torch.utils.io import PeriodicCheckpointer, open_checkpoint

        self.path = checkpoint_path
        self.run_id = run_id
        # the ranks of a mesh run (graphdyn_torch.parallel.mesh.WorldSync):
        # rank 0 writes, the shutdown polls are or-reduced
        self.sync = sync
        self.writer = sync is None or sync.writer
        self.payload = payload
        self.ck = open_checkpoint(checkpoint_path) if checkpoint_path else None
        self.pc = (
            PeriodicCheckpointer(checkpoint_path, interval_s=interval_s)
            if checkpoint_path else None
        )

    def resume_prefix(self):
        """(arrays, start_rep) from a validated snapshot, or None."""
        from graphdyn_torch.utils.io import load_resume_prefix

        if self.ck is None:
            return None
        return load_resume_prefix(self.ck, self.run_id)

    def resume_into(self, dest: dict) -> int:
        """Restore the completed-repetition prefix of a validated snapshot
        into the driver arrays (``dest`` is the payload dict — keys match
        by construction) and return the first repetition to run."""
        resumed = self.resume_prefix()
        if resumed is None:
            return 0
        arrays, start_rep = resumed
        for key, arr in dest.items():
            arr[:start_rep] = arrays[key][:start_rep]
        return start_rep

    def save_prefix(self, next_rep: int) -> None:
        """Snapshot the completed prefix now (a serial driver whose chain
        in flight raised :class:`ShutdownRequested` after saving itself)."""
        if self.pc is not None and self.writer:
            self.pc.save_now(self.payload(), {**self.run_id,
                                              "next_rep": next_rep})

    def _stop(self) -> bool:
        """A pending graceful shutdown, here or (with ``sync``) on any
        rank."""
        stop = shutdown_requested()
        return self.sync.any(stop)[0] if self.sync is not None else stop

    def _raise(self, where: str) -> None:
        from graphdyn_torch.resilience.shutdown import ShutdownRequested

        raise_if_requested(where=where)
        raise ShutdownRequested(None, where=where)

    def chunk_poll(self, next_rep: int) -> None:
        """Between device chunks of an in-flight group: heartbeat, then
        honor a pending graceful shutdown with a prefix snapshot (the group
        re-runs from ``next_rep`` on resume)."""
        _beat("chunk")
        if self._stop():
            obs.counter("resilience.shutdown", where="chunk",
                        next_rep=next_rep)
            self.save_prefix(next_rep)
            self._raise("chunk")

    def rep_boundary(self, k: int) -> None:
        """After repetition ``k``'s results land in the driver arrays:
        heartbeat, interval-gated snapshot, the ``rep.boundary`` fault
        site, and the shutdown poll — the serial drivers' exact
        per-repetition sequence. The heartbeat leads, so a snapshot that
        hangs (dead NFS) is itself a detectable stall."""
        _beat("rep")
        if self.path is not None and self.writer:
            # a serial-path run preempted mid-repetition leaves its chain
            # snapshot at <path>_chain<k>; this repetition is done (on
            # either path), so a stale file must go — a later serial run
            # on this checkpoint path would otherwise meet it
            from graphdyn_torch.utils.io import open_checkpoint

            open_checkpoint(f"{self.path}_chain{k}").remove()
        if self.pc is not None and self.writer:
            self.pc.maybe_save(self.payload(), {**self.run_id,
                                                "next_rep": k + 1})
        obs.counter("pipeline.rep.boundary", rep=k)
        _faults.maybe_fail("rep.boundary", key=f"rep={k}")
        if self._stop():
            obs.counter("resilience.shutdown", where="rep", next_rep=k + 1)
            self.save_prefix(k + 1)
            self._raise("rep")

    def finish(self) -> None:
        if self.ck is not None and self.writer:
            self.ck.remove()
