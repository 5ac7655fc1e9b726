"""The persistent worker loop: every job wrapped in the robustness ladder
(the port of ``graphdyn/serve/worker.py``).

One job's journey:

1. **admission**: the byte models refuse an oversized shape with a reason
   before it touches the device (:mod:`graphdyn_torch.serve.admission`;
   the ``serve.admit`` fault site injects the reject storm);
2. **dispatch**: the ``serve.dispatch`` fault site models a transient
   failure in front of the device, retried with the seeded-backoff
   :class:`~graphdyn_torch.resilience.retry.RetryPolicy`, keyed per job so
   tenants' retries de-correlate; exhausted retries requeue the job;
3. **run**: the engine the admission priced, on the worker's device: the
   fused annealer (K4′ on the card), the degree-bucketed rollout (KB) or
   the streamed rollout (KB a chunk; with ``shards`` > 1 one process per
   shard, :func:`graphdyn_torch.scripts.halo_ranks.run_ranks`, NCCL a card
   each, gloo on the CPU), under a per-job deadline watchdog
   (:func:`~graphdyn_torch.resilience.supervisor.supervision`). Bucketed
   and streamed jobs first re-validate their declarations against the
   built graph (:class:`~graphdyn_torch.serve.admission.
   DeclaredShapeMismatch` refuses an under-declared job before any device
   work). A job that overstays its ``timeout_s`` is **evicted**: the
   durable store records the eviction and the job is requeued with a
   timeout escalated ×4. Replay is exact: a served result is a pure
   function of its spec;
4. **crash containment**: an organic exception is dumped to the flight
   recorder, counted per ``(tenant, site)`` and the job requeued, until the
   same tenant crashes the same site ``quarantine_after`` times and the
   job is quarantined (journal ``serve.quarantine``). A launch K4′ refuses
   (a grid that cannot be co-resident) is such a crash, at the site
   ``serve.job:fused_chunk``: the worker never reruns the job on the plain
   version;
5. **heartbeats** at every job boundary (``beat("serve.job")``).

The loop runs synchronously (:meth:`Worker.run_until_drained`, the service
main thread) or on the background thread ``graphdyn-serve-worker``
(:meth:`Worker.start` / :meth:`Worker.stop`), which sets the worker's CUDA
device for itself (the current device is per thread).
"""

from __future__ import annotations

import os
import threading
import time

from graphdyn_torch.resilience.faults import (
    InjectedFault,
    InjectedPreemption,
    InjectedUnavailable,
    maybe_fail,
)
from graphdyn_torch.resilience.retry import RetryPolicy
from graphdyn_torch.resilience.shutdown import (
    ShutdownRequested,
    clear_shutdown,
    raise_if_requested,
    shutdown_requested,
    shutdown_requests,
)
from graphdyn_torch.serve.admission import (
    DeclaredShapeMismatch,
    _device,
    admit,
    device_budget_bytes,
    device_count,
    devices_reason,
)
from graphdyn_torch.serve.bucketing import BucketCache, _sa_config
from graphdyn_torch.serve.spool import Spool

#: an evicted job's next attempt gets a longer slice: a deterministic
#: replay under the same timeout would evict forever
EVICT_TIMEOUT_ESCALATION = 4.0

#: same-(tenant, site) crashes before the job is quarantined
QUARANTINE_AFTER = 2

#: seconds a sharded job's ranks may take when the job has no timeout
SHARD_RANKS_TIMEOUT_S = 1800.0


def _random_spins(spec: dict, n: int):
    """The job's initial replicas: int8 ±1 ``[R, n]`` from its seed."""
    import numpy as np

    R = int(spec["replicas"])
    rng = np.random.default_rng(int(spec["seed"]))
    return (2 * rng.integers(0, 2, size=(R, n)) - 1).astype(np.int8)


def _rollout_payload(s, spec: dict, **extra) -> dict:
    import numpy as np

    return {"conf": s,
            "m_end": s.astype(np.float64).mean(axis=1),
            "steps": np.asarray(int(spec["max_sweeps"])),
            **{k: np.asarray(int(v)) for k, v in extra.items()}}


def _sharded_rank(rank: int, world: int, graph, words, steps: int,
                  rule: str, tie: str, budget: int, partition, seed: int,
                  device: str):
    """One rank of a sharded streamed job (run through ``run_ranks``):
    rank 0 returns the global words and the chunk count."""
    from graphdyn_torch.parallel.stream import sharded_streamed_rollout

    stats: dict = {}
    out = sharded_streamed_rollout(
        graph, words, steps, n_shards=world, rule=rule, tie=tie,
        device_budget_bytes=budget, partition=partition, seed=seed,
        stats_out=stats, device=device)
    return (out.numpy(), int(stats["chunks"])) if rank == 0 else None


class Worker:
    """The serve loop over one :class:`~graphdyn_torch.serve.spool.Spool`
    on ``device`` (default CUDA; raises without one unless given
    ``device="cpu"``). ``n_devices``: the devices a sharded job may span on
    the CPU (default 1; on the card every card of the host counts)."""

    def __init__(self, spool: Spool, *, cache: BucketCache | None = None,
                 retry: RetryPolicy | None = None,
                 quarantine_after: int = QUARANTINE_AFTER,
                 default_timeout_s: float | None = None,
                 poll_s: float = 0.05, device=None,
                 n_devices: int | None = None):
        from graphdyn_torch.utils.platform import resolve_device

        dev = self.device = _device(resolve_device(device))
        self.n_devices = device_count(dev, n_devices)
        # the budget read at boot: a card that cannot report its memory
        # fails here, not as a silent budget at the first job
        device_budget_bytes(dev)
        self.spool = spool
        self.default_timeout_s = default_timeout_s
        self.cache = cache or BucketCache()
        #: dispatch retry: seeded full jitter so tenants' retries
        #: de-correlate
        self.retry = retry or RetryPolicy(
            tries=3, base_delay_s=0.01, max_delay_s=0.1, jitter=True)
        self.quarantine_after = quarantine_after
        self.poll_s = poll_s
        #: (tenant, site) -> consecutive crash count (the quarantine key)
        self._crashes: dict = {}
        #: the running job's deadline watchdog (None without a timeout)
        self._job_watchdog = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- the background-thread face (bounded join in stop()) --------------

    def start(self) -> "Worker":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="graphdyn-serve-worker", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None

    def _loop(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            if not self.step():
                # drained: idle-wait for new submissions (the spool is a
                # filesystem, there is no condition variable to wait on)
                self._stop.wait(self.poll_s)

    # -- the synchronous face ---------------------------------------------

    def run_until_drained(self, *, max_jobs: int | None = None) -> int:
        """Process until the queue is empty (or ``max_jobs`` settled);
        returns the number of jobs that left the pending state."""
        done = 0
        while max_jobs is None or done < max_jobs:
            if not self.step():
                return done
            done += 1
        return done

    # -- one job ----------------------------------------------------------

    def step(self) -> bool:
        """Claim and settle one job (any terminal-or-requeued outcome
        counts as settled). False when the queue is drained. External
        preemption (SIGTERM, the server watchdog) re-raises after the
        in-flight job is safely requeued."""
        from graphdyn_torch.resilience.supervisor import beat

        rec = self.spool.claim()
        if rec is None:
            return False
        beat("serve.job")
        job_id, spec = rec["id"], rec["spec"]

        decision = admit(spec, key=job_id, device=self.device,
                         n_devices=self.n_devices)
        if not decision.admitted:
            self.spool.refuse(job_id, decision.reason or "refused")
            return True

        if not self._dispatch(job_id):
            self.spool.requeue(
                job_id, "dispatch retries exhausted (transient "
                "infrastructure failure in front of the device)")
            return True

        try:
            self._run_job(rec, decision.kernel)
        except DeclaredShapeMismatch as e:
            # the pre-dispatch validation: the built graph outgrew the
            # declaration's admitted byte model
            self.spool.refuse(job_id, str(e))
        except ShutdownRequested as e:
            self._on_shutdown(rec, e)
        except InjectedPreemption:
            # a hard kill is a hard kill: the record stays RUNNING on disk
            # and restart recovery requeues it, as after a SIGKILL
            raise
        except Exception as e:  # noqa: BLE001 — contained per tenant
            self._on_crash(rec, e)
        else:
            self.spool.finish(job_id)
        beat("serve.job")
        return True

    def _dispatch(self, job_id: str) -> bool:
        """The transient-failure seam in front of the device: retried with
        seeded backoff, keyed per job. True = dispatched."""
        delays = list(self.retry.delays(key=f"serve.dispatch:{job_id}"))
        for attempt in range(self.retry.tries):
            try:
                maybe_fail("serve.dispatch", key=job_id)
                return True
            except InjectedUnavailable:
                from graphdyn_torch import obs

                if attempt >= len(delays):
                    return False
                obs.counter("serve.dispatch_retry", job=job_id,
                            attempt=attempt + 1)
                # the retry policy's seeded backoff: the de-correlation
                # is the sleep
                # graftrace: disable-next-line=GT005  the retry policy's seeded backoff delay — the de-correlation IS the sleep
                time.sleep(delays[attempt])
        return False

    def _run_job(self, rec: dict, kernel: str) -> None:
        from graphdyn_torch import obs
        from graphdyn_torch.resilience.supervisor import supervision
        from graphdyn_torch.search.fused import fused_anneal
        from graphdyn_torch.utils.io import save_results_npz

        spec = rec["spec"]
        g, tables = self.cache.tables_for(spec)
        timeout = rec.get("timeout_s")
        if timeout is None:
            timeout = self.default_timeout_s
        # escalation: attempt k runs under timeout * 4^requeues so a
        # deterministic replay cannot evict forever
        if timeout is not None:
            timeout = float(timeout) * (
                EVICT_TIMEOUT_ESCALATION ** rec.get("requeues", 0))
        self._job_t0 = time.monotonic()
        self._job_timeout = timeout
        with supervision(None, timeout) as self._job_watchdog:
            with obs.timed("serve.job", job=rec["id"], tenant=rec["tenant"],
                           n=int(spec["n"]), replicas=int(spec["replicas"])):
                if kernel == "bucketed":
                    payload = self._run_bucketed(spec, g, tables)
                elif kernel == "streamed":
                    payload = self._run_streamed(spec, g)
                else:
                    res = fused_anneal(
                        g, _sa_config(spec), n_replicas=int(spec["replicas"]),
                        seed=int(spec["seed"]),
                        m_target=float(spec["m_target"]),
                        max_sweeps=int(spec["max_sweeps"]),
                        chunk_sweeps=int(spec["chunk_sweeps"]),
                        kernel=kernel, tables=tables, device=self.device,
                    )
                    payload = {
                        "conf": res.s, "mag_reached": res.mag_reached,
                        "m_end": res.m_end,
                        "steps_to_target": res.steps_to_target,
                    }
        if self._own_deadline_only():
            # the job's deadline fired after its last boundary: the job is
            # complete, and the flag it left is not a preemption
            clear_shutdown()
        save_results_npz(rec["result"], **payload)

    def _run_bucketed(self, spec: dict, g, buckets) -> dict:
        """One ``solver='bucketed'`` job: re-validate the declared edge
        count against the built graph's table, then roll KB for the sweep
        budget over the job's seeded replicas."""
        import torch

        from graphdyn_torch.obs.memband import bucketed_table_entries_bound
        from graphdyn_torch.ops.bucketed import bucketed_rollout_global
        from graphdyn_torch.ops.packed import pack_spins, unpack_spins

        n_edges = int(spec["edges"])
        bound = bucketed_table_entries_bound(g.n, n_edges)
        if buckets.table_entries > bound:
            raise DeclaredShapeMismatch(
                f"declared edges={n_edges} admit {bound} table entries "
                f"but the built graph needs {buckets.table_entries}: the "
                "job was under-priced at admission — resubmit with the "
                "real edge count")
        R = int(spec["replicas"])
        # packed and unpacked on the host: the card holds the words alone,
        # not the [n, R] spins and their packing temporaries (graftcost
        # measured ~200 MB of them at n = 8192 against a ~1.6 MB price)
        sp = pack_spins(torch.from_numpy(_random_spins(spec, g.n))).to(
            self.device)
        out = bucketed_rollout_global(
            g, sp, int(spec["max_sweeps"]), rule=str(spec["rule"]),
            tie=str(spec["tie"]), buckets=buckets)
        return _rollout_payload(unpack_spins(out.cpu(), R).numpy(), spec)

    def _run_streamed(self, spec: dict, g) -> dict:
        """One ``solver='streamed'`` job: re-validate the declared edges
        and dmax against the built graph, chunk it against the device
        budget, and stream the rollout (sharded over ``shards`` processes
        when declared)."""
        from graphdyn_torch.ops.packed import WORD, pack_spins, unpack_spins
        from graphdyn_torch.ops.streamed import (
            build_stream_plan,
            streamed_rollout,
        )

        n_edges = int(spec["edges"])
        if g.num_edges > n_edges:
            raise DeclaredShapeMismatch(
                f"declared edges={n_edges} but the built graph has "
                f"{g.num_edges}: the job was under-priced at admission — "
                "resubmit with the real edge count")
        declared_dmax = spec.get("dmax")
        if declared_dmax is not None and g.dmax > int(declared_dmax):
            raise DeclaredShapeMismatch(
                f"declared dmax={int(declared_dmax)} but the built graph "
                f"has dmax={g.dmax}: the admitted feasibility floor was "
                "under-priced — resubmit with the real hub degree")
        R = int(spec["replicas"])
        W = -(-R // WORD)
        budget = device_budget_bytes(self.device)
        shards = int(spec.get("shards", 1))
        if shards < 1:
            raise DeclaredShapeMismatch(
                f"malformed shards declaration shards={shards} "
                "(want an int >= 1)")
        sp = pack_spins(_random_spins(spec, g.n))
        if shards > 1:
            words, chunks = self._run_sharded(spec, g, sp, W, shards,
                                              budget)
        else:
            try:
                plan = build_stream_plan(g, W=W, device_budget_bytes=budget)
            except ValueError as e:
                # a hub the byte budget cannot hold even alone: the floor
                # at admission was under-declared
                raise DeclaredShapeMismatch(str(e)) from e
            stats: dict = {}
            words = streamed_rollout(
                g, sp, int(spec["max_sweeps"]), rule=str(spec["rule"]),
                tie=str(spec["tie"]), plan=plan, stats_out=stats,
                device=self.device)
            chunks = stats.get("chunks", plan.K)
        s = unpack_spins(words, R).cpu().numpy()
        return _rollout_payload(s, spec, chunks=chunks, shards=shards)

    def _run_sharded(self, spec: dict, g, sp, W: int, shards: int,
                     budget: int):
        """The sharded composition: the built shard plan must fit the
        per-shard price admission took (else the declaration under-priced
        the job), then ``shards`` processes run it, one device each.
        Returns rank 0's global words and the chunk count. A shutdown or
        the job's deadline during the ranks ends them and raises
        :class:`ShutdownRequested`: the job's replay is exact from its
        spec."""
        from graphdyn_torch.graphs import partition_graph
        from graphdyn_torch.parallel.stream import (
            build_shard_stream_plan,
            shard_plan_device_bytes,
        )
        from graphdyn_torch.scripts.halo_ranks import run_ranks

        if shards > self.n_devices:
            raise DeclaredShapeMismatch(devices_reason(shards,
                                                       self.n_devices))
        partition = partition_graph(g, shards, seed=int(spec["seed"]))
        try:
            plan = build_shard_stream_plan(g, W=W, partition=partition,
                                           device_budget_bytes=budget)
        except ValueError as e:
            raise DeclaredShapeMismatch(str(e)) from e
        peak = shard_plan_device_bytes(plan, W)
        if peak > budget:
            raise DeclaredShapeMismatch(
                f"built shard plan peaks at {peak} B per device, over the "
                f"{budget} B budget the per-shard model admitted — "
                "resubmit with the real shape")
        left = SHARD_RANKS_TIMEOUT_S
        if self._job_timeout is not None:
            left = self._job_timeout - (time.monotonic() - self._job_t0)
        try:
            res = run_ranks(
                _sharded_rank, shards, g, sp.numpy(), int(spec["max_sweeps"]),
                str(spec["rule"]), str(spec["tie"]), budget, partition,
                int(spec["seed"]), self.device.type,
                device=self.device.type, timeout=max(left, 1.0),
                stop=shutdown_requested)
        except RuntimeError:
            raise_if_requested(where="ranks")
            raise
        raise_if_requested(where="ranks")
        import torch

        words, chunks = res[0]
        return torch.from_numpy(words), chunks

    # -- ladder rungs ------------------------------------------------------

    def _own_deadline_only(self) -> bool:
        """True when the pending shutdown flag is the running job's own
        deadline and no one else's request (a signal, the server's
        ``--deadline`` or stall watchdog): only then is it the job's to
        clear."""
        wd = self._job_watchdog
        return (wd is not None and wd.deadline_fired
                and shutdown_requested() and shutdown_requests() == 1)

    def _on_shutdown(self, rec: dict, e: ShutdownRequested) -> None:
        """Disambiguate the one shutdown flag: the per-job deadline firing
        alone is an EVICTION (requeue, clear, keep serving); anything else
        is real preemption (requeue, re-raise: the server is being told to
        stop)."""
        elapsed = time.monotonic() - self._job_t0
        if self._own_deadline_only():
            self._evict(rec, elapsed)
            clear_shutdown()
            if shutdown_requested():     # pragma: no cover — signal raced
                raise e
            return
        self.spool.requeue(rec["id"], f"preempted at {e.where or 'chunk'} "
                           "boundary (server shutdown)")
        raise e

    def _evict(self, rec: dict, elapsed: float) -> None:
        """Checkpoint-eviction: the durable store records the eviction
        evidence (who, which attempt, the full replayable spec), the
        journal carries ``serve.evict``, and the job goes back to pending
        with an escalated slice."""
        import numpy as np

        from graphdyn_torch.resilience.store import (
            DurableCheckpoint,
            journal_event,
        )

        ck = DurableCheckpoint(
            os.path.join(self.spool.root, "evict", rec["id"]))
        ck.save(
            {"requeues": np.asarray(rec.get("requeues", 0)),
             "elapsed_s": np.asarray(elapsed)},
            {"job": rec["id"], "tenant": rec["tenant"],
             "spec": rec["spec"], "evicted": True},
        )
        journal_event(self.spool.journal, "serve.evict",
                      job=rec["id"], tenant=rec["tenant"],
                      requeues=rec.get("requeues", 0),
                      elapsed_s=round(elapsed, 3))
        self.spool.requeue(
            rec["id"], f"evicted after {elapsed:.3f}s (per-job timeout); "
            "replay is exact (counter-RNG chain)")

    def _on_crash(self, rec: dict, e: Exception) -> None:
        """Per-tenant crash containment: dump the post-mortem, count per
        (tenant, site), requeue below the bar, quarantine at it."""
        from graphdyn_torch.obs import flight

        site = f"serve.job:{type(e).__name__}"
        if isinstance(e, InjectedFault):
            site = "serve.job:injected"
        elif str(e).startswith("fused_chunk:"):
            # K4′ refused the launch (e.g. a grid that cannot be
            # co-resident): a crash of this job, never a plain rerun
            site = "serve.job:fused_chunk"
        flight.dump("exception", exc=e, site=site)
        key = (rec["tenant"], site)
        self._crashes[key] = self._crashes.get(key, 0) + 1
        crashes = self._crashes[key]
        if crashes >= self.quarantine_after:
            self.spool.quarantine(rec["id"], site, crashes)
            return
        self.spool.requeue(
            rec["id"], f"crash at {site} ({e}); attempt {crashes} of "
            f"{self.quarantine_after} before quarantine", crashed=True)
