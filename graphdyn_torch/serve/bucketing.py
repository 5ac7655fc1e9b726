"""Shape-class bucketing: one warm device serves many users (the port of
``graphdyn/serve/bucketing.py``).

Two costs stand between a submitted job and device sweeps: the host-side
table build (distance-2 coloring and LUT masks,
:func:`graphdyn_torch.ops.fused.build_fused_tables`, identical for every
job on the same graph) and the device's first use (the CUDA context and the
kernel libraries, :mod:`graphdyn_torch.ops.cuda_build`). This module
buckets jobs accordingly:

- the **table cache** is keyed by the full graph identity
  ``(solver, n, d, graph_seed, rule, tie[, gamma])``: a repeat job on the
  same graph skips the coloring entirely;
- the **shape class** ``(solver, n, d, rule, tie, W)`` names the jobs that
  run the same launches (``W`` is the replica axis after 32-per-word
  packing);
- the **warm-up** at boot runs one full-size chunk of the hottest fused
  classes among the recovered queue, so the first tenant job after a
  restart pays a bucket hit, and on the card finds the kernel libraries
  loaded and the context warm.

Hit and miss counts feed the ``serve.bucket`` obs counter.
"""

from __future__ import annotations

import threading


def graph_key(spec: dict) -> tuple:
    """Full graph identity, the table cache key. The solver leads (fused
    jobs build an RRG and fused tables, bucketed and streamed jobs a
    power-law graph), and power-law identities carry the exponent."""
    solver = str(spec.get("solver", "fused"))
    key = (solver, int(spec["n"]), int(spec["d"]), int(spec["graph_seed"]),
           str(spec["rule"]), str(spec["tie"]))
    if solver in ("bucketed", "streamed"):
        key += (float(spec.get("gamma", 2.5)),)
    return key


def shape_key(spec: dict) -> tuple:
    """The shape class: graph identity minus the seed, plus the packed
    replica word count."""
    from graphdyn_torch.ops.packed import WORD

    W = -(-int(spec["replicas"]) // WORD)
    return (str(spec.get("solver", "fused")), int(spec["n"]),
            int(spec["d"]), str(spec["rule"]), str(spec["tie"]), W)


def _sa_config(spec: dict):
    from graphdyn_torch.config import DynamicsConfig, SAConfig

    return SAConfig(dynamics=DynamicsConfig(
        p=1, c=1, rule=str(spec["rule"]), tie=str(spec["tie"])))


class BucketCache:
    """Graph + table cache with hit accounting. One per server; the worker
    thread and the boot-time warm-up share it under one lock."""

    def __init__(self, max_graphs: int = 32):
        self.max_graphs = max_graphs
        self._lock = threading.Lock()
        self._graphs: dict = {}     # graph_key -> (Graph, tables)
        self._hits = 0
        self._misses = 0

    def stats(self) -> dict:
        with self._lock:
            total = self._hits + self._misses
            return {
                "hits": self._hits, "misses": self._misses,
                "hit_rate": (self._hits / total) if total else None,
                "resident_graphs": len(self._graphs),
            }

    def tables_for(self, spec: dict):
        """``(graph, tables)`` for the job, cached per graph identity
        (``tables``: :class:`~graphdyn_torch.ops.fused.FusedTables` for
        fused jobs, :class:`~graphdyn_torch.graphs.DegreeBuckets` for
        bucketed ones, None for streamed ones). Insertion-ordered eviction
        keeps the resident set bounded."""
        from graphdyn_torch import obs

        gk = graph_key(spec)
        with self._lock:
            hit = gk in self._graphs
            if hit:
                self._hits += 1
                pair = self._graphs[gk]
            else:
                self._misses += 1
        obs.counter("serve.bucket", hit=int(hit), n=gk[1], d=gk[2])
        if hit:
            return pair
        pair = self._build(spec)
        with self._lock:
            while len(self._graphs) >= self.max_graphs:
                self._graphs.pop(next(iter(self._graphs)))
            self._graphs[gk] = pair
        return pair

    def _build(self, spec: dict):
        from graphdyn_torch import obs
        from graphdyn_torch.graphs import (
            degree_buckets,
            powerlaw_graph,
            random_regular_graph,
        )
        from graphdyn_torch.ops.fused import build_fused_tables

        solver = str(spec.get("solver", "fused"))
        n, d = int(spec["n"]), int(spec["d"])
        with obs.timed("serve.tables_build", n=n, d=d):
            if solver in ("bucketed", "streamed"):
                # a power-law realization (d = dmin, seeded); the bucketed
                # engine's tables are its degree-bucket layout, the streamed
                # engine's chunk plan depends on the job's W and is built
                # per job
                g = powerlaw_graph(n, gamma=float(spec.get("gamma", 2.5)),
                                   dmin=d, seed=int(spec["graph_seed"]))
                return g, (degree_buckets(g) if solver == "bucketed"
                           else None)
            g = random_regular_graph(n, d, seed=int(spec["graph_seed"]))
            # the COLORING seed is the graph's, not the job's: the tables
            # are shared by every job on this graph, so keying the coloring
            # off one job's chain seed would make a served result depend on
            # which tenant's job built the cache entry. The chain seed
            # stays the job's own, passed to fused_anneal directly
            tables = build_fused_tables(g, _sa_config(spec),
                                        seed=int(spec["graph_seed"]))
        return g, tables

    def warm(self, specs: list[dict], *, top_k: int = 2,
             device=None) -> list[tuple]:
        """Warm-up of the hottest fused shape classes in ``specs`` (the
        recovered queue at boot) on ``device`` (default CUDA; raises
        without one unless given ``device="cpu"``): build their tables and
        run one full-size chunk (the job's own ``chunk_sweeps``), which on
        the card loads the kernel libraries (K4′, K1/K2′; KB's too when a
        bucketed or streamed job is pending) and warms the context before
        the first tenant job. Returns the warmed class keys."""
        from collections import Counter

        from graphdyn_torch import obs
        from graphdyn_torch.search.fused import fused_anneal
        from graphdyn_torch.utils.platform import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda" and any(
                str(s.get("solver", "fused")) != "fused" for s in specs):
            # bucketed and streamed jobs launch KB: load its library now
            from graphdyn_torch.ops import bucketed_cuda

            bucketed_cuda._library()
        specs = [s for s in specs
                 if str(s.get("solver", "fused")) == "fused"]
        by_class = Counter(shape_key(s) for s in specs)
        warmed = []
        for cls, _ in by_class.most_common(top_k):
            probe = next(s for s in specs if shape_key(s) == cls)
            with obs.timed("serve.warmup", n=cls[1], d=cls[2]):
                g, tables = self.tables_for(probe)
                cs = int(probe["chunk_sweeps"])
                fused_anneal(
                    g, _sa_config(probe), n_replicas=int(probe["replicas"]),
                    seed=int(probe["seed"]), max_sweeps=cs,
                    chunk_sweeps=cs, kernel="auto", tables=tables,
                    device=dev,
                )
            warmed.append(cls)
        return warmed
