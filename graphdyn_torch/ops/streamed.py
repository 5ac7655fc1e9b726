"""Out-of-core streamed rollout: graphs larger than device memory, and live
edge churn (the port of ``graphdyn/ops/streamed.py``).

The node axis is cut into host-resident **chunks**. The packed state lives
in host memory (pinned pages when the chunks step on the card); each
synchronous step walks the chunks in order, and only the active chunk's
state slab and tables are on the device. While the card steps chunk ``c``,
a :class:`graphdyn_torch.pipeline.prefetch.HostPrefetcher` thread gathers
chunk ``c+1``'s slab on the host and copies it and its tables to the card on
a second CUDA stream; an event orders the copy before the step.
``prefetch_depth=0`` makes every gather and copy synchronous (the overlap
baseline).

Each chunk's step is one launch of the bucketed step kernel KB
(:mod:`graphdyn_torch.ops.bucketed_cuda`) on the chunk's slab-local table,
the counterpart of the JAX package's ``_stream_chunk_device``; on the CPU
the plain version (:class:`graphdyn_torch.ops.bucketed.PlainBucketStep`)
runs. Integer popcounts are exact, so the rollout equals
``packed_rollout`` and ``bucketed_rollout_global`` on the same graph, bit
for bit.

Churn (:class:`ChurnBatch`) edits the adjacency at the step boundary and
rebuilds only the touched chunks. With ``checkpoint_path`` every applied
batch is journaled (``stream.churn`` in ``run_journal.jsonl``, the JAX
package's record) and the state ``(sp, t, seq)`` is snapshotted between
steps; a resumed run replays the journaled churn for the steps it already
took from the journal alone, then goes on, so it equals the uninterrupted
run bit for bit. Telemetry, the JAX package's: a ``stream.step`` span per
step (closed after the chunks' words are back on the host), the
``stream.h2d_bytes``/``stream.d2h_bytes`` gauges, the ``stream.resume``
counter and the ``stream.overlap_util`` gauge. ``build_stream_plan(
partition=)`` returns the sharded plan of :mod:`graphdyn_torch.parallel.
stream`, whose :func:`~graphdyn_torch.parallel.stream.
sharded_streamed_rollout` walks one shard per rank.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from graphdyn_torch import obs
from graphdyn_torch.graphs import Graph, degree_buckets
from graphdyn_torch.ops import bucketed_cuda
from graphdyn_torch.ops.bucketed import PlainBucketStep
from graphdyn_torch.pipeline.prefetch import HostPrefetcher
from graphdyn_torch.utils.platform import resolve_device

__all__ = [
    "StreamChunk", "StreamPlan", "ChurnBatch", "build_stream_plan",
    "chunk_device_bytes", "plan_device_bytes", "streamed_chunk_bytes",
    "streamed_min_bytes", "streamed_rollout", "seeded_churn",
]


def _pow2_width(dmax: int) -> int:
    """The padded slot width of a chunk of max degree ``dmax``: the
    :func:`~graphdyn_torch.graphs.degree_buckets` power of two (degrees 0
    and 1 share width 1; widths ≥ 64 are multiples of 32)."""
    return 1 << int(max(int(dmax) - 1, 0)).bit_length()


class StreamChunk(NamedTuple):
    """One host-resident chunk of the node axis (host numpy).

    The chunk owns ``nodes``; its device working set is the slab, the state
    rows of ``gids`` (owned nodes and their neighbors, sorted) plus a ghost
    zero row at local index ``len(gids)``. ``nbr_loc`` indexes the slab
    (ghost-padded), ``self_loc`` maps each owned node to its slab row.

    Attributes:
      nodes:    int64[C] owned global node ids.
      gids:     int64[M] global ids the slab carries (sorted).
      nbr_loc:  int32[C, w] slab-local neighbor table, ghost = M.
      deg:      int32[C] true degrees of the owned nodes.
      self_loc: int32[C] slab row of each owned node.
    """

    nodes: np.ndarray
    gids: np.ndarray
    nbr_loc: np.ndarray
    deg: np.ndarray
    self_loc: np.ndarray

    @property
    def C(self) -> int:
        return self.nodes.size

    @property
    def M(self) -> int:
        return self.gids.size

    @property
    def width(self) -> int:
        return self.nbr_loc.shape[1]


class StreamPlan(NamedTuple):
    """The chunked layout of one graph: every node owned by one chunk
    (``chunk_of[i]``), chunks walked in order each step."""

    n: int
    chunks: tuple
    chunk_of: np.ndarray

    @property
    def K(self) -> int:
        return len(self.chunks)


def streamed_chunk_bytes(C: int, M: int, width: int, W: int) -> int:
    """Device bytes of one streamed chunk's step: the slab ``uint32[M+1,
    W]``, the table ``int32[C, width]``, the degree and self-row vectors
    (``8·C``) and the ``[C, W]`` output (``graphdyn/obs/memband.py:
    streamed_chunk_bytes``)."""
    # graftlint: disable-next-line=GD016  the streamed chunk model that obs/memband and serve admission price with; graftcost holds it to the card's allocator peak
    return 4 * (M + 1) * W + 4 * C * width + 8 * C + 4 * C * W


def streamed_min_bytes(dmax: int, W: int) -> int:
    """The feasibility floor of the streamed layout: the bytes of a
    one-node chunk holding the worst hub (slab of ``2 + dmax`` rows, one
    padded table row). Double-buffered, twice this must fit a budget."""
    width = 1 << max(int(dmax) - 1, 0).bit_length()
    return streamed_chunk_bytes(1, 1 + dmax, width, W)


#: the ops-side name of :func:`streamed_chunk_bytes`, as the JAX package
#: keeps both: the model the budget mode of :func:`build_stream_plan` packs
#: against
chunk_device_bytes = streamed_chunk_bytes


def plan_device_bytes(plan: StreamPlan, W: int) -> int:
    """Peak modelled device bytes of the plan: the two largest chunks
    resident at once (the active one and the prefetched one)."""
    per = sorted(
        (chunk_device_bytes(c.C, c.M, c.width, W) for c in plan.chunks),
        reverse=True,
    )
    return sum(per[:2]) if len(per) > 1 else (per[0] if per else 0)


def _adjacency_lists(graph: Graph) -> list[np.ndarray]:
    """Per-node sorted neighbor id arrays from the padded table."""
    return [
        np.sort(graph.nbr[i, : graph.deg[i]].astype(np.int64))
        for i in range(graph.n)
    ]


def _build_chunk(nodes: np.ndarray, adj: list[np.ndarray]) -> StreamChunk:
    """Materialize one chunk's slab-local tables from the adjacency."""
    nodes = np.asarray(nodes, np.int64)
    degs = np.array([adj[i].size for i in nodes], np.int64)
    width = _pow2_width(int(degs.max()) if nodes.size else 0)
    nbr_cat = (np.concatenate([adj[i] for i in nodes])
               if nodes.size else np.empty(0, np.int64))
    gids = np.unique(np.concatenate([nodes, nbr_cat]))
    M = gids.size
    self_loc = np.searchsorted(gids, nodes)
    nbr_loc = np.full((nodes.size, width), M, np.int64)
    if nbr_cat.size:
        loc_cat = np.searchsorted(gids, nbr_cat)
        pos = 0
        for r, d in enumerate(degs):
            nbr_loc[r, :d] = loc_cat[pos:pos + d]
            pos += d
    return StreamChunk(
        nodes=nodes, gids=gids,
        nbr_loc=nbr_loc.astype(np.int32),
        deg=degs.astype(np.int32),
        self_loc=self_loc.astype(np.int32),
    )


def _split_stream_groups(order: np.ndarray, adj: list[np.ndarray], *,
                         W: int, n_chunks: int | None = None,
                         device_budget_bytes: int | None = None,
                         n_total: int | None = None) -> list[np.ndarray]:
    """Split ``order`` (degree-ascending node ids) into contiguous groups:
    ``n_chunks`` equal slices, or greedily packed against half of
    ``device_budget_bytes`` (two chunks resident at once)."""
    if (n_chunks is None) == (device_budget_bytes is None):
        raise ValueError(
            "pass exactly one of n_chunks or device_budget_bytes"
        )
    order = np.asarray(order, np.int64)
    if n_total is None:
        n_total = order.size
    groups: list[np.ndarray] = []
    if n_chunks is not None:
        if not 1 <= n_chunks <= max(n_total, 1):
            raise ValueError(
                f"n_chunks must be in [1, {n_total}], got {n_chunks}"
            )
        parts = min(n_chunks, max(order.size, 1))
        groups = [g for g in np.array_split(order, parts) if g.size]
    else:
        half = device_budget_bytes // 2
        cur: list[int] = []
        c = deg_sum = 0
        for i in order:
            d = adj[i].size
            # degrees ascend along the walk, so the newest node's width
            # bounds the whole candidate block
            w = _pow2_width(d)
            est = chunk_device_bytes(
                c + 1, (c + 1) + deg_sum + d, w, W)
            if cur and est > half:
                groups.append(np.asarray(cur, np.int64))
                cur, c, deg_sum = [], 0, 0
                est = chunk_device_bytes(1, 1 + d, w, W)
            if est > half:
                raise ValueError(
                    f"node {int(i)} (degree {d}) alone needs {est} B — "
                    f"over half the {device_budget_bytes} B device "
                    f"budget; the graph cannot be streamed at W={W}"
                )
            cur.append(int(i))
            c += 1
            deg_sum += d
        if cur:
            groups.append(np.asarray(cur, np.int64))
    return groups


def build_stream_plan(graph: Graph, *, W: int, n_chunks: int | None = None,
                      device_budget_bytes: int | None = None,
                      adj: list[np.ndarray] | None = None,
                      partition=None) -> StreamPlan:
    """Partition the node axis into host-resident chunks, walking the
    nodes in :func:`~graphdyn_torch.graphs.degree_buckets` order (degree
    ascending) so each chunk's padded width is tight. Exactly one of
    ``n_chunks`` (equal contiguous slices) or ``device_budget_bytes``
    (greedy: a chunk closes when its modelled bytes, with the slab bound
    ``M ≤ C + Σdeg``, would pass half the budget) must be given; a node
    that cannot fit alone raises. ``partition=`` (a
    :class:`~graphdyn_torch.graphs.Partition`) returns the sharded plan
    instead (:func:`graphdyn_torch.parallel.stream.build_shard_stream_plan`:
    each shard owns a part-major run of chunks, ``n_chunks`` / the budget
    per shard)."""
    if partition is not None:
        from graphdyn_torch.parallel.stream import build_shard_stream_plan

        return build_shard_stream_plan(
            graph, W=W, partition=partition, n_chunks=n_chunks,
            device_budget_bytes=device_budget_bytes, adj=adj)
    if adj is None:
        adj = _adjacency_lists(graph)
    order = degree_buckets(graph).order
    groups = _split_stream_groups(
        order, adj, W=W, n_chunks=n_chunks,
        device_budget_bytes=device_budget_bytes, n_total=graph.n,
    )
    chunks = tuple(_build_chunk(g, adj) for g in groups)
    chunk_of = np.empty(graph.n, np.int32)
    for k, ch in enumerate(chunks):
        chunk_of[ch.nodes] = k
    return StreamPlan(n=graph.n, chunks=chunks, chunk_of=chunk_of)


# ---------------------------------------------------------------------------
# the mutation stream: live edge churn at step boundaries
# ---------------------------------------------------------------------------


class ChurnBatch(NamedTuple):
    """One batch of edge mutations applied at the boundary before step
    ``step`` (0-based): ``drops`` leave first, then ``adds`` arrive. Both
    are int ``[k, 2]`` endpoint arrays; drops of absent edges and adds of
    present edges or self-loops are filtered out."""

    step: int
    adds: np.ndarray
    drops: np.ndarray


def seeded_churn(n: int, steps: int, *, rate: float,
                 seed: int) -> list[ChurnBatch]:
    """A deterministic churn schedule, pure in ``(n, steps, rate, seed)``:
    per step, ``Poisson(rate/2)`` candidate arrivals and departures over
    uniform node pairs (the JAX package's draws, in the same order)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        ka = int(rng.poisson(rate / 2.0))
        kd = int(rng.poisson(rate / 2.0))
        adds = rng.integers(0, n, size=(ka, 2), dtype=np.int64)
        drops = rng.integers(0, n, size=(kd, 2), dtype=np.int64)
        if ka or kd:
            out.append(ChurnBatch(step=t, adds=adds, drops=drops))
    return out


class _Adjacency:
    """Mutable per-node neighbor sets over a base graph: the live
    adjacency the churn edits. ``apply`` filters a batch to the mutations
    that change the graph and returns them with the touched nodes."""

    def __init__(self, graph: Graph):
        self.n = graph.n
        self._sets = [
            set(graph.nbr[i, : graph.deg[i]].astype(int).tolist())
            for i in range(graph.n)
        ]

    def apply(self, adds, drops):
        applied_drops, applied_adds = [], []
        touched: set[int] = set()
        for u, v in np.asarray(drops, np.int64).reshape(-1, 2):
            u, v = int(u), int(v)
            if u == v or v not in self._sets[u]:
                continue
            self._sets[u].discard(v)
            self._sets[v].discard(u)
            applied_drops.append((min(u, v), max(u, v)))
            touched.update((u, v))
        for u, v in np.asarray(adds, np.int64).reshape(-1, 2):
            u, v = int(u), int(v)
            if u == v or v in self._sets[u]:
                continue
            self._sets[u].add(v)
            self._sets[v].add(u)
            applied_adds.append((min(u, v), max(u, v)))
            touched.update((u, v))
        return applied_adds, applied_drops, touched

    def neighbor_lists(self) -> list[np.ndarray]:
        return [
            np.fromiter(sorted(s), np.int64, len(s)) for s in self._sets
        ]


def _rebuild_touched(plan: StreamPlan, adj_lists: list[np.ndarray],
                     touched: set[int]) -> StreamPlan:
    """Rebuild only the chunks that own a touched node (ownership never
    moves under churn)."""
    dirty = {int(plan.chunk_of[i]) for i in touched}
    chunks = tuple(
        _build_chunk(ch.nodes, adj_lists) if k in dirty else ch
        for k, ch in enumerate(plan.chunks)
    )
    return StreamPlan(n=plan.n, chunks=chunks, chunk_of=plan.chunk_of)


# ---------------------------------------------------------------------------
# the streamed rollout
# ---------------------------------------------------------------------------


class _ChunkStepper:
    """The per-chunk step on one device. On the card: the chunk's tables
    (pinned host copies, kept per chunk object) and its slab, gathered on
    the host into pinned memory, are copied on a copy stream; the item
    carries the event the step waits on. On the CPU: the plain version."""

    def __init__(self, device: torch.device, rule: str, tie: str):
        self.dev, self.rule, self.tie = device, rule, tie
        self.cuda = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self._tables: dict[int, tuple] = {}
        self._launches: dict[int, tuple] = {}

    def _host_tables(self, k: int, ch: StreamChunk):
        got = self._tables.get(k)
        if got is None or got[0] is not ch:
            ts = tuple(torch.from_numpy(a) for a in (ch.nbr_loc, ch.deg,
                                                     ch.self_loc))
            if self.cuda:
                ts = tuple(t.pin_memory() for t in ts)
            got = (ch, ts)
            self._tables[k] = got
        return got[1]

    def build(self, sp: torch.Tensor, k: int, ch: StreamChunk):
        """Gather chunk ``k``'s slab from the host state ``sp`` and stage
        it with its tables; returns ``(tensors, event, nbytes)``."""
        W = sp.shape[1]
        tabs = self._host_tables(k, ch)
        slab = torch.empty((ch.M + 1, W), dtype=torch.int32,
                           pin_memory=self.cuda)
        torch.index_select(sp, 0, torch.from_numpy(ch.gids), out=slab[:-1])
        slab[-1] = 0
        host = (*tabs, slab)
        # graftlint: disable-next-line=GD016  measured h2d traffic gauge over the arrays actually staged, not a predictive byte model
        nbytes = sum(t.numel() * t.element_size() for t in host)
        if not self.cuda:
            return host, None, nbytes, k, ch
        with torch.cuda.device(self.dev), torch.cuda.stream(self.copy_stream):
            dev = tuple(t.to(self.dev, non_blocking=True) for t in host)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        return dev, event, nbytes, k, ch

    def _launch(self, k: int, ch: StreamChunk, segment, slab, out):
        """Chunk ``k``'s KB launch, made at its first step and pointed at
        each step's copies of its tables after that."""
        got = self._launches.get(k)
        if got is not None and got[0] is ch and got[1].W == slab.shape[1]:
            got[1].rebind([segment])
        else:
            got = (ch, bucketed_cuda.Launch(
                [segment], W=slab.shape[1], src_rows=slab.shape[0],
                dst_rows=out.shape[0], device=slab.device, rule=self.rule,
                tie=self.tie, aligned=bucketed_cuda.aligned16(slab, out),
                check_tables=False))
            self._launches[k] = got
        got[1].check(slab, out)
        return got[1]

    def step(self, item) -> torch.Tensor:
        """One chunk step on the staged item; returns its ``[C, W]`` words
        on the host."""
        (nbr, deg, self_loc, slab), event, _, k, ch = item
        if not self.cuda:
            return PlainBucketStep(nbr, deg, self.rule, self.tie)(
                slab, slab.index_select(0, self_loc.long()))
        cur = torch.cuda.current_stream(self.dev)
        cur.wait_event(event)
        for t in (nbr, deg, self_loc, slab):
            t.record_stream(cur)
        out = torch.empty((nbr.shape[0], slab.shape[1]), dtype=torch.int32,
                          device=self.dev)
        self._launch(k, ch, (nbr, deg, self_loc, 0), slab, out)(slab, out)
        return out.cpu()


def _check_chunk_tables(plan: StreamPlan) -> None:
    """The host check that KB's launches skip, over a plan's chunks."""
    _check_chunks(plan.chunks)


def _check_chunks(chunks) -> None:
    """The host check that KB's launches skip: every slab-local index
    within its slab (ghost row included) and every degree within its
    width."""
    for ch in chunks:
        if ch.C and (ch.nbr_loc.min() < 0 or ch.nbr_loc.max() > ch.M
                     or ch.deg.min() < 0 or ch.deg.max() > ch.width
                     or ch.self_loc.min() < 0 or ch.self_loc.max() >= ch.M):
            raise ValueError("stream plan chunk tables out of range")


def _journaled_churn(jpath: str, t0: int) -> list:
    """The journaled ``stream.churn`` batches with ``step < t0``, once each
    and in (step, seq) order, as ``(adds, drops)`` int64 ``[k, 2]`` pairs:
    the journal, not the schedule, is the record of what a run applied."""
    from graphdyn_torch.resilience.hooks import read_ledger

    try:
        events, _ = read_ledger(jpath)
    except (OSError, ValueError):
        events = []
    batches = {}
    for ev in events:
        if ev.get("ev") == "journal" and ev.get("op") == "stream.churn":
            key = (int(ev.get("step", -1)), int(ev.get("seq", -1)))
            batches.setdefault(key, (ev.get("adds") or [],
                                     ev.get("drops") or []))
    return [(np.asarray(adds, np.int64).reshape(-1, 2),
             np.asarray(drops, np.int64).reshape(-1, 2))
            for (step, _), (adds, drops) in sorted(batches.items())
            if step < t0]


def _replay_churn_from_journal(jpath: str, t0: int, adj,
                               plan: StreamPlan) -> tuple[StreamPlan, int]:
    """Apply every journaled ``stream.churn`` batch with ``step < t0``
    (:func:`_journaled_churn`). Returns the rebuilt plan and the number of
    batches replayed."""
    touched_all: set = set()
    batches = _journaled_churn(jpath, t0)
    for adds, drops in batches:
        touched_all |= adj.apply(adds, drops)[2]
    if touched_all:
        plan = _rebuild_touched(plan, adj.neighbor_lists(), touched_all)
    return plan, len(batches)


def streamed_rollout(graph: Graph, sp, steps: int, *,
                     rule: str = "majority", tie: str = "stay",
                     n_chunks: int | None = None,
                     device_budget_bytes: int | None = None,
                     plan: StreamPlan | None = None,
                     prefetch_depth: int = 2,
                     churn: Iterable[ChurnBatch] | None = None,
                     checkpoint_path: str | None = None,
                     checkpoint_interval_s: float = 30.0,
                     seed: int = 0,
                     stats_out: dict | None = None,
                     device=None) -> torch.Tensor:
    """Roll packed words ``sp: int32[n, W]`` (global node order, any
    array-like; a copy stays in host memory) for ``steps`` synchronous
    updates with one chunk (and the prefetched next) on ``device`` (default
    CUDA). Returns the host ``int32[n, W]`` words; bit for bit equal to
    ``packed_rollout`` and ``bucketed_rollout_global`` on the same graph.

    ``churn``: :class:`ChurnBatch` schedule, applied at step boundaries
    with a rebuild of the touched chunks. ``prefetch_depth=0`` makes the
    gathers and copies synchronous. ``stats_out`` receives ``build_s``,
    ``wait_s``, ``overlap_frac``, ``h2d_bytes``, ``d2h_bytes``,
    ``mutations``, ``steps`` and ``chunks``. ``checkpoint_path``: the
    journal and exact resume of the module docstring (the identity leaves
    the churn schedule out: the journal is what counts for the steps
    taken).
    """
    dev = resolve_device(device)
    if not isinstance(sp, torch.Tensor):
        a = np.ascontiguousarray(sp)
        sp = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
    if sp.dtype != torch.int32 or sp.ndim != 2 or sp.shape[0] != graph.n:
        raise ValueError(
            f"sp must be int32[n={graph.n}, W] packed words, got "
            f"{sp.dtype} {tuple(sp.shape)}")
    sp = sp.detach().to("cpu")
    if dev.type == "cuda":
        sp = sp.pin_memory()
    else:
        sp = sp.clone()
    W = sp.shape[1]
    schedule = sorted(churn, key=lambda b: (b.step,)) if churn else []
    # the live adjacency only when churn edits it (one set per node), or
    # when a resume may replay journaled churn
    adj = _Adjacency(graph) if schedule or checkpoint_path else None
    if plan is None:
        plan = build_stream_plan(
            graph, W=W, n_chunks=n_chunks,
            device_budget_bytes=device_budget_bytes,
            adj=adj.neighbor_lists() if adj is not None else None,
        )
    _check_chunk_tables(plan)
    stepper = _ChunkStepper(dev, rule, tie)
    totals = {"build_s": 0.0, "wait_s": 0.0, "h2d_bytes": 0,
              "d2h_bytes": 0, "mutations": 0}
    journal = None
    ckpt = None
    state = (sp, 0, 0)                      # (words, steps taken, seq)
    if checkpoint_path is not None:
        from graphdyn_torch.resilience.store import (
            journal_event,
            journal_path_for,
        )
        from graphdyn_torch.utils.io import ChainCheckpointer, run_fingerprint

        jpath = journal_path_for(checkpoint_path)

        def journal(**fields):
            journal_event(jpath, "stream.churn", **fields)

        ckpt = ChainCheckpointer(
            checkpoint_path, kind="streamed_rollout", seed=seed,
            fp=run_fingerprint(graph.edges, np.int64(graph.n),
                               np.int64(steps), str(rule), str(tie),
                               np.int64(W)),
            interval_s=checkpoint_interval_s, extra_meta={"W": int(W)})
        loaded = ckpt.load_state(
            check=lambda a: tuple(a["sp"].shape) == tuple(sp.shape))
        if loaded is not None:
            t0 = int(loaded["t"])
            plan, replayed = _replay_churn_from_journal(jpath, t0, adj, plan)
            _check_chunk_tables(plan)
            words = torch.from_numpy(
                np.ascontiguousarray(loaded["sp"]).view(np.int32))
            state = (words.pin_memory() if dev.type == "cuda"
                     else words.clone(), t0, int(loaded["seq"]))
            if obs.enabled():
                obs.counter("stream.resume", t=t0, seq=int(loaded["seq"]),
                            replayed=replayed)
    plan_ref = [plan]

    def advance(st):
        sp, t, seq = st
        # churn boundary: drops then adds, journaled as applied
        while seq < len(schedule) and schedule[seq].step <= t:
            batch = schedule[seq]
            adds, drops, touched = adj.apply(batch.adds, batch.drops)
            if touched:
                plan_ref[0] = _rebuild_touched(plan_ref[0],
                                               adj.neighbor_lists(), touched)
                _check_chunk_tables(plan_ref[0])
            if journal is not None:
                journal(step=int(batch.step), seq=int(seq),
                        adds=[list(map(int, e)) for e in adds],
                        drops=[list(map(int, e)) for e in drops],
                        n_adds=len(adds), n_drops=len(drops))
            totals["mutations"] += len(adds) + len(drops)
            seq += 1
        # chunk sweep: the prefetcher stages chunk c+1 while c steps
        plan = plan_ref[0]
        new = torch.empty(sp.shape, dtype=sp.dtype,
                          pin_memory=dev.type == "cuda")
        pf = HostPrefetcher(
            lambda c: stepper.build(sp, c, plan.chunks[c]),
            range(plan.K), depth=prefetch_depth)
        h2d = d2h = 0
        try:
            # each chunk's words come back to the host inside the span, so
            # its wall includes the card
            with obs.span("stream.step", step=t, chunks=plan.K):
                for c in range(plan.K):
                    item = pf.get(c)
                    out = stepper.step(item)
                    new.index_copy_(
                        0, torch.from_numpy(plan.chunks[c].nodes), out)
                    h2d += item[2]
                    # graftlint: disable-next-line=GD016  measured d2h traffic gauge, not a predictive byte model
                    d2h += out.numel() * out.element_size()
        finally:
            totals["build_s"] += pf.build_s
            totals["wait_s"] += pf.wait_s
            pf.close()
        totals["h2d_bytes"] += h2d
        totals["d2h_bytes"] += d2h
        if obs.enabled():
            obs.gauge("stream.h2d_bytes", h2d, step=t, chunks=plan.K)
            obs.gauge("stream.d2h_bytes", d2h, step=t, chunks=plan.K)
        return new, t + 1, seq

    if ckpt is None:
        while state[1] < steps:
            state = advance(state)
    else:
        state = ckpt.drive(
            state, advance=advance, active=lambda st: st[1] < steps,
            payload=lambda st: {"sp": st[0].numpy().view(np.uint32),
                                "t": np.int64(st[1]), "seq": np.int64(st[2])})
    sp, plan = state[0], plan_ref[0]
    build_s, wait_s = totals["build_s"], totals["wait_s"]
    overlap = max(0.0, 1.0 - wait_s / build_s) if build_s > 0 else 0.0
    if obs.enabled() and build_s > 0:
        obs.gauge("stream.overlap_util", overlap, build_s=round(build_s, 6),
                  wait_s=round(wait_s, 6), depth=prefetch_depth,
                  steps=int(state[1]), chunks=plan.K,
                  h2d_bytes=totals["h2d_bytes"],
                  d2h_bytes=totals["d2h_bytes"])
    if stats_out is not None:
        stats_out.update(totals, overlap_frac=overlap, steps=int(steps),
                         chunks=plan.K)
    return sp
