"""Sharded out-of-core streaming: the chunk walk of
:mod:`graphdyn_torch.ops.streamed` on every shard of the halo layout of
:mod:`graphdyn_torch.parallel.halo` (the port of
``graphdyn/parallel/stream.py``).

Rank ``p`` of the mesh's node dimension owns shard ``p``: a part-major
contiguous run of chunks over its owned non-hub nodes, degree-ascending and
split exactly like the single-device plan. It keeps its shard's halo-layout
state ``loc[p]`` in host memory and walks its own
chunks with its own :class:`graphdyn_torch.pipeline.prefetch.HostPrefetcher`
on its own card, one launch of the bucketed step kernel KB
(``csrc/bucketed_step.cu``) per chunk through :class:`graphdyn_torch.ops.
streamed._ChunkStepper`, as the single-device stream does. Then the
exchange (:class:`StreamExchange`): the hubs' partial popcounts, from the
pre-step state, ride the ``P − 1``-round ring of bit planes and meet the
thresholds of the original hub degrees (:class:`graphdyn_torch.parallel.
halo._HubUpdate`); every boundary slab ships as one ``P2POp`` pair per
schedule offset in one ``batch_isend_irecv``
(:func:`graphdyn_torch.parallel.mesh.exchange`).

Exactness does not depend on the layout: every owned node steps through KB
against pre-step neighbour state and every hub through the exact
ring-combined integer count, so the result equals the single-device
:func:`~graphdyn_torch.ops.streamed.streamed_rollout`, the resident KB
rollout and itself at any shard count, bit for bit. A snapshot therefore
holds the global state under the single-device stream's identity, and a
preempted run resumes at any other shard count, the single-device stream
included.

**Churn-driven repartition**: when a :class:`~graphdyn_torch.ops.streamed.
ChurnBatch` moves a node's degree across ``hub_threshold``, every rank
applies the same decision in the same order at the step boundary: the node
is promoted to a replicated hub (a fallen hub is demoted to the part that
owns most of its neighbours), the ranks gather the global state, rebuild
the halo tables and scatter it again, and each rebuilds only its touched
chunks (a chunk whose support maps to the same local rows is kept).
``stream.churn`` and ``stream.repartition`` go to the journal from rank 0,
so a requeued run replays both from the journal alone.

Every function here runs on every rank of the node dimension together.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Iterable, NamedTuple

import numpy as np
import torch

from graphdyn_torch import obs
from graphdyn_torch.graphs import (
    Graph,
    Partition,
    graph_from_edges,
    partition_graph,
)
from graphdyn_torch.ops.streamed import (
    ChurnBatch,
    _Adjacency,
    _adjacency_lists,
    _check_chunks,
    _ChunkStepper,
    _journaled_churn,
    _pow2_width,
    _split_stream_groups,
    chunk_device_bytes,
)
from graphdyn_torch.parallel.halo import (
    HaloTables,
    _HubUpdate,
    build_halo_tables,
    exchange_perms,
    gather_state,
    scatter_shard,
)
from graphdyn_torch.parallel.mesh import (
    NODE,
    WorldSync,
    all_gather_tiled,
    axis_index,
    axis_size,
    exchange,
    make_mesh,
    psum,
    rank_device,
)
from graphdyn_torch.pipeline.prefetch import HostPrefetcher

__all__ = [
    "ShardChunk", "ShardStreamPlan", "StreamExchange",
    "build_shard_stream_plan", "make_stream_exchange",
    "sharded_streamed_rollout", "shard_plan_device_bytes",
]


class ShardChunk(NamedTuple):
    """One host-resident chunk of one shard's owned (non-hub) nodes: the
    slab discipline of :class:`graphdyn_torch.ops.streamed.StreamChunk` with
    local halo-layout rows in place of global ids. The slab gathers the
    shard-local rows ``gids`` (owned rows and their neighbours' owned,
    ghost and hub rows, sorted) plus one zero row at slab index ``M``;
    ``nbr_loc`` indexes the slab. ``sup_global``/``sup_rows`` record which
    global id each referenced local row belonged to when the chunk was
    built: after a table rebuild, a chunk whose support maps to the same
    local rows needs no rebuild.

    Attributes:
      nodes:      int64[C] owned global node ids.
      rows:       int64[C] owned local rows in the shard's halo layout.
      sup_global: int64[M] global ids the slab reads (sorted by id).
      sup_rows:   int64[M] local row of each support id at build time.
      gids:       int64[M] slab gather rows (= sorted ``sup_rows``).
      nbr_loc:    int32[C, w] slab-local neighbour table, ghost = M.
      deg:        int32[C] true degrees of the owned nodes.
      self_loc:   int32[C] slab row of each owned node.
    """

    nodes: np.ndarray
    rows: np.ndarray
    sup_global: np.ndarray
    sup_rows: np.ndarray
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


class ShardStreamPlan(NamedTuple):
    """The sharded chunked layout: shard ``p`` owns the part-major
    contiguous chunk run ``shard_chunks[p]`` over the halo layout of
    ``tables`` (:func:`build_shard_stream_plan`, or
    ``build_stream_plan(partition=)``)."""

    n: int
    tables: HaloTables
    shard_chunks: tuple

    @property
    def P(self) -> int:
        return len(self.shard_chunks)

    @property
    def K(self) -> int:
        """Total chunks across all shards."""
        return sum(len(cs) for cs in self.shard_chunks)

    def shard_bytes(self, p: int, W: int) -> int:
        """Shard ``p``'s modelled peak device bytes: its two largest chunks
        resident at once under double-buffered prefetch."""
        per = sorted((chunk_device_bytes(c.C, c.M, c.width, W)
                      for c in self.shard_chunks[p]), reverse=True)
        return sum(per[:2])


def _shard_lut(tables: HaloTables, p: int) -> np.ndarray:
    """Global id → local state row of shard ``p`` (owned, ghost and hub
    rows; every other id maps to the zero row, which no built chunk
    references: every neighbour of an owned node is owned, ghost or hub)."""
    lut = np.full(tables.n + 1, tables.zero_row, np.int64)
    cnt = int(tables.counts[p])
    lut[tables.owned_global[p, :cnt]] = np.arange(cnt)
    gcnt = int(tables.ghost_counts[p])
    if gcnt:
        lut[tables.ghost_global[p, :gcnt]] = (
            tables.n_local_max + np.arange(gcnt))
    if tables.n_hubs:
        lut[tables.hub_global] = tables.hub_row0 + np.arange(tables.n_hubs)
    return lut


def _build_shard_chunk(nodes: np.ndarray, adj: list[np.ndarray],
                       lut: np.ndarray) -> ShardChunk:
    """One shard chunk's slab-local tables from the adjacency and the
    shard's global → local row lut."""
    nodes = np.asarray(nodes, np.int64)
    degs = np.array([adj[i].size for i in nodes], np.int64)
    width = _pow2_width(int(degs.max()) if nodes.size else 0)
    nbr_cat = (np.concatenate([adj[i] for i in nodes])
               if nodes.size else np.empty(0, np.int64))
    sup_global = np.unique(np.concatenate([nodes, nbr_cat]))
    sup_rows = lut[sup_global]
    gids = np.sort(sup_rows)
    M = gids.size
    rows = lut[nodes]
    self_loc = np.searchsorted(gids, rows)
    nbr_loc = np.full((nodes.size, width), M, np.int64)
    if nbr_cat.size:
        loc_cat = np.searchsorted(gids, lut[nbr_cat])
        pos = 0
        for r, d in enumerate(degs):
            nbr_loc[r, :d] = loc_cat[pos:pos + d]
            pos += d
    return ShardChunk(
        nodes=nodes, rows=rows, sup_global=sup_global, sup_rows=sup_rows,
        gids=gids, nbr_loc=nbr_loc.astype(np.int32),
        deg=degs.astype(np.int32), self_loc=self_loc.astype(np.int32))


def _shard_order(graph_deg: np.ndarray, partition: Partition,
                 p: int) -> np.ndarray:
    """Shard ``p``'s owned nodes, degree-ascending (stable): the shard's
    restriction of the single-device plan's degree-bucket walk, so each
    chunk's power-of-two width stays tight."""
    seg = partition.order[partition.offsets[p]:partition.offsets[p + 1]]
    return seg[np.argsort(graph_deg[seg], kind="stable")]


def _shard_groups(order: np.ndarray, adj: list[np.ndarray], *, W: int,
                  n_chunks: int | None,
                  device_budget_bytes: int | None) -> list[np.ndarray]:
    """One shard's chunk membership: ``n_chunks`` / the budget apply per
    shard (each card has its own budget and the shards stream at once)."""
    nc = (min(n_chunks, max(order.size, 1)) if n_chunks is not None
          else None)
    return _split_stream_groups(order, adj, W=W, n_chunks=nc,
                                device_budget_bytes=device_budget_bytes)


def build_shard_stream_plan(graph: Graph, *, W: int, partition: Partition,
                            n_chunks: int | None = None,
                            device_budget_bytes: int | None = None,
                            adj: list[np.ndarray] | None = None,
                            tables: HaloTables | None = None
                            ) -> ShardStreamPlan:
    """The sharded streamed plan (host numpy, the JAX package's arrays):
    shard ``p`` owns a part-major contiguous run of chunks over its owned
    non-hub nodes (degree-ascending); hubs stay replicated in the halo
    layout. ``n_chunks`` / ``device_budget_bytes`` apply per shard.
    ``tables`` (default: the full halo tables) may be given, e.g. built
    with ``owned_nbr=False``, which the chunks do not read."""
    if adj is None:
        adj = _adjacency_lists(graph)
    if tables is None:
        tables = build_halo_tables(graph, partition)
    shard_chunks = []
    for p in range(partition.P):
        groups = _shard_groups(_shard_order(graph.deg, partition, p), adj,
                               W=W, n_chunks=n_chunks,
                               device_budget_bytes=device_budget_bytes)
        lut = _shard_lut(tables, p)
        shard_chunks.append(tuple(_build_shard_chunk(g, adj, lut)
                                  for g in groups))
    return ShardStreamPlan(n=graph.n, tables=tables,
                           shard_chunks=tuple(shard_chunks))


def shard_plan_device_bytes(plan: ShardStreamPlan, W: int) -> int:
    """Peak modelled device bytes of the widest shard: its two largest
    chunks resident at once under double-buffered prefetch (the number the
    per-shard ``streamed_state_bytes`` admission model prices)."""
    return max((plan.shard_bytes(p, W) for p in range(plan.P)), default=0)


# ---------------------------------------------------------------------------
# the per-step exchange on process groups
# ---------------------------------------------------------------------------


class StreamExchange:
    """The per-step exchange of the sharded stream on this rank: ``(hub
    slab, previous hub rows, send slabs) -> (new hub rows, received
    slabs)``, tensors on this rank's device (the counterpart of the JAX
    package's ``make_stream_exchange``, ``stream.py:276-380``).

    The hub slab is this rank's ``[H·hd_max, W]`` rows of its hub
    neighbours, gathered on the host in ``hub_nbr_loc`` order from the
    pre-step state (pad slots carry the zero row's zeros). Their partial
    carry-save count, the ring of ``P − 1`` bit-plane exchanges, the
    comparator against the original hub degrees and the rule/tie epilogue
    are the resident halo rollout's own (:class:`graphdyn_torch.parallel.
    halo._HubUpdate`) over the identity index: every partial count is an
    exact integer, so the bits equal the JAX program's (CSA planes up to
    ``UNROLL_MAX`` slots, segmented integer counts past it). Each boundary
    slab ships as one ``P2POp`` pair per schedule offset. Tables with no
    hubs and an empty schedule have nothing to exchange and are refused."""

    def __init__(self, mesh, tables: HaloTables, *, rule: str = "majority",
                 tie: str = "stay", node_axis: str = NODE, device=None):
        if tables.n_hubs == 0 and len(tables.schedule) == 0:
            raise ValueError(
                "tables have no hubs and an empty exchange schedule — "
                "nothing to exchange (P=1, hubless: skip the program)")
        if axis_size(mesh, node_axis) != tables.P:
            raise ValueError(
                f"mesh {node_axis!r} axis size {axis_size(mesh, node_axis)} "
                f"!= tables P {tables.P}")
        self.mesh, self.node_axis = mesh, node_axis
        self.device = rank_device(device)
        self.H = tables.n_hubs
        self.deltas = [int(d) for (d, _, _) in tables.schedule]
        self.perms = exchange_perms(tables)
        if self.H:
            hd_max = tables.hub_nbr_loc.shape[2]
            self.hub = _HubUpdate(tables, self.device, rule, tie)
            self.seg_idx = torch.arange(
                self.H * hd_max, dtype=torch.int64,
                device=self.device).reshape(self.H, hd_max)

    def __call__(self, hub_slab, prev_h, sends):
        """New hub rows (None without hubs) and the received slabs."""
        out_h = None
        if self.H:
            out_h = self.hub(hub_slab, self.seg_idx, self.mesh,
                             self.node_axis, prev=prev_h)
        recvs = exchange(list(sends), self.deltas, self.mesh, self.node_axis)
        return out_h, recvs


def make_stream_exchange(mesh, tables: HaloTables, *, rule: str = "majority",
                         tie: str = "stay", node_axis: str = NODE,
                         device=None) -> StreamExchange:
    """This rank's :class:`StreamExchange` (the JAX package's maker)."""
    return StreamExchange(mesh, tables, rule=rule, tie=tie,
                          node_axis=node_axis, device=device)


# ---------------------------------------------------------------------------
# churn-driven repartition
# ---------------------------------------------------------------------------


def _graph_from_adj(adj: _Adjacency) -> Graph:
    """The current churned graph as a padded-table Graph (host): the
    ``graph_from_edges`` of its ``u < v`` edges in (u, v) order, built
    straight from the sorted neighbour lists (each row holds its
    neighbours above it, ascending, then those below it, ascending: the
    order ``graph_from_edges`` gives) without the int64 padded scatter."""
    lists = adj.neighbor_lists()
    n = adj.n
    deg = np.fromiter((nb.size for nb in lists), np.int64, n)
    if not deg.sum():
        return graph_from_edges(n, np.empty((0, 2), np.int64))
    dst = np.concatenate(lists)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    below = dst < src
    order = np.lexsort((below, src))
    dst = dst[order]
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    rank = np.arange(dst.size) - np.repeat(starts, deg)
    # graftlint: disable-next-line=GD017  _graph_from_adj builds the graph's own table, the same arrays graphs.graph_from_edges gives
    nbr = np.full((n, max(int(deg.max()), 1)), n, np.int32)
    nbr[src, rank] = dst
    keep = ~below[order]
    edges = np.stack([src[keep], dst[keep]], axis=1).astype(np.int32)
    return Graph(nbr=nbr, deg=deg.astype(np.int32), edges=edges)


def _partition_from_part(cur: Graph, part_vec: np.ndarray,
                         hubs: np.ndarray, n_parts: int) -> Partition:
    """A :class:`Partition` from an explicit part vector and hub set: the
    incremental repartition (promotions and demotions edit ``part_vec``;
    non-hub ownership never moves, so only the boundary/interior split is
    recomputed)."""
    n = cur.n
    e = cur.edges.astype(np.int64)
    is_boundary = np.zeros(n, bool)
    cut = 0
    if e.size:
        pu, pv = part_vec[e[:, 0]], part_vec[e[:, 1]]
        cross = (pu != pv) & (pu >= 0) & (pv >= 0)
        is_boundary[e[cross, 0]] = True
        is_boundary[e[cross, 1]] = True
        cut = int(cross.sum())
    pos = np.arange(n, dtype=np.int64)
    order = np.lexsort((pos, is_boundary, part_vec)).astype(np.int64)
    order = order[hubs.size:]
    counts = np.bincount(part_vec[part_vec >= 0],
                         minlength=n_parts).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    bmask = is_boundary & (part_vec >= 0)
    interior = counts - np.bincount(part_vec[bmask],
                                    minlength=n_parts).astype(np.int64)
    return Partition(
        part=part_vec.astype(np.int32), order=order, offsets=offsets,
        interior=interior, edge_cut=cut,
        hubs=np.sort(hubs).astype(np.int64) if hubs.size else None)


def _demote_target(adj: _Adjacency, part_vec: np.ndarray, v: int) -> int:
    """The part a fallen hub lands on: the owner of most of its neighbours
    (ties → lowest part id; isolated → part 0), a function of the
    journaled churn alone, so a replay derives the same assignment."""
    owners = [int(part_vec[u]) for u in adj._sets[v] if part_vec[u] >= 0]
    if not owners:
        return 0
    cnt = Counter(owners)
    best = max(cnt.values())
    return min(p for p, c in cnt.items() if c == best)


def _replay_churn(jpath: str, t0: int, adj: _Adjacency) -> int:
    """Re-apply every journaled ``stream.churn`` batch with ``step < t0``
    to the adjacency (no chunk rebuild: the caller partitions the replayed
    graph afresh, since the requeued shard count may differ). Returns the
    number of batches replayed."""
    batches = _journaled_churn(jpath, t0)
    for adds, drops in batches:
        adj.apply(adds, drops)
    return len(batches)


# ---------------------------------------------------------------------------
# the shard engine of one rank
# ---------------------------------------------------------------------------


class _ShardEngine:
    """This rank's half of the composed engine: the global halo tables (host
    numpy, identical on every rank), its own chunk run, its chunk stepper,
    the exchange (made again when the tables' shape changes) and the
    incremental rebuild after churn."""

    def __init__(self, graph: Graph, adj: _Adjacency, partition: Partition,
                 *, W: int, rule: str, tie: str, n_chunks, device_budget_bytes,
                 mesh, node_axis: str, device):
        self.adj, self.n, self.W = adj, graph.n, W
        self.rule, self.tie = rule, tie
        self.mesh, self.node_axis = mesh, node_axis
        self.Pn = partition.P
        self.p = axis_index(mesh, node_axis)
        self.device = device
        self.stepper = _ChunkStepper(device, rule, tie)
        self._exch_key = None
        self._exch = None
        self.repartitions = 0
        self.chunks_rebuilt = 0
        self.part_vec = partition.part.astype(np.int64).copy()
        hubs = (partition.hubs if partition.hubs is not None
                else np.empty(0, np.int64)).astype(np.int64)
        self.hubset: set[int] = set(int(h) for h in hubs)
        self.tables = build_halo_tables(graph, partition, owned_nbr=False)
        # this shard's chunk membership (global ids), stable under churn: a
        # promotion removes a node, a demotion appends to its new owner's
        # last chunk
        adj_lists = adj.neighbor_lists()
        groups = _shard_groups(_shard_order(graph.deg, partition, self.p),
                               adj_lists, W=W, n_chunks=n_chunks,
                               device_budget_bytes=device_budget_bytes)
        self.chunk_nodes = ([np.asarray(g, np.int64) for g in groups]
                            or [np.empty(0, np.int64)])
        lut = _shard_lut(self.tables, self.p)
        self.chunks = [_build_shard_chunk(g, adj_lists, lut)
                       for g in self.chunk_nodes]
        self.chunks_rebuilt += len(self.chunk_nodes)
        _check_chunks(self.chunks)

    def exchange_fn(self) -> StreamExchange | None:
        """The exchange of the current tables (None with nothing to
        exchange: P=1, hubless), kept while the hub set and the schedule's
        shape stay the same."""
        t = self.tables
        if t.n_hubs == 0 and len(t.schedule) == 0:
            return None
        key = (t.P, t.n_hubs, t.hub_deg.tobytes() if t.n_hubs else b"",
               t.hub_nbr_loc.shape if t.n_hubs else (),
               tuple((int(d), s.shape[1]) for (d, s, _) in t.schedule))
        if key != self._exch_key:
            self._exch = StreamExchange(self.mesh, t, rule=self.rule,
                                        tie=self.tie,
                                        node_axis=self.node_axis,
                                        device=self.device)
            self._exch_key = key
        return self._exch

    def gather_global(self, loc_p: torch.Tensor) -> np.ndarray:
        """Every shard's state gathered and put back in global order, as
        uint32 ``[n, W]`` on every rank (a collective)."""
        # graftlint: disable-next-line=GD013  the global state for a churn repartition, a snapshot or the result, not a step's exchange
        allp = all_gather_tiled(loc_p[None].to(self.device), self.mesh,
                                self.node_axis, dim=0).cpu()
        return gather_state(self.tables, allp.numpy().view(np.uint32))

    def place(self, sp: np.ndarray) -> torch.Tensor:
        """This shard's halo-layout state of global words ``sp`` (host)."""
        return torch.from_numpy(
            scatter_shard(self.tables, sp, self.p).view(np.int32))

    def apply_churn(self, touched: set, promotes: list, demotes: list,
                    loc_p: torch.Tensor) -> torch.Tensor:
        """The rebuild at a churn boundary: hub membership, the halo tables
        and schedule, the state remapped through the global order (exact: at
        a boundary the ghost and hub rows agree with their owners), and only
        the chunks whose adjacency or support rows changed. Returns the
        remapped shard state."""
        for v in promotes:
            self.hubset.add(v)
            self.part_vec[v] = -1
        for v in demotes:
            self.hubset.discard(v)
            self.part_vec[v] = _demote_target(self.adj, self.part_vec, v)
        cur = _graph_from_adj(self.adj)
        hubs = np.fromiter(sorted(self.hubset), np.int64, len(self.hubset))
        glob = self.gather_global(loc_p)
        self.tables = build_halo_tables(
            cur, _partition_from_part(cur, self.part_vec, hubs, self.Pn),
            owned_nbr=False)
        loc_p = self.place(glob)
        if promotes or demotes:
            self.repartitions += 1
            if promotes:
                gone = set(promotes)
                for k, g in enumerate(self.chunk_nodes):
                    if gone.intersection(g.tolist()):
                        self.chunk_nodes[k] = g[~np.isin(g, promotes)]
            for v in demotes:
                if int(self.part_vec[v]) == self.p:
                    self.chunk_nodes[-1] = np.concatenate(
                        [self.chunk_nodes[-1], [v]])
        adj_lists = self.adj.neighbor_lists()
        moved = set(promotes) | set(demotes)
        lut = _shard_lut(self.tables, self.p)
        rebuilt = []
        for g, old in zip(self.chunk_nodes, self.chunks):
            # graftlint: disable-next-line=GD003  host numpy ids of a chunk (a churn repartition's host rebuild), not a read of the card
            members = set(g.tolist())
            clean = (old.nodes.size == g.size
                     and np.array_equal(old.nodes, g)
                     and not touched.intersection(members)
                     and not moved.intersection(members)
                     and np.array_equal(lut[old.sup_global], old.sup_rows))
            if clean:
                rebuilt.append(old)
            else:
                rebuilt.append(_build_shard_chunk(g, adj_lists, lut))
                self.chunks_rebuilt += 1
        self.chunks = rebuilt
        _check_chunks(self.chunks)
        return loc_p

    def step(self, loc_p: torch.Tensor, t: int, depth: int,
             totals: dict) -> torch.Tensor:
        """One synchronous update of this shard: the prefetched chunk walk
        (one KB launch per chunk, owned rows written after the walk), then
        the exchange refreshes the hub and ghost rows. Returns the new
        shard state (host)."""
        tables = self.tables
        W, H, h0 = self.W, tables.n_hubs, tables.hub_row0
        dev = self.device
        chunks = [c for c in self.chunks if c.C]
        h2d = d2h = 0
        sync = dev.type == "cuda"
        with obs.span("stream.step", step=t, shards=self.Pn, shard=self.p):
            t0 = time.perf_counter()
            pf = HostPrefetcher(
                lambda c: self.stepper.build(loc_p, c, chunks[c]),
                range(len(chunks)), depth=depth)
            outs = []
            try:
                for c in range(len(chunks)):
                    item = pf.get(c)
                    out = self.stepper.step(item)
                    outs.append((chunks[c], out))
                    h2d += item[2]
                    # graftlint: disable-next-line=GD016  measured d2h traffic gauge, not a predictive byte model
                    d2h += out.numel() * out.element_size()
            finally:
                totals["build_s"] += pf.build_s
                totals["wait_s"] += pf.wait_s
                pf.close()
            hub_slab = None
            if H:
                # the hub partials read the PRE-step state (the halo
                # kernel's order), so before the owned writes land
                hub_slab = loc_p.index_select(0, torch.from_numpy(
                    tables.hub_nbr_loc[self.p].reshape(-1).astype(np.int64)))
            new = loc_p.clone()
            for ch, out in outs:
                new.index_copy_(0, torch.from_numpy(ch.rows), out)
            t1 = time.perf_counter()
            fn = self.exchange_fn()
            if fn is not None:
                sends = [new.index_select(0, torch.from_numpy(
                    s[self.p].astype(np.int64))) for (_, s, _) in
                    tables.schedule]
                prev_h = new[h0:h0 + H] if H else None
                args = ([hub_slab, prev_h] if H else []) + sends
                # graftlint: disable-next-line=GD016  measured h2d traffic gauge over the operands actually staged, not a predictive byte model
                h2d += sum(a.numel() * a.element_size() for a in args)
                args = [a.to(dev, non_blocking=False) for a in args]
                out_h, recvs = fn(args[0] if H else None,
                                  args[1] if H else None,
                                  args[2:] if H else args)
                if H:
                    # counted as the JAX package counts it: the received
                    # slabs, not the hub rows, make the exchange's d2h
                    new[h0:h0 + H] = out_h.cpu()
                for (_, _, r), rv in zip(tables.schedule, recvs):
                    rv = rv.cpu()
                    new.index_copy_(0, torch.from_numpy(
                        r[self.p].astype(np.int64)), rv)
                    # graftlint: disable-next-line=GD016  measured d2h traffic gauge, not a predictive byte model
                    d2h += rv.numel() * rv.element_size()
            if sync:
                torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
        totals["walk_s"] += t1 - t0
        totals["exchange_s"] += t2 - t1
        totals["h2d_bytes"] += h2d
        totals["d2h_bytes"] += d2h
        if obs.enabled():
            obs.gauge("stream.h2d_bytes", h2d, step=t, shards=self.Pn,
                      shard=self.p)
            obs.gauge("stream.d2h_bytes", d2h, step=t, shards=self.Pn,
                      shard=self.p)
            obs.gauge("stream.exchange_bytes", tables.halo_bytes_per_step(W),
                      step=t, shards=self.Pn)
        return new


class _ShardStreamState(NamedTuple):
    loc: torch.Tensor     # int32[n_rows, W] this shard's halo layout (host)
    t: int                # completed synchronous steps
    seq: int              # applied churn batches so far (journal cursor)


def _as_words(sp) -> np.ndarray:
    """Packed words of any array-like as host uint32 ``[n, W]``."""
    if isinstance(sp, torch.Tensor):
        sp = sp.detach().cpu().numpy()
    a = np.ascontiguousarray(sp)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def sharded_streamed_rollout(
    graph: Graph, sp, steps: int, *,
    n_shards: int,
    rule: str = "majority", tie: str = "stay",
    n_chunks: int | None = None,
    device_budget_bytes: int | None = None,
    hub_threshold: int | None = None,
    partition: Partition | None = None,
    partition_seed: int = 0,
    mesh=None,
    node_axis: str = NODE,
    prefetch_depth: int = 2,
    churn: Iterable[ChurnBatch] | None = None,
    checkpoint_path: str | None = None,
    checkpoint_interval_s: float = 30.0,
    seed: int = 0,
    stats_out: dict | None = None,
    device=None,
) -> torch.Tensor:
    """Roll packed words ``sp`` (``[n, W]`` in global node order, any
    array-like; uint32 bit patterns) for ``steps`` synchronous updates over
    ``n_shards`` halo shards, rank ``p`` of the mesh's node dimension
    walking shard ``p``'s out-of-core chunk run on ``device`` (default its
    card). Every rank of the node dimension calls it together and gets the
    global result as host ``int32[n, W]`` words, bit for bit equal to
    :func:`graphdyn_torch.ops.streamed.streamed_rollout`, the resident KB
    rollout and this function at any other shard count.

    ``n_chunks`` / ``device_budget_bytes`` (exactly one) size each shard's
    chunk run. ``hub_threshold`` splits hubs at partitioning and turns on
    churn-driven repartition (module docstring). ``mesh``: default a 1-D
    ``node`` mesh over the world's ranks; its node dimension must have
    ``n_shards`` ranks. ``checkpoint_path``: the global state under the
    single-device stream's identity, written by rank 0, with the journal
    replay on resume at any shard count. ``stats_out`` receives the JAX
    package's keys (``build_s``, ``wait_s``, ``overlap_frac``,
    ``per_shard_overlap``, ``h2d_bytes``, ``d2h_bytes``, ``mutations``,
    ``repartitions``, ``chunks_rebuilt``, ``steps``, ``chunks``,
    ``shards``; bytes, builds and chunks summed over the shards) and this
    port's ``walk_s`` / ``exchange_s`` (this rank's host seconds of the
    chunk walk and of the exchange, the card synchronised at the end of
    each step), ``shard_chunks`` (this rank's chunks) and
    ``exchange_bytes`` (the last tables' ``halo_bytes_per_step``)."""
    sp = _as_words(sp)
    if sp.ndim != 2 or sp.shape[0] != graph.n:
        raise ValueError(f"sp must be uint32[n={graph.n}, W], got "
                         f"{sp.shape}")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    W = sp.shape[1]
    schedule = sorted(churn, key=lambda b: (b.step,)) if churn else []
    adj = _Adjacency(graph)
    if partition is not None and partition.P != n_shards:
        raise ValueError(f"partition has P={partition.P} parts but "
                         f"n_shards={n_shards}")
    dev = rank_device(device)
    if mesh is None:
        mesh = make_mesh((n_shards,), (node_axis,), device=dev)
    if axis_size(mesh, node_axis) != n_shards:
        raise ValueError(f"mesh {node_axis!r} axis size "
                         f"{axis_size(mesh, node_axis)} != n_shards "
                         f"{n_shards}")
    sync = WorldSync(dev)

    journal = journal_repart = None
    ckpt = None
    t0, seq0 = 0, 0
    if checkpoint_path:
        from graphdyn_torch.resilience.store import (
            journal_event,
            journal_path_for,
        )
        from graphdyn_torch.utils.io import ChainCheckpointer, run_fingerprint

        jpath = journal_path_for(checkpoint_path)
        if sync.writer:
            def journal(**fields):
                journal_event(jpath, "stream.churn", **fields)

            def journal_repart(**fields):
                journal_event(jpath, "stream.repartition", **fields)

        # the single-device stream's identity: it leaves the churn schedule,
        # the shard count and the partition out, so a run resumes across
        # engines and shard counts (the journal is the record of the
        # boundaries already crossed)
        ckpt = ChainCheckpointer(
            checkpoint_path, kind="streamed_rollout", seed=seed,
            fp=run_fingerprint(graph.edges, np.int64(graph.n),
                               np.int64(steps), str(rule), str(tie),
                               np.int64(W)),
            interval_s=checkpoint_interval_s, extra_meta={"W": int(W)},
            sync=sync)
        loaded = ckpt.load_state(
            check=lambda a: tuple(a["sp"].shape) == tuple(sp.shape))
        if loaded is not None:
            t0, seq0 = int(loaded["t"]), int(loaded["seq"])
            replayed = _replay_churn(jpath, t0, adj)
            sp = np.ascontiguousarray(loaded["sp"]).astype(np.uint32)
            if obs.enabled():
                obs.counter("stream.resume", t=t0, seq=seq0,
                            replayed=replayed, shards=n_shards)
            # the journaled history moved the adjacency: partition the
            # replayed graph afresh (any partition is exact)
            partition = None

    if partition is None:
        cur = _graph_from_adj(adj)
        partition = partition_graph(cur, n_shards, seed=partition_seed,
                                    hub_threshold=hub_threshold)
        base = cur
    else:
        base = graph
    eng = _ShardEngine(base, adj, partition, W=W, rule=rule, tie=tie,
                       n_chunks=n_chunks,
                       device_budget_bytes=device_budget_bytes, mesh=mesh,
                       node_axis=node_axis, device=dev)
    state = _ShardStreamState(loc=eng.place(sp), t=t0, seq=seq0)
    totals = {"h2d_bytes": 0, "d2h_bytes": 0, "mutations": 0,
              "build_s": 0.0, "wait_s": 0.0, "walk_s": 0.0,
              "exchange_s": 0.0}

    def advance(s: _ShardStreamState) -> _ShardStreamState:
        t, seq, loc = s.t, s.seq, s.loc
        touched_all: set[int] = set()
        promotes_all: list[int] = []
        demotes_all: list[int] = []
        dirty = False
        while seq < len(schedule) and schedule[seq].step <= t:
            batch = schedule[seq]
            adds, drops, touched = adj.apply(batch.adds, batch.drops)
            if journal is not None:
                journal(step=int(batch.step), seq=int(seq),
                        adds=[list(map(int, e)) for e in adds],
                        drops=[list(map(int, e)) for e in drops],
                        n_adds=len(adds), n_drops=len(drops))
            totals["mutations"] += len(adds) + len(drops)
            touched_all |= touched
            dirty = dirty or bool(touched)
            if hub_threshold is not None and touched:
                promotes = sorted(
                    v for v in touched if v not in eng.hubset
                    and len(adj._sets[v]) >= hub_threshold)
                demotes = sorted(
                    v for v in touched if v in eng.hubset
                    and len(adj._sets[v]) < hub_threshold)
                if promotes or demotes:
                    if journal_repart is not None:
                        journal_repart(step=int(batch.step), seq=int(seq),
                                       promotes=promotes, demotes=demotes,
                                       n_promotes=len(promotes),
                                       n_demotes=len(demotes))
                    promotes_all += promotes
                    demotes_all += demotes
            seq += 1
        if dirty:
            loc = eng.apply_churn(touched_all, promotes_all, demotes_all, loc)
        loc = eng.step(loc, t, prefetch_depth, totals)
        return _ShardStreamState(loc=loc, t=t + 1, seq=seq)

    def active(s: _ShardStreamState) -> bool:
        return s.t < steps

    if ckpt is not None:
        state = ckpt.drive(
            state, advance=advance, active=active,
            payload=lambda s: {"sp": eng.gather_global(s.loc),
                               "t": np.int64(s.t), "seq": np.int64(s.seq)})
    else:
        while active(state):
            state = advance(state)

    # the shards' totals (every rank takes part in these reductions)
    tot = psum(torch.tensor([totals["h2d_bytes"], totals["d2h_bytes"],
                             eng.chunks_rebuilt, len(eng.chunks)],
                            dtype=torch.int64, device=dev), mesh,
               node_axis).tolist()
    # graftlint: disable-next-line=GD013  two host timing numbers a rank, not state
    bw = all_gather_tiled(torch.tensor([[totals["build_s"],
                                         totals["wait_s"]]],
                                       # graftlint: disable-next-line=GD004  host timing totals (seconds) gathered as one float64 row, not device state
                                       dtype=torch.float64, device=dev),
                          mesh, node_axis, dim=0).tolist()
    per_shard = []
    for p, (b, w) in enumerate(bw):
        o = max(0.0, 1.0 - w / b) if b > 0 else 0.0
        per_shard.append(o)
        if obs.enabled() and b > 0 and p == eng.p:
            obs.gauge("stream.overlap_util", o, shard=p,
                      build_s=round(b, 6), wait_s=round(w, 6),
                      depth=prefetch_depth, steps=int(state.t),
                      chunks=len(eng.chunks))
    build_s = float(sum(b for b, _ in bw))
    wait_s = float(sum(w for _, w in bw))
    overlap = max(0.0, 1.0 - wait_s / build_s) if build_s > 0 else 0.0
    out = torch.from_numpy(eng.gather_global(state.loc).view(np.int32))
    if stats_out is not None:
        stats_out.update(
            build_s=build_s, wait_s=wait_s, overlap_frac=overlap,
            per_shard_overlap=per_shard, h2d_bytes=int(tot[0]),
            d2h_bytes=int(tot[1]), mutations=totals["mutations"],
            repartitions=eng.repartitions, chunks_rebuilt=int(tot[2]),
            steps=int(state.t), shards=n_shards, chunks=int(tot[3]),
            walk_s=totals["walk_s"], exchange_s=totals["exchange_s"],
            shard_chunks=len(eng.chunks),
            exchange_bytes=eng.tables.halo_bytes_per_step(W))
    return out
