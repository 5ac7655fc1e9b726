"""Halo-exchange node-axis sharding of the packed dynamics (the port of
``graphdyn/parallel/halo.py``).

The gather mode (:mod:`graphdyn_torch.parallel.sharded`) ships the whole
spin state to every rank each synchronous step. This module ships only what
the partition says a rank reads: the **boundary** nodes' packed words, the
edge cut priced in words.

Layout (host-built once by :func:`build_halo_tables` from a
:class:`graphdyn_torch.graphs.Partition`, array for array the JAX
package's): rank ``p`` holds ``int32[n_rows, W]`` (uint32 bit patterns)
with

- rows ``[0, n_local_max)``: the nodes ``p`` owns, interior first, then
  boundary, then inert pad rows;
- rows ``[n_local_max, n_local_max + n_ghost_max)``: ghost rows, the
  remote boundary nodes ``p`` gathers from, refreshed by each exchange;
- one row per vertex-cut hub (hub-split partitions), replicated on every
  rank;
- one trash row (where pad receive lanes land) and the always-zero row
  last (where ghost-padded neighbor slots point).

The synchronous step on one rank is K1/K2′, the packed-step kernel
(``csrc/packed_step.cu``), on this layout (:func:`graphdyn_torch.ops.
packed_cuda.packed_step_rows`): it writes the real owned rows and no other.
The rollout's two ping-pong buffers start as copies of the placed shard, so
pad rows stay inert under every (rule, tie) and the zero row stays zero in
both; the hub update and the exchange refresh the hub and ghost rows (and
the trash row, where pad receive lanes land) of the buffer just written. On
the CPU the plain twin (:func:`shard_step_plain`) writes the same words. Hubs' partial counts
and their ring allreduce of bit planes stay plain PyTorch plus collectives
(XLA code in the JAX package). Then the exchange: one ``P2POp`` pair per
schedule offset δ, all in one ``batch_isend_irecv``
(:func:`graphdyn_torch.parallel.mesh.exchange`), each rank sending its
boundary slab to rank ``(p + δ) mod P``.

Per-step traffic: the padded slabs, ``4·W·n_slab_words`` bytes, plus the
hub ring; :meth:`HaloTables.halo_bytes_per_step` is the
``parallel.halo.bytes_per_step`` gauge, as in the JAX package.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.graphs import Graph, Partition, partition_ghosts
from graphdyn_torch.ops import packed_cuda
from graphdyn_torch.ops.bucketed import UNROLL_MAX as _UNROLL_MAX
from graphdyn_torch.ops.bucketed import _pack_lanes, _wide_bucket_counts
from graphdyn_torch.ops.dynamics import Rule, TieBreak
from graphdyn_torch.ops.packed import (
    _compare_planes,
    _csa_add_one,
    _rule_tie_combine,
)
from graphdyn_torch.parallel.mesh import (
    NODE,
    all_gather_tiled,
    axis_index,
    axis_size,
    exchange,
    make_mesh,
    rank_device,
)


class HaloTables(NamedTuple):
    """Host tables of the per-shard halo layout (see module docstring).

    ``schedule`` is the static exchange plan: one ``(delta, send_idx,
    recv_idx)`` triple per distinct shard offset, ``send_idx/recv_idx``
    int32[P, m_delta] local row indices (pad send lanes gather the zero
    row; pad recv lanes scatter into the trash row). ``n_halo_words``
    counts the USEFUL rows exchanged per step (= Σ ghosts — the edge-cut
    floor); ``n_slab_words`` counts what the collectives actually ship:
    every shard sends the PADDED ``m_delta`` slab at every offset
    (``P · Σ_δ m_δ`` — a uniform collective cannot send ragged rows), so
    the honest wire bill is ``4 · W · n_slab_words`` and the pad overhead
    ``n_slab_words / n_halo_words`` is a partition-balance figure of
    merit.
    """

    n: int                    # global node count
    n_local_max: int          # owned rows per shard (padded)
    n_ghost_max: int          # ghost rows per shard (padded)
    dmax: int
    counts: np.ndarray        # int64[P] real owned nodes per shard
    ghost_counts: np.ndarray  # int64[P] real ghost rows per shard
    nbr_loc: np.ndarray       # int32[P, n_local_max, dmax] local row indices
    deg_loc: np.ndarray       # int32[P, n_local_max]
    real: np.ndarray          # bool[P, n_local_max] owned-and-real mask
    owned_global: np.ndarray  # int64[P, n_local_max] global id per row (-1 pad)
    ghost_global: np.ndarray  # int64[P, n_ghost_max] global id per ghost (-1)
    loc_of: np.ndarray        # int32[n]: owner shard * n_local_max + row
    schedule: tuple           # ((delta, send_idx[P, m], recv_idx[P, m]), ...)
    n_halo_words: int         # useful boundary rows per step (Σ ghosts)
    n_slab_words: int         # shipped rows per step (P · Σ_δ m_δ, pads incl.)
    # hub-split vertex cut (None/empty on hubless partitions, whose layout
    # has no hub rows):
    hub_global: np.ndarray | None = None  # int64[H] global hub ids
    hub_deg: np.ndarray | None = None     # int32[H] ORIGINAL hub degrees
    hub_nbr_loc: np.ndarray | None = None  # int32[P, H, hd_max] local rows
    hub_ring_words: int = 0   # rows shipped per step by the hub ring

    @property
    def P(self) -> int:
        return self.nbr_loc.shape[0]

    @property
    def n_hubs(self) -> int:
        return 0 if self.hub_global is None else int(self.hub_global.size)

    @property
    def n_rows(self) -> int:
        # owned + ghosts + replicated hubs + trash + zero
        return self.n_local_max + self.n_ghost_max + self.n_hubs + 2

    @property
    def hub_row0(self) -> int:
        """First replicated-hub row (hubs occupy ``[hub_row0, trash_row)``)."""
        return self.n_local_max + self.n_ghost_max

    @property
    def trash_row(self) -> int:
        return self.n_local_max + self.n_ghost_max + self.n_hubs

    @property
    def zero_row(self) -> int:
        return self.n_local_max + self.n_ghost_max + self.n_hubs + 1

    def halo_bytes_per_step(self, W: int) -> int:
        """ACTUAL exchange traffic of one synchronous step at ``W`` spin
        words per node — the padded slabs the collectives ship
        (``4·W·n_slab_words``) plus the hub partial-popcount ring
        (``4·W·hub_ring_words``), not the useful-words floor
        (``4·W·n_halo_words``). The number the weak-scaling bench row and
        the obs gauge report; the slab/useful ratio is pad overhead from
        partition imbalance."""
        return 4 * W * (self.n_slab_words + self.hub_ring_words)


def build_halo_tables(graph: Graph, partition: Partition, *,
                      owned_nbr: bool = True) -> HaloTables:
    """Build the per-shard layout + static exchange schedule for
    ``partition`` (pure host NumPy; one-time cost per graph).
    ``owned_nbr=False`` leaves the owned rows' neighbour table empty
    (``nbr_loc`` of width 0): the sharded stream steps its chunks from
    their own tables, and a power-law graph's table padded to ``dmax`` is
    the costly part of the build.

    Hub-split partitions (``partition.hubs`` non-empty — see
    :func:`graphdyn_torch.graphs.partition_graph` ``hub_threshold``) get the
    vertex-cut layout: every shard carries a replicated row per hub, the
    owned-row ``dmax`` shrinks to the max NON-hub degree (the whole point
    — one degree-1e5 hub no longer pads every owned row), and
    ``hub_nbr_loc[p, i]`` lists hub ``i``'s neighbors OWNED BY shard p
    (hub–hub neighbors charged to shard 0 so each edge counts once): the
    per-shard partial popcounts those rows produce are ring-combined each
    step (see :func:`make_halo_rollout`)."""
    n = graph.n
    Pn = partition.P
    counts = partition.counts
    hubs = (
        partition.hubs if partition.hubs is not None
        else np.empty(0, np.int64)
    ).astype(np.int64)
    H = int(hubs.size)
    # hub-split shrinks the owned-row gather width to the non-hub max
    # degree; hubless tables keep graph.dmax (the JAX package's layout)
    if H:
        hub_mask = np.zeros(n, bool)
        hub_mask[hubs] = True
        dmax = int(graph.deg[~hub_mask].max(initial=1))
    else:
        dmax = graph.dmax
    n_local_max = int(counts.max())
    ghosts = partition_ghosts(graph, partition)
    ghost_counts = np.array([g.size for g in ghosts], np.int64)
    n_ghost_max = int(ghost_counts.max(initial=0))
    n_rows = n_local_max + n_ghost_max + H + 2
    trash_row, zero_row = n_rows - 2, n_rows - 1
    hub_row0 = n_local_max + n_ghost_max

    nbr_loc = np.full((Pn, n_local_max, dmax if owned_nbr else 0), zero_row,
                      np.int32)
    deg_loc = np.zeros((Pn, n_local_max), np.int32)
    real = np.zeros((Pn, n_local_max), bool)
    owned_global = np.full((Pn, n_local_max), -1, np.int64)
    ghost_global = np.full((Pn, n_ghost_max), -1, np.int64)
    row_of = np.empty(n, np.int64)          # local row within the owner shard
    ghost_pos = []                          # per shard: global -> ghost slot
    for p in range(Pn):
        seg = partition.order[partition.offsets[p]:partition.offsets[p + 1]]
        row_of[seg] = np.arange(seg.size)
        gl = ghosts[p]
        # global -> local row lut for this shard; the graph's own ghost
        # index n (ragged-degree padding) maps to the zero row, exactly the
        # unsharded kernel's zero-contribution slot
        lut = np.full(n + 1, zero_row, np.int64)
        lut[seg] = np.arange(seg.size)
        lut[gl] = n_local_max + np.arange(gl.size)
        if H:
            lut[hubs] = hub_row0 + np.arange(H)
        if owned_nbr:
            nbr_loc[p, :seg.size] = lut[graph.nbr[seg, :dmax].astype(
                np.int64)]
        deg_loc[p, :seg.size] = graph.deg[seg]
        real[p, :seg.size] = True
        owned_global[p, :seg.size] = seg
        ghost_global[p, :gl.size] = gl
        gpos = np.full(n, -1, np.int64)
        gpos[gl] = np.arange(gl.size)
        ghost_pos.append(gpos)
    if H:
        row_of[hubs] = 0
    loc_of = (
        partition.part.astype(np.int64) * n_local_max + row_of
    ).astype(np.int32)
    if H:
        loc_of[hubs] = -1        # hubs live on every shard, not one row

    # hub neighbor slices: shard p accumulates hub i's popcount over the
    # neighbors p OWNS; hub–hub neighbors ride on shard 0 only, so every
    # edge contributes to exactly one partial count and the ring-combined
    # total equals the unsharded popcount bit-for-bit
    hub_nbr_loc = None
    hub_ring_words = 0
    if H:
        slices: list[list[np.ndarray]] = [[] for _ in range(Pn)]
        hub_lut = np.full(n, -1, np.int64)
        hub_lut[hubs] = hub_row0 + np.arange(H)
        for i, h in enumerate(hubs):
            nbrs = graph.nbr[h, :graph.deg[h]].astype(np.int64)
            owners = partition.part[nbrs]
            for p in range(Pn):
                mine = nbrs[owners == p]
                rows = row_of[mine]
                if p == 0:
                    rows = np.concatenate(
                        [rows, hub_lut[nbrs[owners < 0]]]
                    )
                slices[p].append(rows)
        hd_max = max(
            (r.size for per_p in slices for r in per_p), default=1
        )
        hd_max = max(hd_max, 1)
        if hd_max > _UNROLL_MAX:
            # wide hubs take the segment-reshape popcount (see
            # make_halo_rollout), which needs UNROLL_MAX | hd_max; the pad
            # slots gather the zero row and contribute 0
            hd_max += -hd_max % _UNROLL_MAX
        hub_nbr_loc = np.full((Pn, H, hd_max), zero_row, np.int32)
        for p in range(Pn):
            for i, rows in enumerate(slices[p]):
                hub_nbr_loc[p, i, :rows.size] = rows
        n_planes_hub = max(int(graph.deg[hubs].max()).bit_length(), 1)
        hub_ring_words = Pn * (Pn - 1) * H * n_planes_hub

    # static exchange schedule, grouped by shard offset delta = (p - q) % P:
    # sender q ships the boundary nodes that shard p = (q + delta) % P
    # ghosts; both sides list them sorted by global id (partition_ghosts),
    # so send_idx[q] and recv_idx[p] describe the same slab independently
    by_delta: dict[int, dict[int, np.ndarray]] = {}
    for p in range(Pn):
        gl = ghosts[p]
        owners = partition.part[gl]
        for q in np.unique(owners):
            delta = int((p - q) % Pn)
            by_delta.setdefault(delta, {})[int(q)] = gl[owners == q]
    schedule = []
    for delta in sorted(by_delta):
        per_q = by_delta[delta]
        m = max(nodes.size for nodes in per_q.values())
        send_idx = np.full((Pn, m), zero_row, np.int32)
        recv_idx = np.full((Pn, m), trash_row, np.int32)
        for q, nodes in per_q.items():
            p = (q + delta) % Pn
            send_idx[q, :nodes.size] = row_of[nodes]
            recv_idx[p, :nodes.size] = n_local_max + ghost_pos[p][nodes]
        schedule.append((delta, send_idx, recv_idx))

    return HaloTables(
        n=n,
        n_local_max=n_local_max,
        n_ghost_max=n_ghost_max,
        dmax=dmax,
        counts=counts,
        ghost_counts=ghost_counts,
        nbr_loc=nbr_loc,
        deg_loc=deg_loc,
        real=real,
        owned_global=owned_global,
        ghost_global=ghost_global,
        loc_of=loc_of,
        schedule=tuple(schedule),
        n_halo_words=int(ghost_counts.sum()),
        n_slab_words=Pn * sum(s.shape[1] for (_, s, _) in schedule),
        hub_global=hubs if H else None,
        hub_deg=graph.deg[hubs].astype(np.int32) if H else None,
        hub_nbr_loc=hub_nbr_loc,
        hub_ring_words=hub_ring_words,
    )


def exchange_perms(tables: HaloTables) -> tuple:
    """The static ``ppermute`` permutation per schedule offset."""
    Pn = tables.P
    return tuple(
        tuple((q, (q + delta) % Pn) for q in range(Pn))
        for (delta, _, _) in tables.schedule
    )


# ---------------------------------------------------------------------------
# the shard step: K1/K2′ on the shard layout, and its plain twin
# ---------------------------------------------------------------------------


def _mask(cond: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, -1, 0).to(torch.int32)[:, None]


def shard_step_plain(nbr_l, deg_l, sp, dst=None, *, n_update: int,
                     rule: str = "majority", tie: str = "stay"):
    """The plain PyTorch twin of one K1/K2′ launch on the shard layout:
    rows ``[0, n_update)`` of ``dst`` get the carry-save count of their
    neighbor rows in ``sp`` (``nbr_l``: local row indices, ghost slots at
    the zero row) and the comparator and rule/tie epilogue of
    :mod:`graphdyn_torch.ops.packed`; no other row of ``dst`` is written.
    Returns ``dst`` (default: a copy of ``sp``). The tests hold it to the
    JAX per-shard step; on the card it is the kernel's yardstick and
    nothing else."""
    rule, tie = Rule(rule), TieBreak(tie)
    nbr = nbr_l[:n_update].to(torch.int64)
    deg = deg_l[:n_update]
    planes = [sp.new_zeros((n_update, sp.shape[1]))
              for _ in range(packed_cuda.n_planes(nbr_l.shape[1]))]
    for j in range(nbr.shape[1]):
        _csa_add_one(planes, sp.index_select(0, nbr[:, j]))
    thr = deg // 2
    thr_bits = [_mask((thr >> k) & 1 == 1) for k in range(len(planes))]
    gt, eq = _compare_planes(planes, thr_bits)
    out = sp.clone() if dst is None else dst
    out[:n_update] = _rule_tie_combine(gt, eq & _mask(deg % 2 == 0),
                                       sp[:n_update], rule, tie)
    return out


class ShardStep:
    """One rank's synchronous step on its shard (``src -> dst``, the real
    owned rows ``[0, n_update)`` written): the kernel launch on a CUDA
    state (raises if it cannot build or launch; no plain fallback),
    :func:`shard_step_plain` on a CPU state."""

    def __init__(self, nbr_l: torch.Tensor, deg_l: torch.Tensor, *,
                 n_update: int, rule: str, tie: str):
        self.nbr, self.deg = nbr_l.contiguous(), deg_l.contiguous()
        self.n_update = int(n_update)
        self.rule, self.tie = Rule(rule), TieBreak(tie)
        self.d_uniform = packed_cuda.fast_path_degree(
            self.deg[:self.n_update], self.rule.value) if self.n_update else 0

    def __call__(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """``dst`` with its real owned rows stepped from ``src``; its other
        rows are left as they are."""
        if src.device.type == "cpu":
            return shard_step_plain(self.nbr, self.deg, src, dst,
                                    n_update=self.n_update, rule=self.rule,
                                    tie=self.tie)
        packed_cuda.packed_step_rows(
            self.nbr, self.deg, src, dst, n_update=self.n_update,
            minority=self.rule == Rule.MINORITY,
            change=self.tie == TieBreak.CHANGE, d_uniform=self.d_uniform)
        return dst


# ---------------------------------------------------------------------------
# the packed (word) halo rollout
# ---------------------------------------------------------------------------


class _Shard(NamedTuple):
    """One rank's device copy of its tables."""

    step: ShardStep
    sends: list            # int64[m_delta] local rows, one per offset
    recvs: list
    deltas: list
    hub_nbr: torch.Tensor | None   # int64[H, hd_max]


def _shard_tables(tables: HaloTables, p: int, device, rule: str,
                  tie: str) -> _Shard:
    dev = device
    step = ShardStep(
        torch.as_tensor(tables.nbr_loc[p], device=dev),
        torch.as_tensor(tables.deg_loc[p], device=dev),
        n_update=int(tables.counts[p]), rule=rule, tie=tie)
    return _Shard(
        step=step,
        sends=[torch.as_tensor(s[p], dtype=torch.int64, device=dev)
               for (_, s, _) in tables.schedule],
        recvs=[torch.as_tensor(r[p], dtype=torch.int64, device=dev)
               for (_, _, r) in tables.schedule],
        deltas=[int(d) for (d, _, _) in tables.schedule],
        hub_nbr=(torch.as_tensor(tables.hub_nbr_loc[p], dtype=torch.int64,
                                 device=dev) if tables.n_hubs else None),
    )


def _ripple_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bit-plane ripple-carry sum of two ``[planes, ...]`` packed counts
    (exact while the total fits the planes)."""
    out = torch.empty_like(a)
    carry = torch.zeros_like(a[0])
    for k in range(a.shape[0]):
        out[k] = a[k] ^ b[k] ^ carry
        carry = (a[k] & b[k]) | (carry & (a[k] ^ b[k]))
    return out


class _HubUpdate:
    """The replicated hubs' step: every rank's partial popcount over the
    hub neighbors it owns (carry-save, from the pre-step state), summed by
    a ring of ``P − 1`` ``+1`` exchanges of the bit planes, then the
    comparator against the ORIGINAL hub degrees and the rule/tie epilogue,
    identical on every rank (``halo.py:393-436``)."""

    def __init__(self, tables: HaloTables, device, rule, tie):
        hd = tables.hub_deg.astype(np.int64)
        self.H, self.h0 = tables.n_hubs, tables.hub_row0
        self.planes = max(int(hd.max()).bit_length(), 1)
        thr = torch.as_tensor(hd // 2, device=device)
        self.thr_bits = [_mask((thr >> k) & 1 == 1)
                         for k in range(self.planes)]
        self.even = _mask(torch.as_tensor(hd % 2 == 0, device=device))
        self.rule, self.tie = Rule(rule), TieBreak(tie)

    def partial_planes(self, src, hub_nbr) -> torch.Tensor:
        """This rank's partial counts ``[planes, H, W]`` over the rows
        ``hub_nbr`` of ``src``: carry-save bit planes up to ``UNROLL_MAX``
        slots, the segmented integer counts of the bucketed wide path past
        it (the JAX package's split; both are the exact count)."""
        W = src.shape[1]
        if hub_nbr.shape[1] > _UNROLL_MAX:
            cnt = _wide_bucket_counts(src, hub_nbr)         # [H, W, 32]
            return torch.stack([_pack_lanes((cnt >> b) & 1)
                                for b in range(self.planes)])
        hpl = [src.new_zeros((self.H, W)) for _ in range(self.planes)]
        for j in range(hub_nbr.shape[1]):
            _csa_add_one(hpl, src.index_select(0, hub_nbr[:, j]))
        return torch.stack(hpl)

    def __call__(self, src, hub_nbr, mesh, node_axis, prev=None):
        """The new hub rows from the partial counts over ``hub_nbr``'s rows
        of ``src``; ``prev`` (default ``src``'s hub rows) is the hubs'
        pre-step state."""
        acc = self.partial_planes(src, hub_nbr)
        buf = acc
        for _ in range(axis_size(mesh, node_axis) - 1):
            (buf,) = exchange([buf], [1], mesh, node_axis)
            acc = _ripple_add(acc, buf)
        gt, eq = _compare_planes(list(acc), self.thr_bits)
        if prev is None:
            prev = src[self.h0:self.h0 + self.H]
        return _rule_tie_combine(gt, eq & self.even, prev, self.rule,
                                 self.tie)


def _exchange_rows(sp: torch.Tensor, shard: _Shard, mesh,
                   node_axis: str) -> None:
    """Refresh this rank's ghost rows in place from the owners' boundary
    rows: one slab per schedule offset, all in one batch."""
    slabs = [sp.index_select(0, s) for s in shard.sends]
    for r_idx, buf in zip(shard.recvs,
                          exchange(slabs, shard.deltas, mesh, node_axis)):
        sp.index_copy_(0, r_idx, buf)


def make_halo_rollout(mesh, tables: HaloTables, *, steps: int,
                      rule: str = "majority", tie: str = "stay",
                      node_axis: str = NODE, device=None):
    """The halo rollout of this rank, ``f(sp_local, stats=None) ->
    sp_local'``, over ``mesh``'s ``node_axis`` (size ``tables.P``):
    ``sp_local`` is this rank's ``int32[n_rows, W]`` shard (never written;
    its zero row 0, as :func:`scatter_shard` places it). Each step is one
    K1/K2′ launch on the shard layout (the plain twin on the CPU), which
    writes the real owned rows of the other buffer, the hub update when the
    partition split hubs, and the exchange, which refresh the hub and ghost
    rows of that buffer. The other buffer's remaining rows are copied from
    the placed shard once, when it is made.

    ``stats`` (a dict) accumulates ``step_s`` and ``exchange_s``, host
    seconds with the device synchronised around each part, and ``steps``:
    the timing split, which costs three synchronisations per step; leave it
    None on a run that is not being measured."""
    if axis_size(mesh, node_axis) != tables.P:
        raise ValueError(f"mesh {node_axis!r} axis size "
                         f"{axis_size(mesh, node_axis)} != partition P "
                         f"{tables.P}")
    p = axis_index(mesh, node_axis)
    dev = rank_device(device)
    shard = _shard_tables(tables, p, dev, rule, tie)
    hubs = _HubUpdate(tables, dev, rule, tie) if tables.n_hubs else None

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n_own = shard.step.n_update

    def second(x: torch.Tensor) -> torch.Tensor:
        # a buffer whose rows past the real owned ones are the placed
        # shard's: the rows no step writes (pad, pad ghost slots, zero)
        # stay equal in the two buffers of the ping-pong
        y = torch.empty_like(x)
        y[n_own:] = x[n_own:]
        return y

    def rollout(sp_local: torch.Tensor, stats: dict | None = None):
        src = sp_local.to(dev).contiguous()
        spare = second(src)
        for _ in range(steps):
            if spare is None:
                spare = second(sp_local)
            if stats is not None:
                sync()
            t0 = time.perf_counter() if stats is not None else 0.0
            dst = shard.step(src, spare)
            if hubs is not None:
                dst[hubs.h0:hubs.h0 + hubs.H] = hubs(src, shard.hub_nbr,
                                                     mesh, node_axis)
            if stats is not None:
                sync()
                t1 = time.perf_counter()
            _exchange_rows(dst, shard, mesh, node_axis)
            if stats is not None:
                sync()
                stats["step_s"] = stats.get("step_s", 0.0) + t1 - t0
                stats["exchange_s"] = (stats.get("exchange_s", 0.0)
                                       + time.perf_counter() - t1)
                stats["steps"] = stats.get("steps", 0) + 1
            # ping-pong; the caller's input is never a target
            spare = src if src is not sp_local else None
            src = dst
        return src

    return rollout


def scatter_state(tables: HaloTables, sp: np.ndarray) -> np.ndarray:
    """Global packed state ``uint32[n, W]`` -> per-shard halo layout
    ``uint32[P, n_rows, W]`` (owned rows + CONSISTENT ghost rows, pads and
    the trash/zero rows zeroed)."""
    sp = np.asarray(sp)
    W = sp.shape[1]
    out = np.zeros((tables.P, tables.n_rows, W), np.uint32)
    nm = tables.n_local_max
    h0 = tables.hub_row0
    for p in range(tables.P):
        cnt = int(tables.counts[p])
        out[p, :cnt] = sp[tables.owned_global[p, :cnt]]
        gcnt = int(tables.ghost_counts[p])
        if gcnt:
            out[p, nm:nm + gcnt] = sp[tables.ghost_global[p, :gcnt]]
        if tables.n_hubs:
            out[p, h0:h0 + tables.n_hubs] = sp[tables.hub_global]
    return out


def scatter_shard(tables: HaloTables, sp: np.ndarray, p: int) -> np.ndarray:
    """Shard ``p`` of :func:`scatter_state` alone (what one rank places)."""
    sp = np.asarray(sp)
    out = np.zeros((tables.n_rows, sp.shape[1]), np.uint32)
    nm, h0 = tables.n_local_max, tables.hub_row0
    cnt, gcnt = int(tables.counts[p]), int(tables.ghost_counts[p])
    out[:cnt] = sp[tables.owned_global[p, :cnt]]
    if gcnt:
        out[nm:nm + gcnt] = sp[tables.ghost_global[p, :gcnt]]
    if tables.n_hubs:
        out[h0:h0 + tables.n_hubs] = sp[tables.hub_global]
    return out


def gather_state(tables: HaloTables, sp_loc: np.ndarray) -> np.ndarray:
    """Per-shard halo layout back to the global ``uint32[n, W]`` order."""
    sp_loc = np.asarray(sp_loc)
    out = np.empty((tables.n, sp_loc.shape[2]), np.uint32)
    for p in range(tables.P):
        cnt = int(tables.counts[p])
        out[tables.owned_global[p, :cnt]] = sp_loc[p, :cnt]
    if tables.n_hubs:
        # hub rows are replicated and updated identically on every shard
        h0 = tables.hub_row0
        out[tables.hub_global] = sp_loc[0, h0:h0 + tables.n_hubs]
    return out


class HaloProgram:
    """A halo rollout bound to one (graph, partition, mesh) on this rank:
    the tables are built and placed once, repeated calls reuse them.
    ``mesh=None`` makes a 1-D ``node`` mesh over the world's ranks, whose
    count must be ``partition.P``. Every rank of the node axis calls each
    method together."""

    def __init__(self, graph: Graph, partition: Partition, *, steps: int,
                 rule: str = "majority", tie: str = "stay", mesh=None,
                 node_axis: str = NODE, tables: HaloTables | None = None,
                 device=None):
        self.tables = tables if tables is not None else build_halo_tables(
            graph, partition)
        if mesh is None:
            mesh = make_mesh((self.tables.P,), (node_axis,), device=device)
        if axis_size(mesh, node_axis) != self.tables.P:
            raise ValueError(
                f"mesh {node_axis!r} axis size {axis_size(mesh, node_axis)} "
                f"!= partition P {self.tables.P}")
        self.mesh, self.node_axis, self.steps = mesh, node_axis, steps
        self.device = rank_device(device)
        self.rank = axis_index(mesh, node_axis)
        self.stats: dict = {}
        self._fn = make_halo_rollout(mesh, self.tables, steps=steps,
                                     rule=rule, tie=tie, node_axis=node_axis,
                                     device=self.device)

    def place(self, sp) -> torch.Tensor:
        """This rank's shard of a global ``[n, W]`` state (owned rows and
        consistent ghost and hub rows; pads, trash and zero rows 0)."""
        from graphdyn_torch.interop import words_from_numpy, words_to_numpy

        sp = np.asarray(words_to_numpy(sp) if isinstance(sp, torch.Tensor)
                        else sp).astype(np.uint32)
        return words_from_numpy(
            scatter_shard(self.tables, sp, self.rank)).to(self.device)

    def advance(self, sp_loc: torch.Tensor, *, timed: bool = False):
        """``steps`` synchronous updates of this rank's placed shard (the
        input is not written). Emits the per-step halo-traffic gauge while
        an obs recorder is active; ``timed`` splits the wall between the
        step and the exchange into :attr:`stats`."""
        from graphdyn_torch import obs

        if obs.enabled():
            W = int(sp_loc.shape[1])
            obs.gauge("parallel.halo.bytes_per_step",
                      self.tables.halo_bytes_per_step(W), P=self.tables.P,
                      W=W, steps=self.steps)
        return self._fn(sp_loc, self.stats if timed else None)

    def fetch(self, sp_loc: torch.Tensor) -> np.ndarray:
        """Every rank's shard gathered, back in the global ``uint32[n, W]``
        order, on every rank."""
        from graphdyn_torch.interop import words_to_numpy

        # graftlint: disable-next-line=GD013  fetch() is the one-off global read-back of the result, not a step's exchange
        allp = all_gather_tiled(sp_loc.contiguous()[None], self.mesh,
                                self.node_axis, dim=0)
        return gather_state(self.tables, words_to_numpy(
            allp.reshape(-1, allp.shape[2]).cpu()).reshape(allp.shape))

    def __call__(self, sp) -> torch.Tensor:
        """One-shot: global state in, global state out, as ``int32[n, W]``
        words on this rank's device (bit-exact to the unsharded
        :func:`graphdyn_torch.ops.packed.packed_rollout`)."""
        from graphdyn_torch.interop import words_from_numpy

        out = self.fetch(self.advance(self.place(sp)))
        return words_from_numpy(out).to(self.device)


# ---------------------------------------------------------------------------
# int8 (SA spin vector) halo primitives: the node axis of the sharded SA
# solver rides the same tables, with columns instead of rows
# ---------------------------------------------------------------------------


def sa_halo_local_step(nbr_l, s, real_l, R_coef: int, C_coef: int):
    """One synchronous int8 update of the owned columns of a rank's SA
    state ``s: int8[Rl, n_rows]`` (columns laid out as the halo rows);
    ghost-padded neighbor slots read the zero column, pad columns stay
    frozen. Returns a new tensor."""
    nm, dmax = nbr_l.shape
    Rl = s.shape[0]
    s32 = s.to(torch.int32)
    sums = s32.index_select(1, nbr_l.reshape(-1)).reshape(
        Rl, nm, dmax).sum(dim=2)
    out = (R_coef * torch.sign(2 * sums + C_coef * s32[:, :nm])
           ).to(torch.int8)
    out = torch.where(real_l[None, :], out, s[:, :nm])
    return torch.cat([out, s[:, nm:]], dim=1)


def sa_halo_exchange(s, sends, recvs, deltas, mesh, node_axis: str = NODE):
    """Refresh the ghost columns of a rank's SA state from the owners'
    boundary columns: one slab per schedule offset, the packed rollout's
    exchange with the replica axis leading. Returns a new tensor."""
    s = s.clone()
    slabs = [s.index_select(1, i).contiguous() for i in sends]
    for r_idx, buf in zip(recvs, exchange(slabs, deltas, mesh, node_axis)):
        s.index_copy_(1, r_idx, buf)
    return s


def sa_halo_cols(tables: HaloTables, s: np.ndarray) -> np.ndarray:
    """Global int8 spins ``[R, n]`` -> halo column layout
    ``[R, P * n_rows]`` (owned + consistent ghosts; trash/zero columns 0,
    so ghost-padded neighbor slots contribute 0 to neighbor sums).
    Hub-split tables additionally replicate every hub's spin into the hub
    columns ``[hub_row0, trash_row)`` of EVERY shard — the vertex-cut
    invariant the SA solver maintains step to step (identical hub updates
    on all shards) and re-establishes on every accepted hub flip."""
    s = np.asarray(s, np.int8)
    R = s.shape[0]
    nm = tables.n_local_max
    out = np.zeros((R, tables.P * tables.n_rows), np.int8)
    view = out.reshape(R, tables.P, tables.n_rows)
    h0 = tables.hub_row0
    for p in range(tables.P):
        cnt = int(tables.counts[p])
        view[:, p, :cnt] = s[:, tables.owned_global[p, :cnt]]
        gcnt = int(tables.ghost_counts[p])
        if gcnt:
            view[:, p, nm:nm + gcnt] = s[:, tables.ghost_global[p, :gcnt]]
        if tables.n_hubs:
            view[:, p, h0:h0 + tables.n_hubs] = s[:, tables.hub_global]
    return out


def sa_halo_uncols(tables: HaloTables, s_cols: np.ndarray) -> np.ndarray:
    """Halo column layout back to global int8 spins ``[R, n]`` (hub spins
    read from shard 0's replicated columns — every shard carries the same
    values by the vertex-cut invariant)."""
    s_cols = np.asarray(s_cols)
    R = s_cols.shape[0]
    view = s_cols.reshape(R, tables.P, tables.n_rows)
    out = np.empty((R, tables.n), np.int8)
    for p in range(tables.P):
        cnt = int(tables.counts[p])
        out[:, tables.owned_global[p, :cnt]] = view[:, p, :cnt]
    if tables.n_hubs:
        h0 = tables.hub_row0
        out[:, tables.hub_global] = view[:, 0, h0:h0 + tables.n_hubs]
    return out


def graph_from_tables(nbr, deg) -> Graph:
    """Reconstruct a host :class:`Graph` from the padded device tables (the
    ``packed_rollout(partition=...)`` entry has only ``nbr``/``deg`` in
    hand). Each undirected edge appears twice in ``nbr``; the ``u < v``
    filter dedups."""
    nbr_h = np.asarray(nbr).astype(np.int32)
    deg_h = np.asarray(deg).astype(np.int32)
    n, dmax = nbr_h.shape
    u = np.repeat(np.arange(n, dtype=np.int64), dmax)
    v = nbr_h.reshape(-1).astype(np.int64)
    keep = (v != n) & (u < v)
    edges = np.stack([u[keep], v[keep]], axis=1).astype(np.int32)
    return Graph(nbr=nbr_h, deg=deg_h, edges=edges)


def halo_rollout(nbr, deg, sp, steps: int, *, partition: Partition,
                 rule: str = "majority", tie: str = "stay", mesh=None,
                 node_axis: str = NODE):
    """One-shot partitioned rollout, the ``partition=`` path of
    :func:`graphdyn_torch.ops.packed.packed_rollout` for P >= 2 (which
    handles P = 1 itself): every rank of the node axis calls it with the
    same global state and receives the same global result on its device."""
    if partition.P < 2:
        raise ValueError(
            "halo_rollout needs a partition with P >= 2 "
            "(P=1 is packed_rollout itself)"
        )
    dev = sp.device if isinstance(sp, torch.Tensor) else None
    nbr_h = nbr.cpu().numpy() if isinstance(nbr, torch.Tensor) else nbr
    deg_h = deg.cpu().numpy() if isinstance(deg, torch.Tensor) else deg
    prog = HaloProgram(graph_from_tables(nbr_h, deg_h), partition,
                       steps=steps, rule=rule, tie=tie, mesh=mesh,
                       node_axis=node_axis,
                       device=dev.type if dev is not None else None)
    return prog(sp)
