"""The multi-card SA solver: the consensus-stop chain over a ``DeviceMesh``
(the port of ``graphdyn/parallel/sa_sharded.py``).

The chain is the unsharded solver's (:mod:`graphdyn_torch.models.sa`): the
same proposal draw (injected streams, or the port's counter stream keyed by
``seed + r``), the Metropolis accept with the annealing caps, the stop when
the rolled-out end state is all +1, the ``2n³`` timeout sentinel
``m_final = 2`` and per-replica freezing. Replicas (and the temperature
ladder they carry) split over the mesh's ``"replica"`` dimension and pad up
to its size with converged all-+1 dummies that start inactive; the node
axis of a large graph splits over ``"node"`` in one of two modes:

- ``node_mode='gather'``: contiguous node blocks, one int8 ``all_gather``
  per synchronous rollout step (:mod:`graphdyn_torch.parallel.sharded`);
- ``node_mode='halo'``: the edge-cut partition's halo layout, one exchange
  of boundary columns per step (:mod:`graphdyn_torch.parallel.halo`), hubs
  vertex-cut replicated with one integer ``all_reduce`` per step.

``rollout_mode='lightcone'`` (node dimension of size 1) runs the unsharded
light-cone chain on each rank's replica block (:func:`graphdyn_torch.
models.sa._sa_loop` over :mod:`graphdyn_torch.ops.lightcone`); its only
collective is the per-chunk live count.

Every rank advances ``chunk_steps`` masked steps between two host reads;
one all-reduce over the world per chunk says whether any chain is still
active, so every rank runs the same chunks (a finished chain's further
steps change nothing, so the chunking cannot change the chain). Under
injected streams the chains equal the JAX package's ``sa_sharded`` bit for
bit in every mode.

Snapshots (``checkpoint_path``): rank 0 saves the UNPADDED GLOBAL state,
gathered from every rank, under the run's fingerprint; a run resumes from
it at any mesh shape, node mode or rollout mode. A graceful shutdown
(SIGTERM) on any rank makes every rank snapshot and raise
``ShutdownRequested`` at the same chunk boundary (exit 75 in the CLI).
``layout='streamed'`` (the sharded out-of-core chain) comes with
ROADMAP.md A15b and is refused.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch import obs
from graphdyn_torch.config import SAConfig
from graphdyn_torch.models.sa import (
    CHUNK_STEPS,
    SAResult,
    _sa_loop,
    _SAState,
    chain_keys,
    draw_sa_proposal,
    metropolis_anneal_update,
    prepare_sa_inputs,
    resolve_dtype,
    sa_consts,
)
from graphdyn_torch.graphs import partition_graph
from graphdyn_torch.ops.dynamics import rule_coefficients
from graphdyn_torch.ops.lightcone import (
    _neighbor_index,
    batched_trajectory,
    resolve_lightcone_tables,
)
from graphdyn_torch.parallel.halo import (
    build_halo_tables,
    sa_halo_cols,
    sa_halo_exchange,
    sa_halo_local_step,
    sa_halo_uncols,
)
from graphdyn_torch.parallel.mesh import (
    NODE,
    REPLICA,
    WorldSync,
    all_gather_tiled,
    axis_index,
    axis_size,
    init_distributed,
    psum,
    rank_device,
)
from graphdyn_torch.parallel.sharded import (
    _local_step,
    _masked_block_sum,
    _real_mask,
    pad_nodes,
    place_sharded,
)


class _Chain(NamedTuple):
    """One rank's chain state in the full-rollout modes: its spin block
    (gather: ``int8[Rl, n_block]``; halo: ``int8[Rl, n_rows]``) and its
    replica block's scalars."""

    s: torch.Tensor
    sum_end: torch.Tensor   # int32[Rl] (global Σ s_end of the current s)
    a: torch.Tensor
    b: torch.Tensor
    t: torch.Tensor
    m_final: torch.Tensor
    active: torch.Tensor
    key: torch.Tensor       # int64[Rl] stream seeds


class _GatherOps:
    """The node-axis tools of the gather mode: the proposal flip on the
    owning block, the sharded rollout, the pad-free block sum."""

    def __init__(self, mesh, nbr_local, n_real, rollout_steps, R_coef,
                 C_coef, node_axis, device):
        self.mesh, self.nbr, self.node_axis = mesh, nbr_local, node_axis
        self.n_block = None
        self.n_real, self.steps = n_real, rollout_steps
        self.R_coef, self.C_coef = R_coef, C_coef
        self.device = device
        self.mask = None

    def _ready(self, s):
        if self.n_block is None:
            self.n_block = s.shape[1]
            self.mask = _real_mask(self.mesh, self.node_axis, self.n_block,
                                   self.n_real, self.device)

    def flip(self, s, i):
        self._ready(s)
        nb = self.n_block
        local_i = i - axis_index(self.mesh, self.node_axis) * nb
        owned = (local_i >= 0) & (local_i < nb)
        li = local_i.clamp(0, nb - 1)
        s_i_local = torch.gather(s, 1, li[:, None])[:, 0].to(torch.int32)
        flipped = s.scatter(1, li[:, None],
                            (-s_i_local).to(torch.int8)[:, None])
        s_flip = torch.where(owned[:, None], flipped, s)
        return s_flip, torch.where(owned, s_i_local, 0)

    def rollout(self, s):
        self._ready(s)
        for _ in range(self.steps):
            s_full = all_gather_tiled(s, self.mesh, self.node_axis, dim=1)
            s = _local_step(self.nbr, s_full, s, self.mask, self.R_coef,
                            self.C_coef)
        return s

    def block_sum(self, s):
        self._ready(s)
        return _masked_block_sum(s, self.mask)

    def end_sum(self, s, s_i_part=None):
        """The global end sum of the rollout of ``s``; with ``s_i_part``
        (each rank's share of the proposed spins) also their global sum,
        reduced in the same ``all_reduce``."""
        part = self.block_sum(self.rollout(s))
        if s_i_part is None:
            return psum(part, self.mesh, self.node_axis)
        both = psum(torch.stack([part, s_i_part.to(torch.int32)]),
                    self.mesh, self.node_axis)
        return both[0], both[1]


class _HaloOps(_GatherOps):
    """The node-axis tools of the halo mode (``sa_sharded.py:221-438``):
    the flip finds node i's owner and column through ``loc_of`` (a hub is
    flipped on every rank), the flip reaches its ghost copies by one
    exchange before the candidate rollout, and hubs take their partial sums
    from every rank through one integer ``all_reduce`` per step."""

    def __init__(self, mesh, tables, n_real, rollout_steps, R_coef, C_coef,
                 node_axis, device):
        super().__init__(mesh, None, n_real, rollout_steps, R_coef, C_coef,
                         node_axis, device)
        p = axis_index(mesh, node_axis)
        t = tables
        self.t, self.p = t, p
        self.nm, self.H, self.h0 = t.n_local_max, t.n_hubs, t.hub_row0
        self.nbr = torch.as_tensor(t.nbr_loc[p], dtype=torch.int64,
                                   device=device)
        self.real = torch.as_tensor(t.real[p], device=device)
        self.sends = [torch.as_tensor(s[p], dtype=torch.int64, device=device)
                      for (_, s, _) in t.schedule]
        self.recvs = [torch.as_tensor(r[p], dtype=torch.int64, device=device)
                      for (_, _, r) in t.schedule]
        self.deltas = [int(d) for (d, _, _) in t.schedule]
        self.loc_of = torch.as_tensor(t.loc_of, dtype=torch.int64,
                                      device=device)
        self.hub_of = None
        if self.H:
            hub_of = np.full(t.n, -1, np.int64)
            hub_of[t.hub_global] = np.arange(self.H)
            self.hub_of = torch.as_tensor(hub_of, device=device)
            self.hub_nbr = torch.as_tensor(t.hub_nbr_loc[p],
                                           dtype=torch.int64, device=device)

    def _exchange(self, s):
        return sa_halo_exchange(s, self.sends, self.recvs, self.deltas,
                                self.mesh, self.node_axis)

    def flip(self, s, i):
        nm, p = self.nm, self.p
        lg = self.loc_of[i]
        if self.H:
            hu = self.hub_of[i]
            is_hub = hu >= 0
            col = torch.where(is_hub, self.h0 + hu.clamp(min=0), lg % nm)
            owned = (torch.div(lg, nm, rounding_mode="floor") == p) | is_hub
            count_here = torch.where(
                is_hub, torch.full_like(is_hub, p == 0),
                torch.div(lg, nm, rounding_mode="floor") == p)
        else:
            col = lg % nm
            owned = torch.div(lg, nm, rounding_mode="floor") == p
            count_here = owned
        s_i_local = torch.gather(s, 1, col[:, None])[:, 0].to(torch.int32)
        flipped = s.scatter(1, col[:, None],
                            (-s_i_local).to(torch.int8)[:, None])
        s_flip = self._exchange(torch.where(owned[:, None], flipped, s))
        return s_flip, torch.where(count_here, s_i_local, 0)

    def _hub_step(self, s):
        Rl, hd = s.shape[0], self.hub_nbr.shape[1]
        g = s.to(torch.int32).index_select(1, self.hub_nbr.reshape(-1))
        tot = psum(g.reshape(Rl, self.H, hd).sum(dim=2, dtype=torch.int32),
                   self.mesh, self.node_axis)
        s_hub = s[:, self.h0:self.h0 + self.H].to(torch.int32)
        return (self.R_coef * torch.sign(2 * tot + self.C_coef * s_hub)
                ).to(torch.int8)

    def rollout(self, s):
        for _ in range(self.steps):
            hub_new = self._hub_step(s) if self.H else None
            s = sa_halo_local_step(self.nbr, s, self.real, self.R_coef,
                                   self.C_coef)
            if self.H:
                s[:, self.h0:self.h0 + self.H] = hub_new
            s = self._exchange(s)
        return s

    def block_sum(self, s):
        out = torch.where(self.real[None, :], s[:, :self.nm].to(torch.int32),
                          0).sum(dim=1, dtype=torch.int32)
        if self.H and self.p == 0:
            out = out + s[:, self.h0:self.h0 + self.H].to(torch.int32).sum(
                dim=1, dtype=torch.int32)
        return out


def _chunk(ops, st: _Chain, consts: dict, proposals, uniforms, *,
           max_steps: int, injected: bool, stream_len: int, n: int,
           chunk_steps: int) -> _Chain:
    """``chunk_steps`` masked chain steps of one rank (the loop body of
    ``sa_sharded.py:146-180``, with the collectives of ``ops``)."""
    dt = st.a.dtype
    i_all, u_all = draw_sa_proposal(
        st.key, st.t, proposals, uniforms, injected=injected,
        stream_len=stream_len, n=n, dt=dt, steps=chunk_steps)
    s, sum_end, a, b, t = st.s, st.sum_end, st.a, st.b, st.t
    m_final, active = st.m_final, st.active
    for j in range(chunk_steps):
        s_flip, s_i_part = ops.flip(s, i_all[:, j])
        sum_end_flip, s_i = ops.end_sum(s_flip, s_i_part)
        do, sum_end, a, b, t, m_final, active = metropolis_anneal_update(
            active, a, b, t, m_final, sum_end, sum_end_flip, s_i,
            u_all[:, j], max_steps=max_steps, n=n, **consts)
        s = torch.where(do[:, None], s_flip, s)
    return _Chain(s, sum_end, a, b, t, m_final, active, st.key)


def make_sharded_sa_solver(mesh, *, n_real: int, rollout_steps: int,
                           max_steps: int, rule: str = "majority",
                           tie: str = "stay", injected: bool = False,
                           stream_len: int = 1,
                           node_axis: str = NODE,
                           chunk_steps: int = CHUNK_STEPS,
                           lightcone: bool = False, lc_tables=None,
                           device=None):
    """The solver pair ``(init_fn, chunk_fn)`` of one rank (the counterpart
    of ``sa_sharded.py:64``). ``init_fn(nbr_local, s0_local) -> sum_end``
    is the rolled-out end sum of each local replica (global over the node
    axis); ``chunk_fn(nbr_local, state, consts, proposals, uniforms) ->
    state`` advances ``chunk_steps`` masked steps. With ``lightcone=True``
    (node dimension of size 1) the state is the unsharded solver's
    ``_SAState`` carrying the trajectory cache, and ``init_fn`` returns it
    (``lc_tables`` required)."""
    R_coef, C_coef = rule_coefficients(rule, tie)
    dev = rank_device(device)
    if lightcone:
        return _make_lightcone_solver(
            n_real=n_real, rollout_steps=rollout_steps, max_steps=max_steps,
            R_coef=R_coef, C_coef=C_coef, injected=injected,
            stream_len=stream_len, chunk_steps=chunk_steps,
            lc_tables=lc_tables, device=dev)

    def ops_for(nbr_local):
        return _GatherOps(mesh, nbr_local, n_real, rollout_steps, R_coef,
                          C_coef, node_axis, dev)

    def init_fn(nbr_local, s0_local):
        return ops_for(nbr_local).end_sum(s0_local)

    def chunk_fn(nbr_local, st, consts, proposals, uniforms):
        return _chunk(ops_for(nbr_local), st, consts, proposals, uniforms,
                      max_steps=max_steps, injected=injected,
                      stream_len=stream_len, n=n_real,
                      chunk_steps=chunk_steps)

    return init_fn, chunk_fn


def make_halo_sa_solver(mesh, tables, *, n_real: int, rollout_steps: int,
                        max_steps: int, rule: str = "majority",
                        tie: str = "stay", injected: bool = False,
                        stream_len: int = 1, node_axis: str = NODE,
                        chunk_steps: int = CHUNK_STEPS, device=None):
    """The halo-mode solver pair of one rank (``sa_sharded.py:221``): the
    signatures of :func:`make_sharded_sa_solver` without ``nbr_local`` (the
    rank's tables come from ``tables``, a :class:`graphdyn_torch.parallel.
    halo.HaloTables`); the state's spins are the rank's halo columns."""
    R_coef, C_coef = rule_coefficients(rule, tie)
    ops = _HaloOps(mesh, tables, n_real, rollout_steps, R_coef, C_coef,
                   node_axis, rank_device(device))

    def init_fn(s0_local):
        return ops.end_sum(s0_local)

    def chunk_fn(st, consts, proposals, uniforms):
        return _chunk(ops, st, consts, proposals, uniforms,
                      max_steps=max_steps, injected=injected,
                      stream_len=stream_len, n=n_real,
                      chunk_steps=chunk_steps)

    return init_fn, chunk_fn, ops


def _make_lightcone_solver(*, n_real: int, rollout_steps: int,
                           max_steps: int, R_coef: int, C_coef: int,
                           injected: bool, stream_len: int,
                           chunk_steps: int, lc_tables, device):
    """The light-cone pair (``sa_sharded.py:441``): each rank owns whole
    replicas and runs the unsharded light-cone chain on them."""
    if lc_tables is None:
        raise ValueError("the light-cone solver needs lc_tables")

    def init_fn(nbr, s0_local, key, a, b):
        traj = batched_trajectory(nbr, s0_local, rollout_steps, R_coef,
                                  C_coef)
        sum_end = traj[:, rollout_steps, :n_real].sum(dim=1,
                                                      dtype=torch.int32)
        t_dt = torch.int64 if a.dtype == torch.float64 else torch.int32
        Rl = s0_local.shape[0]
        return _SAState(
            s=s0_local, sum_end=sum_end, a=a, b=b,
            t=torch.zeros(Rl, dtype=t_dt, device=device),
            m_final=torch.zeros_like(a), active=torch.zeros(
                Rl, dtype=torch.bool, device=device), key=key,
            chunk_t=torch.zeros((), dtype=torch.int32, device=device),
            traj=traj)

    idx_cache = {}

    def chunk_fn(nbr, st, consts, proposals, uniforms):
        if "idx" not in idx_cache:
            idx_cache["idx"] = _neighbor_index(nbr, n_real)
        return _sa_loop(
            idx_cache["idx"], st._replace(chunk_t=torch.zeros_like(
                st.chunk_t)), consts, proposals, uniforms,
            rollout_steps=rollout_steps, R_coef=R_coef, C_coef=C_coef,
            max_steps=max_steps, injected=injected, stream_len=stream_len,
            chunk_steps=chunk_steps, lc_tables=lc_tables)

    return init_fn, chunk_fn


def sa_sharded(
    graph,
    config: SAConfig | None = None,
    *,
    mesh,
    n_replicas: int | None = None,
    seed: int | None = None,
    s0: np.ndarray | None = None,
    a0=None,
    b0=None,
    proposals: np.ndarray | None = None,
    uniforms: np.ndarray | None = None,
    max_steps: int | None = None,
    dtype="float32",
    replica_axis: str = REPLICA,
    node_axis: str = NODE,
    checkpoint_path: str | None = None,
    checkpoint_interval_s: float = 30.0,
    chunk_steps: int | None = None,
    rollout_mode: str = "full",
    lc_tables=None,
    node_mode: str = "gather",
    partition=None,
    layout: str = "padded",
    device=None,
) -> SAResult:
    """Run R batched SA chains to completion over ``mesh`` (a ``DeviceMesh``
    with ``replica_axis`` and ``node_axis`` dimensions), on every rank of
    it together; every rank returns the same global result. The arguments
    are the JAX package's (``sa_sharded.py:558``); ``chunk_steps`` is the
    number of masked steps between two host reads (default
    :data:`graphdyn_torch.models.sa.CHUNK_STEPS`) and the snapshot
    granularity; ``device`` is this rank's (default its card). While
    recording, each chunk runs in a ``pipeline.sa_sharded.chunk`` span that
    closes once the card has finished it, followed by the ``obs.mem.*``
    gauges (``loop="sa_sharded.chunk"``)."""
    config = config or SAConfig()
    n = graph.n
    dyn = config.dynamics
    dt = resolve_dtype(dtype)
    np_dt = np.float32 if dt == torch.float32 else np.float64
    dev = rank_device(device)
    if layout not in ("padded", "streamed"):
        raise ValueError(
            f"layout must be 'padded' or 'streamed', got {layout!r} "
            "(degree-bucketed layouts relabel nodes — use the unsharded "
            "solver's layout='bucketed')")
    if layout == "streamed":
        raise NotImplementedError(
            "sa_sharded(layout='streamed') is not ported to graphdyn_torch "
            "yet (ROADMAP.md A15b: the sharded out-of-core stream)")
    if rollout_mode not in ("full", "lightcone"):
        raise ValueError(
            f"rollout_mode must be 'full' or 'lightcone', got {rollout_mode!r}")
    if node_mode not in ("gather", "halo"):
        raise ValueError(
            f"node_mode must be 'gather' or 'halo', got {node_mode!r}")
    chunk_steps = CHUNK_STEPS if chunk_steps is None else int(chunk_steps)
    if chunk_steps < 1:
        raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
    rep_shards = axis_size(mesh, replica_axis)
    node_shards = axis_size(mesh, node_axis)
    halo = node_mode == "halo"
    if halo and rollout_mode != "full":
        raise ValueError(
            "node_mode='halo' shards the full-rollout node axis; "
            "rollout_mode='lightcone' keeps whole replicas per device and "
            "has no node axis to exchange")
    if halo and node_shards < 2:
        raise ValueError(
            f"node_mode='halo' needs a node axis of size >= 2 (got "
            f"{node_shards}): with one shard there is no halo to exchange "
            "— use node_mode='gather'")
    (R, seed, s0, a0, b0, proposals, uniforms, max_steps, stream_len,
     injected) = prepare_sa_inputs(
        graph, config, n_replicas=n_replicas, seed=seed, s0=s0, a0=a0, b0=b0,
        proposals=proposals, uniforms=uniforms, max_steps=max_steps,
        dtype=dt)
    tables = None
    if halo:
        # the rendezvous of a multi-host run (a no-op once the mesh exists;
        # the `multihost.init` fault site and its retry policy ride here)
        init_distributed(device=dev)
        if partition is None:
            partition = partition_graph(graph, node_shards, seed=seed or 0)
        if partition.P != node_shards:
            raise ValueError(
                f"partition has P={partition.P} parts but the mesh "
                f"{node_axis!r} axis has size {node_shards}")
        tables = build_halo_tables(graph, partition)
    elif partition is not None:
        raise ValueError("partition= requires node_mode='halo'")
    lightcone = rollout_mode == "lightcone"
    rollout = dyn.p + dyn.c - 1
    if lightcone:
        if node_shards != 1:
            raise ValueError(
                "rollout_mode='lightcone' needs a replica-only mesh (node "
                f"axis size 1, got {node_shards}): each device holds whole "
                "replicas and their trajectory caches")
        lc_tables = resolve_lightcone_tables(graph, rollout, lc_tables,
                                             device=dev)
    elif lc_tables is not None:
        raise ValueError("lc_tables given but rollout_mode is 'full'")

    t_np = np.int64 if dt == torch.float64 else np.int32
    sync = WorldSync(dev)

    ckpt = restored = None
    if checkpoint_path is not None:
        from graphdyn_torch.utils.io import ChainCheckpointer, run_fingerprint

        ckpt = ChainCheckpointer(
            checkpoint_path, kind="sa_sharded_chain", seed=seed,
            # the mesh shape is not part of the identity: the state is saved
            # unpadded and global, so a run resumes on any mesh
            fp=run_fingerprint(
                graph.edges, config, int(max_steps), bool(injected), np_dt,
                "graphdyn_torch counter stream",
                *((np.asarray(proposals), np.asarray(uniforms))
                  if injected else ())),
            interval_s=checkpoint_interval_s, extra_meta={"R": int(R)},
            sync=sync)
        restored = ckpt.load_state(check=lambda a: a["s"].shape == (R, n))

    # replica padding: all-+1 rows at consensus, inactive from the start
    R_pad = (-R) % rep_shards
    Rtot = R + R_pad

    def pad_rep(x, fill):
        x = np.asarray(x)
        if not R_pad:
            return x
        return np.concatenate([x, np.full((R_pad,) + x.shape[1:], fill,
                                          x.dtype)])

    proposals = pad_rep(proposals, 0)
    uniforms = pad_rep(uniforms, 0.0)
    if restored is None:
        s_h = np.asarray(s0, np.int8)
        a_h, b_h = a0.astype(np_dt), b0.astype(np_dt)
        t_h = np.zeros(R, t_np)
        key_h = chain_keys(seed, R, "cpu").numpy()
        sum_end_h = m_final_h = active_h = None
    else:
        s_h = restored["s"].astype(np.int8)
        a_h = restored["a"].astype(np_dt)
        b_h = restored["b"].astype(np_dt)
        t_h = restored["t"].astype(t_np)
        key_h = restored["key"].astype(np.int64)
        sum_end_h = restored["sum_end"].astype(np.int32)
        m_final_h = restored["m_final"].astype(np_dt)
        active_h = restored["active"].astype(bool)

    rep = (replica_axis,)

    def place_rep(x, fill):
        return place_sharded(mesh, pad_rep(x, fill), rep, device=dev)

    s_full = np.concatenate([s_h, np.ones((R_pad, n), np.int8)]) \
        if R_pad else s_h
    key_d = place_rep(key_h, 0)
    a_d, b_d = place_rep(a_h, 1.0), place_rep(b_h, 1.0)
    t_d = place_rep(t_h, 0)
    consts = sa_consts(config, n, dt, dev)
    prop_d = place_sharded(mesh, proposals.astype(np.int64), rep + (None,),
                           device=dev)
    unif_d = place_sharded(mesh, uniforms.astype(np_dt), rep + (None,),
                           device=dev)

    if lightcone:
        nbr_d = torch.as_tensor(np.asarray(graph.nbr, np.int32), device=dev)
        init_fn, chunk_fn = _make_lightcone_solver(
            n_real=n, rollout_steps=rollout, max_steps=max_steps,
            **dict(zip(("R_coef", "C_coef"),
                       rule_coefficients(dyn.rule, dyn.tie))),
            injected=injected, stream_len=stream_len,
            chunk_steps=chunk_steps, lc_tables=lc_tables, device=dev)
        s_loc = place_sharded(mesh, s_full, rep + (None,), device=dev)
        st = init_fn(nbr_d, s_loc, key_d, a_d, b_d)
        sum_end_loc = st.sum_end

        def advance(x):
            return chunk_fn(nbr_d, x, consts, prop_d, unif_d)

        def spins_local(x):
            return x.traj[:, 0, :n]
    else:
        if halo:
            init_fn, chunk_fn, hops = make_halo_sa_solver(
                mesh, tables, n_real=n, rollout_steps=rollout,
                max_steps=max_steps, rule=dyn.rule, tie=dyn.tie,
                injected=injected, stream_len=stream_len,
                node_axis=node_axis, chunk_steps=chunk_steps, device=dev)
            s_loc = place_sharded(mesh, sa_halo_cols(tables, s_full),
                                  rep + (node_axis,), device=dev)
            sum_end_loc = init_fn(s_loc)

            def advance(x):
                return chunk_fn(x, consts, prop_d, unif_d)
        else:
            nbr_pad, n_pad = pad_nodes(graph, node_shards)
            nbr_loc = place_sharded(mesh, nbr_pad.astype(np.int64),
                                    (node_axis, None), device=dev)
            init_fn, chunk_fn = make_sharded_sa_solver(
                mesh, n_real=n, rollout_steps=rollout, max_steps=max_steps,
                rule=dyn.rule, tie=dyn.tie, injected=injected,
                stream_len=stream_len, node_axis=node_axis,
                chunk_steps=chunk_steps, device=dev)
            s_pad = np.concatenate(
                [s_full, np.ones((Rtot, n_pad - n), np.int8)], axis=1)
            s_loc = place_sharded(mesh, s_pad, rep + (node_axis,),
                                  device=dev)
            sum_end_loc = init_fn(nbr_loc, s_loc)

            def advance(x):
                return chunk_fn(nbr_loc, x, consts, prop_d, unif_d)

        def spins_local(x):
            return x.s

    if sum_end_h is None:
        # the initial stop test on the host, as the JAX package does it
        sum_end_h = _gather_rep(sum_end_loc, mesh, replica_axis)[:R]
        m_final_h = (sum_end_h.astype(np_dt) / np_dt(n)).astype(np_dt)
        active_h = m_final_h < 1.0
    fields = dict(sum_end=place_rep(sum_end_h, n),
                  m_final=place_rep(m_final_h, 1.0),
                  active=place_rep(active_h, False))
    if lightcone:
        state = st._replace(t=t_d, **fields)
    else:
        state = _Chain(s=s_loc, a=a_d, b=b_d, t=t_d, key=key_d, **fields)

    def global_s(x) -> np.ndarray:
        """The current spins, unpadded and in the caller's node order, on
        every rank (a collective)."""
        sl = spins_local(x)
        if not lightcone:
            sl = all_gather_tiled(sl.contiguous(), mesh, node_axis, dim=1)
        sl = _gather_rep(sl, mesh, replica_axis)
        if halo:
            return sa_halo_uncols(tables, sl[:R])
        return sl[:R, :n]

    def active(x) -> bool:
        return sync.any(bool(x.active.any()))[0]

    chunks = [0]

    def step(x):
        rec = obs.current()
        with rec.span("pipeline.sa_sharded.chunk", chunk=chunks[0]):
            x = advance(x)
            if rec.enabled:
                # fenced as the JAX package fences its gauges: stats read
                # while the chunk is in flight would be a chunk late
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                obs.memband.emit_memory_gauges(dev, loop="sa_sharded.chunk",
                                               chunk=chunks[0])
        chunks[0] += 1
        return x

    def snapshot(x) -> dict:
        out = {k: _gather_rep(getattr(x, k), mesh, replica_axis)[:R]
               for k in ("key", "a", "b", "t", "m_final", "active",
                         "sum_end")}
        out["s"] = global_s(x)
        return out

    if ckpt is None:
        while active(state):
            state = step(state)
    else:
        state = ckpt.drive(state, advance=step, active=active,
                           payload=snapshot)

    s_final = global_s(state)
    mag = (s_final.astype(np.float64).sum(axis=1) / n).astype(np_dt)
    return SAResult(
        s=s_final,
        mag_reached=mag,
        num_steps=_gather_rep(state.t, mesh, replica_axis)[:R],
        m_final=_gather_rep(state.m_final, mesh, replica_axis)[:R],
    )


def _gather_rep(x: torch.Tensor, mesh, replica_axis: str) -> np.ndarray:
    """A replica-block tensor gathered over the replica axis, as host
    numpy on every rank."""
    return all_gather_tiled(x.contiguous(), mesh, replica_axis,
                            dim=0).cpu().numpy()
