"""BDCM entropy λ-ladders (the port of ``graphdyn/models/entropy.py``): the
notebook's procedure (`ER_BDCM_entropy.ipynb:394-515`).

For each λ of a ladder: (a) write the closed-form leaf messages, (b) iterate
the BDCM sweep to a fixed point warm-started from the previous λ, (c) record
the Bethe free entropy φ, the BP mean initial magnetization m_init and the
tilted entropy ``s(m_init) = φ + λ·m_init``; stop early when the entropy
crosses ``ent_floor`` or a fixed point fails (the reference's ``counts``
sentinel, `ipynb:429-431,446-447`), or on the opt-in plateau.

The sweeps run on the device, each one launch of the BDCM sweep kernel on
the card (:mod:`graphdyn_torch.ops.bdcm_sweep`); each fixed point advances in chunks
of masked sweeps with one host read per chunk (:func:`graphdyn_torch.ops.
bdcm.fixed_point_sweeps`) where the JAX package runs a device while-loop.

- :func:`entropy_sweep`: one graph, through the cell executor at G=1
  (:class:`graphdyn_torch.pipeline.entropy_group.EntropyCellExec`, the
  per-group factor), so that it and the grouped grid are one program family.
- :func:`entropy_ensemble`: congruent graphs (RRG instances), one launch per
  sweep over the ensemble axis with one λ (the shared factor), one joint
  fixed point.
- :func:`entropy_ensemble_union`: any graphs, as one disjoint union (the
  shared factor, invalid sources masked); per-member φ and m_init by
  reductions over each member's contiguous block of nodes and edges, in a
  fixed order (no atomics), so two runs agree bit for bit.
- :func:`entropy_grid`: the notebook's deg × rep × λ driver on fresh ER
  instances, grouped (cells advancing in lockstep chunks) or serial.

Entry points take ``device=`` (default CUDA; a CUDA-less host raises unless
given ``device='cpu'``). Not ported yet, each refused with
``NotImplementedError``: ``checkpointer=``/``checkpoint_path=`` and the
ladder's fault, shutdown and heartbeat sites (ROADMAP A16), ``mesh=``
(A15), the obs spans (A17), ``graph_method='networkx'`` (A1) and plotting
(A17).
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.config import EntropyConfig
from graphdyn_torch.graphs import (
    Graph,
    disjoint_union,
    erdos_renyi_graph,
    remove_isolates,
)
from graphdyn_torch.ops.bdcm import (
    CHUNK_SWEEPS,
    BDCMData,
    EnsembleBDCM,
    make_edge_partition,
    make_ensemble_free_entropy,
    make_ensemble_leaf_setter,
    make_ensemble_m_init,
    make_ensemble_sweep,
    make_fixed_point,
    make_leaf_setter,
    make_m_init_edge_terms,
    make_node_partition,
    run_fixed_point,
)
from graphdyn_torch.models.hpr import _not_ported
from graphdyn_torch.pipeline.entropy_group import (
    EntropyCellExec,
    run_cell_ladder,
)
from graphdyn_torch.utils.platform import resolve_device

log = logging.getLogger("graphdyn_torch.models")


def _refuse(checkpointer=None, checkpoint_path=None, mesh=None) -> None:
    if checkpointer is not None or checkpoint_path is not None:
        raise _not_ported("checkpointing (checkpointer=/checkpoint_path=)",
                          "A16: checkpoints and resilience")
    if mesh is not None:
        raise _not_ported("mesh=", "A15: parallel/ onto torch.distributed")


def lambda_ladder(config: EntropyConfig) -> np.ndarray:
    """The configured λ ladder 0..lmbd_max in lmbd_step increments
    (`ipynb:480-482`); rounded count so e.g. (0.3, 0.1) gives 4 points."""
    return np.linspace(
        0.0, config.lmbd_max, int(round(config.lmbd_max / config.lmbd_step)) + 1
    )


class EntropyResult(NamedTuple):
    lambdas: np.ndarray    # ladder values actually visited [count]
    ent: np.ndarray        # φ per λ
    m_init: np.ndarray     # BP mean initial magnetization per λ
    ent1: np.ndarray       # tilted entropy φ + λ·m_init per λ
    sweeps: np.ndarray     # fixed-point sweep counts per λ
    nonconverged: float    # the reference's `counts`: the λ that failed, or 0
    chi: np.ndarray        # final messages (resume state)


def _ensemble_stop_fn(config: EntropyConfig, ent_floor_mode: str):
    """The ent-floor exit for per-member e1 vectors: 'all' members (or
    'any') must cross the floor. Validates the mode."""
    if ent_floor_mode not in ("all", "any"):
        raise ValueError(
            f"ent_floor_mode must be 'all' or 'any', got {ent_floor_mode!r}"
        )

    def stop_fn(e1):
        crossed = e1 < config.ent_floor
        return bool(crossed.all() if ent_floor_mode == "all" else crossed.any())

    return stop_fn


def _run_ladder(lambdas, chi, *, set_leaves, fixed_point, observe, eps: float,
                stop_fn, verbose: bool = False, plateau_eps: float = 0.0,
                plateau_patience: int = 3):
    """The λ-ladder loop (`ipynb:394-451` semantics) of the serial and
    ensemble solvers: leaf write → warm-started fixed point → observables →
    Legendre transform → early exits. ``fixed_point(chi, lm)`` returns
    ``(chi*, sweeps, delta)`` with host scalars; ``observe(chi, lm)``
    returns (φ, m_init) as scalars or per-member vectors; ``stop_fn(e1)``
    decides the entropy-floor exit. ``plateau_eps > 0`` adds the opt-in
    plateau exit. Returns
    ``(visited, ents, m_inits, ent1s, sweeps, nonconverged, chi)``."""
    ents, m_inits, ent1s, sweeps, visited = [], [], [], [], []
    nonconverged = 0.0
    plateau_patience = max(1, int(plateau_patience))
    plateau = 0
    prev_m = prev_e = None
    for lmbd in lambdas:
        lm = float(lmbd)
        chi = set_leaves(chi, lm)
        chi, t, delta = fixed_point(chi, lm)
        phi, m0 = (x.cpu().numpy() for x in observe(chi, lm))
        e1 = phi + lm * m0
        visited.append(lm)
        ents.append(phi)
        m_inits.append(m0)
        ent1s.append(e1)
        sweeps.append(int(t))
        failed = float(delta) > eps
        # NaN in the carry or the observables is poison, not a value (−inf
        # is a legitimate degraded φ): record non-convergence and stop. A
        # NaN delta makes `delta > eps` false, so it is caught here
        poisoned = bool(np.isnan(float(delta)) or np.isnan(phi).any()
                        or np.isnan(m0).any())
        if poisoned:
            failed = True
            log.warning("non-finite sweep state at lambda=%g (delta=%r) — "
                        "recording non-convergence and stopping the ladder",
                        lm, delta)
        if failed:
            nonconverged = lm
        if verbose:
            m_s = f"{m0:.5f}" if np.ndim(m0) == 0 else f"{np.mean(m0):.5f}(mean)"
            e_s = f"{e1:.5f}" if np.ndim(e1) == 0 else f"{np.mean(e1):.5f}(mean)"
            print(f"lambda={lm:.2f} t={t} m_init={m_s} ent1={e_s}")
        if stop_fn(e1) or failed:
            break
        if plateau_eps > 0:
            if prev_m is not None:
                moved = max(float(np.max(np.abs(m0 - prev_m))),
                            float(np.max(np.abs(e1 - prev_e))))
                plateau = plateau + 1 if moved < plateau_eps else 0
                if plateau >= plateau_patience:
                    if verbose:
                        print(f"plateau exit at lambda={lm:.2f}")
                    break
            prev_m, prev_e = m0, e1
    return visited, ents, m_inits, ent1s, sweeps, nonconverged, chi


def entropy_sweep(
    graph: Graph,
    config: EntropyConfig | None = None,
    *,
    n_total: int | None = None,
    seed: int = 0,
    chi0=None,
    lambdas: np.ndarray | None = None,
    verbose: bool = False,
    checkpointer=None,
    class_bucket: int | None = None,
    kernel: str = "auto",
    device=None,
) -> EntropyResult:
    """Run the λ ladder on one graph instance.

    ``graph`` may contain isolated nodes: they are removed and folded in
    analytically (φ gets ``−λ·n_iso/n``, m_init gets ``+n_iso/n``,
    `ipynb:283-291,338`); ``n_total`` overrides the density normalisation
    (default ``graph.n``). ``class_bucket`` pads degree-class sizes to a
    multiple of it (the JAX package's compile-sharing padding; results do
    not depend on it). ``chi0`` warm-starts from a previous result's chi.
    ``kernel``: ``'auto'`` (the CUDA kernel on the card, the plain version
    on the CPU), ``'cuda'`` or ``'plain'``. The ladder advances through the
    cell executor at G=1, so it equals a cell of the grouped grid bit for
    bit."""
    _refuse(checkpointer)
    config = config or EntropyConfig()
    dev = resolve_device(device)
    dyn = config.dynamics
    n_total = n_total or graph.n
    sub, n_iso = remove_isolates(graph)
    data = BDCMData(sub, p=dyn.p, c=dyn.c, attr_value=dyn.attr_value,
                    rule=dyn.rule, tie=dyn.tie, class_bucket=class_bucket,
                    dtype=config.dtype)
    ex = EntropyCellExec([(data, n_total, n_iso)], config, kernel=kernel,
                         device=dev)
    phi_fn, minit_fn = ex.observe_fns(0)
    if lambdas is None:
        lambdas = lambda_ladder(config)
    chi = (data.init_messages(seed) if chi0 is None
           else torch.as_tensor(np.asarray(chi0), dtype=data.dtype)).to(dev)

    visited, ents, m_inits, ent1s, sweeps, nonconverged, chi = _run_ladder(
        lambdas, chi,
        set_leaves=ex.set_leaves1,
        fixed_point=ex.fixed_point1,
        observe=lambda c, lm: (phi_fn(c, lm), minit_fn(c)),
        eps=config.eps,
        stop_fn=lambda e1: bool(e1 < config.ent_floor),
        verbose=verbose,
        plateau_eps=config.plateau_eps,
        plateau_patience=config.plateau_patience,
    )
    return EntropyResult(
        lambdas=np.array(visited), ent=np.array(ents),
        m_init=np.array(m_inits), ent1=np.array(ent1s),
        sweeps=np.array(sweeps), nonconverged=nonconverged,
        chi=chi.cpu().numpy(),
    )


_LADDER_ROW_KEYS = ("lambdas", "ent", "m_init", "ent1", "sweeps")


def _ladder_rows(out):
    """A :func:`_run_ladder` 7-tuple as ``(rows dict, nonconverged, chi)``."""
    visited, ents, m_inits, ent1s, sweeps, nonconverged, chi = out
    rows = dict(zip(_LADDER_ROW_KEYS, (
        np.array(visited), np.array(ents), np.array(m_inits),
        np.array(ent1s), np.array(sweeps))))
    return rows, nonconverged, chi


class EnsembleEntropyResult(NamedTuple):
    lambdas: np.ndarray    # ladder values visited [count]
    ent: np.ndarray        # φ [count, G]
    m_init: np.ndarray     # [count, G]
    ent1: np.ndarray       # [count, G]
    sweeps: np.ndarray     # joint fixed-point sweep counts [count]
    nonconverged: float    # λ whose joint fixed point failed, or 0
    chi: np.ndarray        # [G, 2E, K, K] resume state


def entropy_ensemble(
    graphs,
    config: EntropyConfig | None = None,
    *,
    seed: int = 0,
    lambdas: np.ndarray | None = None,
    ent_floor_mode: str = "all",
    chi0=None,
    checkpoint_path: str | None = None,
    mesh=None,
    kernel: str = "auto",
    device=None,
) -> EnsembleEntropyResult:
    """The λ ladder over a structurally congruent, isolate-free graph
    ensemble (e.g. RRG(n, d) instances) as one program: one kernel launch
    per sweep over the ensemble axis, one λ (the shared factor). The fixed
    point iterates until every instance has ``max|Δchi| ≤ eps`` (a joint
    fixed point); the entropy-floor exit needs ``all`` (default) or ``any``
    instance to cross, per ``ent_floor_mode``. ``chi0`` warm-starts from a
    previous result's chi."""
    _refuse(checkpoint_path=checkpoint_path, mesh=mesh)
    config = config or EntropyConfig()
    stop_fn = _ensemble_stop_fn(config, ent_floor_mode)
    dev = resolve_device(device)
    dyn = config.dynamics
    for g in graphs:
        if (g.deg == 0).any():
            raise ValueError("entropy_ensemble requires isolate-free graphs")
    ens = EnsembleBDCM([
        BDCMData(g, p=dyn.p, c=dyn.c, attr_value=dyn.attr_value,
                 rule=dyn.rule, tie=dyn.tie, dtype=config.dtype)
        for g in graphs
    ])
    sweep = make_ensemble_sweep(ens, damp=config.damp,
                                eps_clamp=config.eps_clamp, kernel=kernel,
                                device=dev)
    set_leaves = make_ensemble_leaf_setter(ens, device=dev)
    phi_fn = make_ensemble_free_entropy(ens, eps_clamp=config.eps_clamp,
                                        device=dev)
    minit_fn = make_ensemble_m_init(ens, eps_clamp=config.eps_clamp,
                                    device=dev)

    def fixed_point(chi, lm):
        return run_fixed_point(lambda c: sweep(c, lm), chi,
                               eps=float(config.eps),
                               t_max=int(config.max_sweeps),
                               chunk_sweeps=CHUNK_SWEEPS)

    if lambdas is None:
        lambdas = lambda_ladder(config)
    chi = (ens.init_messages(seed) if chi0 is None
           else torch.as_tensor(np.asarray(chi0), dtype=ens.dtype)).to(dev)
    rows, nonconverged, chi = _ladder_rows(_run_ladder(
        np.asarray(lambdas, float), chi,
        set_leaves=set_leaves, fixed_point=fixed_point,
        observe=lambda c, lm: (phi_fn(c, lm), minit_fn(c)),
        eps=config.eps, stop_fn=stop_fn,
        plateau_eps=config.plateau_eps,
        plateau_patience=config.plateau_patience,
    ))
    return EnsembleEntropyResult(**rows, nonconverged=nonconverged,
                                 chi=chi.cpu().numpy())


class UnionEnsembleEntropyResult(NamedTuple):
    """Per-member λ-ladder results of :func:`entropy_ensemble_union`:
    ``chi`` is the union resume state ``[2E_union, K, K]``;
    ``edge_gid[e]`` maps undirected union edge ``e`` to its member."""

    lambdas: np.ndarray    # ladder values visited [count]
    ent: np.ndarray        # φ [count, G]
    m_init: np.ndarray     # [count, G]
    ent1: np.ndarray       # [count, G]
    sweeps: np.ndarray     # joint fixed-point sweep counts [count]
    nonconverged: float    # λ whose joint fixed point failed, or 0
    chi: np.ndarray        # [2E_union, K, K] union resume state
    edge_gid: np.ndarray   # int[E_union] — member index per undirected edge


def member_blocks(gid: np.ndarray, G: int, device) -> torch.Tensor:
    """``[G, width]`` int64 positions of each member's contiguous block of
    ``gid`` (a sorted member index per node or edge), padded with
    ``len(gid)``: a slot past the end that the reductions fill with their
    identity. Gathering through it and reducing over dim 1 sums each member
    in a fixed order, with no atomics."""
    gid = np.asarray(gid, np.int64)
    counts = np.bincount(gid, minlength=G)
    if gid.size and np.any(np.diff(gid) < 0):
        raise ValueError("member ids must be sorted (contiguous blocks)")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    width = max(int(counts.max(initial=0)), 1)
    pos = starts[:, None] + np.arange(width)[None, :]
    pos = np.where(np.arange(width)[None, :] < counts[:, None], pos, gid.size)
    return torch.as_tensor(pos, device=device)


def _block_reduce(x: torch.Tensor, blocks: torch.Tensor, fill: float,
                  how: str) -> torch.Tensor:
    """Per-member sum or min of ``x`` over the blocks of
    :func:`member_blocks` (``fill`` is the identity of the reduction)."""
    ext = torch.cat([x, x.new_full((1,), fill)])[blocks]
    return ext.sum(dim=1) if how == "sum" else ext.amin(dim=1)


def union_observables(zi, zij, mterms, lmbd: float, node_blocks, edge_blocks,
                      n_iso_v, n_tot_v, eps_clamp: float = 0.0):
    """Per-member (φ, m_init) ``[G]`` from the union's partition functions by
    block reductions. φ_g is −inf when one of its Z_i sits at the clamp
    floor; an edgeless member has no nodes (its isolates were removed), so
    its min over no Z_i is +inf and it keeps the analytic value."""
    lm = torch.tensor(lmbd, dtype=zi.dtype, device=zi.device)
    phi = (_block_reduce(torch.log(zi), node_blocks, 0.0, "sum")
           - _block_reduce(torch.log(zij), edge_blocks, 0.0, "sum")
           - lm * n_iso_v) / n_tot_v
    zi_min = _block_reduce(zi, node_blocks, torch.inf, "min")
    phi = torch.where(zi_min <= eps_clamp, -torch.inf, phi)
    m0 = (_block_reduce(mterms, edge_blocks, 0.0, "sum") + n_iso_v) / n_tot_v
    return phi, m0


def entropy_ensemble_union(
    graphs,
    config: EntropyConfig | None = None,
    *,
    seed: int = 0,
    chi0=None,
    lambdas: np.ndarray | None = None,
    ent_floor_mode: str = "all",
    checkpointer=None,
    checkpoint_path: str | None = None,
    verbose: bool = False,
    mesh=None,
    kernel: str = "auto",
    device=None,
) -> UnionEnsembleEntropyResult:
    """The λ ladder over an arbitrary graph ensemble as one program, through
    the disjoint union (:func:`graphdyn_torch.graphs.disjoint_union`):
    members with different degree signatures merge into one set of degree
    classes, isolated nodes are handled per member analytically
    (`ipynb:283-291,338`), and per-member φ and m_init come from reductions
    of the per-node and per-edge partition functions over each member's
    block. This is the BASELINE config-4 shape (64 ER instances × the λ
    ladder). ``chi0`` resumes from a previous result's union chi."""
    _refuse(checkpointer, checkpoint_path, mesh)
    config = config or EntropyConfig()
    stop_fn = _ensemble_stop_fn(config, ent_floor_mode)
    dev = resolve_device(device)
    dyn = config.dynamics
    G = len(graphs)
    subs, n_isos, n_totals = [], [], []
    for g in graphs:
        sub, n_iso = remove_isolates(g)
        subs.append(sub)
        n_isos.append(n_iso)
        n_totals.append(g.n)
    gu, node_gid, edge_gid = disjoint_union(subs)
    if lambdas is None:
        lambdas = lambda_ladder(config)

    if gu.num_edges == 0:
        # every member is edgeless (all isolates): the analytic closed form
        # is the whole answer — φ_g = −λ·n_iso/n, m_init = 1 per member
        n_iso_a = np.asarray(n_isos, float)
        n_tot_a = np.asarray(n_totals, float)
        lam = np.asarray(lambdas, float)
        ent = -lam[:, None] * n_iso_a[None, :] / n_tot_a[None, :]
        m0 = np.broadcast_to(n_iso_a / n_tot_a, (lam.size, G)).copy()
        K = 2 ** (dyn.p + dyn.c)
        return UnionEnsembleEntropyResult(
            lambdas=lam, ent=ent, m_init=m0, ent1=ent + lam[:, None] * m0,
            sweeps=np.zeros(lam.size, int), nonconverged=0.0,
            chi=np.zeros((0, K, K)), edge_gid=edge_gid,
        )

    data = BDCMData(gu, p=dyn.p, c=dyn.c, attr_value=dyn.attr_value,
                    rule=dyn.rule, tie=dyn.tie, dtype=config.dtype)
    fixed_point = make_fixed_point(data, config, kernel=kernel, device=dev)
    set_leaves = make_leaf_setter(data, device=dev)
    zi_fn = make_node_partition(data, eps_clamp=config.eps_clamp, device=dev)
    zij_fn = make_edge_partition(data, eps_clamp=config.eps_clamp, device=dev)
    mterm_fn = make_m_init_edge_terms(data, eps_clamp=config.eps_clamp,
                                      device=dev)
    node_blocks = member_blocks(node_gid, G, dev)
    edge_blocks = member_blocks(edge_gid, G, dev)
    n_iso_v = torch.tensor(n_isos, dtype=data.dtype, device=dev)
    n_tot_v = torch.tensor(n_totals, dtype=data.dtype, device=dev)

    def observables(chi, lm):
        return union_observables(
            zi_fn(chi, lm), zij_fn(chi), mterm_fn(chi), lm, node_blocks,
            edge_blocks, n_iso_v, n_tot_v, eps_clamp=float(config.eps_clamp))

    chi = (data.init_messages(seed) if chi0 is None
           else torch.as_tensor(np.asarray(chi0), dtype=data.dtype)).to(dev)
    rows, nonconverged, chi = _ladder_rows(_run_ladder(
        np.asarray(lambdas, float), chi,
        set_leaves=set_leaves, fixed_point=fixed_point, observe=observables,
        eps=config.eps, stop_fn=stop_fn, verbose=verbose,
        plateau_eps=config.plateau_eps,
        plateau_patience=config.plateau_patience,
    ))
    return UnionEnsembleEntropyResult(**rows, nonconverged=nonconverged,
                                      chi=chi.cpu().numpy(), edge_gid=edge_gid)


class EntropyGridResult(NamedTuple):
    """The notebook driver's result grids (`ipynb:484-492`)."""

    deg: np.ndarray            # mean-degree grid
    ent: np.ndarray            # [deg, rep, λ]
    m_init: np.ndarray
    ent1: np.ndarray
    nodes_isolated: np.ndarray  # [deg, rep]
    mean_degrees: np.ndarray
    max_degrees: np.ndarray
    mean_degrees_total: np.ndarray
    counts: np.ndarray          # [deg, rep] — the λ at which BP failed to
                                # converge, or 0 (`ipynb:429-431`)
    n_lambda: np.ndarray | None = None
                                # [deg, rep] — λ points visited (early exits
                                # leave the tail untouched)
    sweeps: np.ndarray | None = None
                                # [deg, rep, λ] — fixed-point sweeps per
                                # visited λ, 0 past n_lambda (the port's
                                # addition; not in the saved npz)


def entropy_grid(
    n: int,
    deg_grid: np.ndarray,
    config: EntropyConfig | None = None,
    *,
    seed: int = 0,
    graph_method: str = "numpy",
    verbose: bool = False,
    save_path: str | None = None,
    checkpoint_path: str | None = None,
    class_bucket: int | None = 64,
    prefetch: int = 2,
    group_size: int | None = None,
    kernel: str = "auto",
    device=None,
) -> EntropyGridResult:
    """The notebook's experiment driver: deg-grid × repetitions × λ ladder
    on fresh ER instances (`ipynb:496-513`); ``save_path`` writes the result
    grids as npz (`ipynb:515`).

    ``group_size`` (default ``min(cells, 8)``): the grid's cells advance
    through their λ-ladders ``group_size`` at a time as one program over
    stacked ragged tables (:mod:`graphdyn_torch.pipeline.entropy_group`),
    each with its own λ cursor, warm start and exits; element-wise identical
    to ``group_size=0``, the serial cell loop. ``prefetch`` builds the next
    cells' ER graphs (and, grouped, their BDCM tables) on a background
    thread; each cell depends only on ``seed + 1000·di + rep``, so the
    overlap cannot change results."""
    _refuse(checkpoint_path=checkpoint_path)
    if graph_method != "numpy":
        raise _not_ported(f"graph_method={graph_method!r}",
                          "A1: the networkx and native samplers")
    config = config or EntropyConfig()
    dev = resolve_device(device)
    dyn = config.dynamics
    lambdas = lambda_ladder(config)
    L = lambdas.size
    D, Rr = len(deg_grid), config.num_rep
    if group_size is None:
        group_size = min(max(D * Rr, 1), 8)

    ent = np.zeros((D, Rr, L))
    m_init = np.zeros((D, Rr, L))
    ent1 = np.zeros((D, Rr, L))
    nodes_isolated = np.zeros((D, Rr))
    mean_degrees = np.zeros((D, Rr))
    max_degrees = np.zeros((D, Rr))
    mean_degrees_total = np.zeros((D, Rr))
    counts = np.zeros((D, Rr))
    n_lambda = np.zeros((D, Rr), np.int64)
    sweeps = np.zeros((D, Rr, L), np.int64)

    from graphdyn_torch.pipeline.groups import group_ranges
    from graphdyn_torch.pipeline.prefetch import HostPrefetcher

    pending = [(di, rep) for di in range(D) for rep in range(Rr)]

    def cell_graph(di, rep):
        return erdos_renyi_graph(n, deg_grid[di] / (n - 1),
                                 seed=seed + 1000 * di + rep,
                                 method=graph_method)

    def cell_stats(g, di, rep):
        live = g.deg[g.deg > 0]
        nodes_isolated[di, rep] = g.n - live.size
        mean_degrees[di, rep] = live.mean() if live.size else 0.0
        max_degrees[di, rep] = g.deg.max(initial=0)
        mean_degrees_total[di, rep] = g.deg.mean()

    if group_size == 0:
        # the serial cell loop: one warm-started ladder at a time
        with HostPrefetcher(lambda ci: cell_graph(*pending[ci]),
                            range(len(pending)), depth=prefetch) as pf:
            for ci, (di, rep) in enumerate(pending):
                g = pf.get(ci)
                cell_stats(g, di, rep)
                res = entropy_sweep(
                    g, config, seed=seed + 1000 * di + rep, lambdas=lambdas,
                    verbose=verbose, class_bucket=class_bucket, kernel=kernel,
                    device=dev,
                )
                k = res.lambdas.size
                ent[di, rep, :k] = res.ent
                m_init[di, rep, :k] = res.m_init
                ent1[di, rep, :k] = res.ent1
                counts[di, rep] = res.nonconverged
                n_lambda[di, rep] = k
                sweeps[di, rep, :k] = res.sweeps
    else:
        def build_group_cell(ci):
            # everything that depends only on the cell coordinates, so the
            # prefetch thread can run it ahead: ER sample + BDCM tables
            di, rep = pending[ci]
            g = cell_graph(di, rep)
            sub, n_iso = remove_isolates(g)
            data = BDCMData(sub, p=dyn.p, c=dyn.c, attr_value=dyn.attr_value,
                            rule=dyn.rule, tie=dyn.tie,
                            class_bucket=class_bucket, dtype=config.dtype)
            return g, data, n_iso

        with HostPrefetcher(build_group_cell, range(len(pending)),
                            depth=prefetch) as pf:
            for ks in group_ranges(0, len(pending), group_size):
                items = [pf.get(ci) for ci in ks]
                cellmap = [pending[ci] for ci in ks]
                cells, chis = [], []
                for (di, rep), (g, data, n_iso) in zip(cellmap, items):
                    cell_stats(g, di, rep)
                    cells.append((data, g.n, n_iso))
                    chis.append(data.init_messages(seed + 1000 * di + rep))
                ex = EntropyCellExec(cells, config, group_size=group_size,
                                     kernel=kernel, device=dev)

                def record(gi, kk, lmv, phi, m0, e1, sw, failed,
                           _cm=cellmap):
                    di, rep = _cm[gi]
                    ent[di, rep, kk] = phi
                    m_init[di, rep, kk] = m0
                    ent1[di, rep, kk] = e1
                    n_lambda[di, rep] = kk + 1
                    sweeps[di, rep, kk] = sw
                    if failed:
                        counts[di, rep] = lmv

                run_cell_ladder(
                    ex, chis, lambdas, eps=config.eps,
                    ent_floor=config.ent_floor,
                    plateau_eps=config.plateau_eps,
                    plateau_patience=config.plateau_patience,
                    record=record, verbose=verbose,
                )

    out = EntropyGridResult(
        deg=np.asarray(deg_grid), ent=ent, m_init=m_init, ent1=ent1,
        nodes_isolated=nodes_isolated, mean_degrees=mean_degrees,
        max_degrees=max_degrees, mean_degrees_total=mean_degrees_total,
        counts=counts, n_lambda=n_lambda, sweeps=sweeps,
    )
    if save_path:
        from graphdyn_torch.utils.io import save_results_npz

        # the reference's keys (`ipynb:515`)
        save_results_npz(save_path, **{k: v for k, v in out._asdict().items()
                                       if k != "sweeps"})
    return out
