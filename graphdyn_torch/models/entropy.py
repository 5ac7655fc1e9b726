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
given ``device='cpu'``).

Durability, as in the JAX package: after every visited λ the ladder beats,
offers its warm-start chi and rows to a checkpointer (``entropy_sweep``'s
``checkpointer=``; the managed, identity-checked ``checkpoint_path=`` of
the ensemble drivers and the grid), saves at once and exits 75 on a
graceful shutdown, and passes the ``lambda.boundary`` fault site. A resumed
ladder re-enters at its first unvisited λ with the saved chi, so it equals
the uninterrupted run bit for bit. A non-finite fixed point (the
``sweep.nan`` site) records non-convergence and stops the ladder.

Meshes (one process per rank, ``torch.distributed``):
:func:`entropy_ensemble_union` with ``mesh=`` runs every fixed point
edge-sharded over the mesh's ``edge`` dimension (:func:`graphdyn_torch.
parallel.sharded.make_sharded_fixed_point`: chi replicated, each class's
edges split, the per-class kernel K3 on the card);
:func:`entropy_ensemble` with ``mesh=`` splits the graph axis over the
``graph`` dimension, each rank sweeping its block of instances as the
unsharded ensemble sweeps them (K3′ on the card), the joint fixed point's
``max|Δchi|`` all-reduced every sweep and the per-member observables
gathered. Every rank returns the same result. A mesh ladder checkpoints
as the sharded SA chains do: rank 0 writes a global snapshot (the whole
ensemble's chi) through :mod:`graphdyn_torch.utils.io`, each λ boundary's
save and shutdown decisions are or-reduced over the ranks
(:class:`graphdyn_torch.parallel.mesh.WorldSync`), and a snapshot resumes
at any rank count, one process included.
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
from graphdyn_torch.resilience import faults as _faults
from graphdyn_torch.resilience.shutdown import (
    ShutdownRequested,
    raise_if_requested,
    shutdown_requested,
)
from graphdyn_torch.resilience.supervisor import beat as _beat
from graphdyn_torch.pipeline.entropy_group import (
    EntropyCellExec,
    run_cell_ladder,
)
from graphdyn_torch.utils.platform import resolve_device

log = logging.getLogger("graphdyn_torch.models")


def _mesh_sync(mesh, *checkpoints):
    """The :class:`~graphdyn_torch.parallel.mesh.WorldSync` of a mesh ladder
    that checkpoints, else None (an unsharded or uncheckpointed ladder takes
    its decisions alone)."""
    if mesh is None or all(c is None for c in checkpoints):
        return None
    from graphdyn_torch.parallel.mesh import WorldSync

    return WorldSync()


def _plateau_prefix(prev_rows, plateau_eps: float, plateau_patience: int):
    """The plateau streak and last rows ``(streak, prev_m, prev_e)`` of a
    restored prefix ``(m_init_rows, ent1_rows)``, rebuilt as the
    uninterrupted ladder built them, so a resumed ladder exits at its λ."""
    if plateau_eps <= 0 or prev_rows is None or len(prev_rows[0]) == 0:
        return 0, None, None
    pm, pe = (np.asarray(r) for r in prev_rows)
    streak = 0
    for i in range(1, len(pm)):
        moved = max(float(np.max(np.abs(pm[i] - pm[i - 1]))),
                    float(np.max(np.abs(pe[i] - pe[i - 1]))))
        streak = streak + 1 if moved < plateau_eps else 0
    return streak, pm[-1], pe[-1]


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
                plateau_patience: int = 3, checkpointer=None,
                checkpoint_meta=None, checkpoint_extra_arrays=None,
                prev_rows=None, sync=None, global_chi=None):
    """The λ-ladder loop (`ipynb:394-451` semantics) of the serial and
    ensemble solvers: leaf write → warm-started fixed point → observables →
    Legendre transform → early exits. ``fixed_point(chi, lm)`` returns
    ``(chi*, sweeps, delta)`` with host scalars; ``observe(chi, lm)``
    returns (φ, m_init) as scalars or per-member vectors; ``stop_fn(e1)``
    decides the entropy-floor exit. ``plateau_eps > 0`` adds the opt-in
    plateau exit; ``prev_rows = (m_init_rows, ent1_rows)`` is the visited
    prefix of a resumed ladder, from which the plateau streak is rebuilt.

    After each λ: a heartbeat; the snapshot offer to ``checkpointer`` (a
    :class:`~graphdyn_torch.utils.io.PeriodicCheckpointer`; the arrays
    ``chi``, ``ent``, ``m_init``, ``ent1``, ``sweeps``, ``lambdas`` and
    ``checkpoint_extra_arrays``, the metadata ``lmbd``, ``failed`` and
    ``checkpoint_meta``), saved at once when a shutdown is pending, which
    then raises :class:`~graphdyn_torch.resilience.ShutdownRequested`; the
    ``lambda.boundary`` fault site. ``sync`` (a mesh ladder's
    :class:`~graphdyn_torch.parallel.mesh.WorldSync`) or-reduces rank 0's
    save clock and every rank's shutdown flag into one decision, every rank
    builds the payload (``global_chi(chi)``, a collective, gives the whole
    ensemble's messages) and rank 0 alone writes it. Returns
    ``(visited, ents, m_inits, ent1s, sweeps, nonconverged, chi)``."""
    ents, m_inits, ent1s, sweeps, visited = [], [], [], [], []
    nonconverged = 0.0
    plateau_patience = max(1, int(plateau_patience))
    plateau, prev_m, prev_e = _plateau_prefix(prev_rows, plateau_eps,
                                              plateau_patience)
    if plateau_eps > 0 and plateau >= plateau_patience:
        # the uninterrupted run had already exited inside the prefix
        return visited, ents, m_inits, ent1s, sweeps, nonconverged, chi
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
            # the degrade is survivable, the evidence is kept: the flight
            # post-mortem (or the live ledger's obs.crash event)
            from graphdyn_torch.obs import flight

            flight.dump("sweep.nan", site=f"entropy ladder lambda={lm:g}")
        if failed:
            nonconverged = lm
        if verbose:
            m_s = f"{m0:.5f}" if np.ndim(m0) == 0 else f"{np.mean(m0):.5f}(mean)"
            e_s = f"{e1:.5f}" if np.ndim(e1) == 0 else f"{np.mean(e1):.5f}(mean)"
            print(f"lambda={lm:.2f} t={t} m_init={m_s} ent1={e_s}")
        _beat("lambda")
        stopping = shutdown_requested()
        due = checkpointer is not None and checkpointer.due()
        if sync is not None:
            stopping, due = sync.any(stopping, sync.writer and due)
        if checkpointer is not None and (stopping or due):
            snap = chi if global_chi is None else global_chi(chi)
            payload = {
                "chi": snap.cpu().numpy(), "ent": np.array(ents),
                "m_init": np.array(m_inits), "ent1": np.array(ent1s),
                "sweeps": np.array(sweeps), "lambdas": np.array(visited),
                **(checkpoint_extra_arrays or {}),
            }
            meta = {"lmbd": lm, "failed": bool(failed),
                    **(checkpoint_meta or {})}
            if sync is None or sync.writer:
                if stopping:
                    checkpointer.save_now(payload, meta)
                else:
                    checkpointer.maybe_save(payload, meta)
        if stopping:
            raise_if_requested(where="lambda")
            # a rank whose own flag is clear stops with the rank that had it
            raise ShutdownRequested(None, where="lambda")
        _faults.maybe_fail("lambda.boundary", key=f"lmbd={lm:g}")
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
    prev_rows=None,
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
    bit.

    ``checkpointer``: a :class:`~graphdyn_torch.utils.io.
    PeriodicCheckpointer` offered the warm-start chi and the rows after
    each λ (:func:`_run_ladder`); resume by passing the restored chi as
    ``chi0``, the rest of the ladder as ``lambdas`` and, with a plateau
    exit, the visited prefix's ``(m_init, ent1)`` rows as ``prev_rows``."""
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
        checkpointer=checkpointer,
        checkpoint_meta={"seed": seed},
        prev_rows=prev_rows,
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


def _run_managed_ladder(checkpoint_path, interval_s, *, id_key, id_value,
                        what, lambdas, stop_fn, chi_init, dtype, device,
                        ladder_fn, base_meta, extra_arrays=None, sync=None,
                        local_chi=None):
    """The managed λ-ladder resume protocol of the ensemble solvers (the
    JAX package's): an identity-checked load
    (:func:`~graphdyn_torch.utils.io.load_validated`), re-entry at the first
    unvisited λ with the saved warm-start chi, prefix stitching that
    survives repeated interruptions (a snapshot carries the already
    stitched earlier segments as ``prev_*``), removal on completion.

    ``ladder_fn(lambdas_rest, chi, checkpointer, meta, extra_arrays,
    prev_rows)`` runs the solver's :func:`_run_ladder` and returns its
    7-tuple; ``chi_init()`` builds the cold-start messages. Under ``sync``
    (a mesh ladder) rank 0 reads and removes the snapshot and broadcasts
    it (or its refusal) to every rank, and ``local_chi`` takes a rank's
    part of the saved global chi. Returns ``(rows dict, nonconverged,
    chi)``."""
    from graphdyn_torch.utils.io import PeriodicCheckpointer, load_validated

    lambdas = np.asarray(lambdas, float)
    writer = sync is None or sync.writer
    if sync is None:
        prefix = load_validated(checkpoint_path, id_key, id_value, what)
    else:
        got = None
        if writer:
            try:
                got = ("ok", load_validated(checkpoint_path, id_key,
                                            id_value, what))
            except ValueError as e:
                got = ("refused", str(e))
        got = sync.bcast(got)
        if got[0] == "refused":
            raise ValueError(got[1])
        prefix = got[1]
    checkpointer = PeriodicCheckpointer(checkpoint_path, interval_s=interval_s)
    meta = {**base_meta, id_key: id_value}
    k0 = 0
    pre = None
    if prefix is not None:
        arrays, pmeta = prefix
        chi = torch.as_tensor(np.asarray(arrays["chi"]), dtype=dtype)
        chi = (chi if local_chi is None else local_chi(chi)).to(device)
        seg = {k: np.asarray(arrays[k]) for k in _LADDER_ROW_KEYS}
        if "prev_lambdas" in arrays:
            # interrupted twice: the earlier stitched segments ride along
            pre = {k: np.concatenate([np.asarray(arrays["prev_" + k]), seg[k]])
                   for k in seg}
        else:
            pre = seg
        k0 = int(pre["lambdas"].size)
        failed_prev = bool(pmeta.get("failed", False))
        if failed_prev or stop_fn(pre["ent1"][-1]) or k0 >= lambdas.size:
            if writer:
                checkpointer.remove()
            return (pre, float(pmeta["lmbd"]) if failed_prev else 0.0,
                    chi)
    else:
        chi = chi_init()
    out = ladder_fn(
        lambdas[k0:], chi, checkpointer, meta,
        {**(extra_arrays or {}),
         **({f"prev_{k}": v for k, v in pre.items()} if pre is not None
            else {})},
        (pre["m_init"], pre["ent1"]) if pre is not None else None)
    if writer:
        checkpointer.remove()
    rows, nonconverged, chi = _ladder_rows(out)
    if pre is not None:
        rows = (pre if rows["lambdas"].size == 0 else
                {k: np.concatenate([pre[k], rows[k]]) for k in rows})
    return rows, nonconverged, chi


def _ensemble_id(graphs, config, seed, lambdas, ent_floor_mode, chi0) -> str:
    """The identity of an ensemble ladder's managed checkpoint (the JAX
    package's parts, and the port's tag)."""
    from graphdyn_torch.utils.io import run_fingerprint

    return run_fingerprint(
        *[g.edges for g in graphs], [int(g.n) for g in graphs], config, seed,
        np.asarray(lambdas, float), ent_floor_mode,
        None if chi0 is None else np.asarray(chi0), "graphdyn_torch")


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
    checkpoint_interval_s: float = 30.0,
    mesh=None,
    graph_axis: str = "graph",
    kernel: str = "auto",
    device=None,
) -> EnsembleEntropyResult:
    """The λ ladder over a structurally congruent, isolate-free graph
    ensemble (e.g. RRG(n, d) instances) as one program: one kernel launch
    per sweep over the ensemble axis, one λ (the shared factor). The fixed
    point iterates until every instance has ``max|Δchi| ≤ eps`` (a joint
    fixed point); the entropy-floor exit needs ``all`` (default) or ``any``
    instance to cross, per ``ent_floor_mode``. ``chi0`` warm-starts from a
    previous result's chi. ``checkpoint_path``: the managed λ-granular
    resume (:func:`_run_managed_ladder`). ``mesh``: split the graph axis
    over the mesh's ``graph_axis`` dimension (module docstring; the graph
    count must divide into it); every rank of it calls this together, and
    its checkpoint is the whole ensemble's, resumable at any rank count."""
    sync = _mesh_sync(mesh, checkpoint_path)
    config = config or EntropyConfig()
    stop_fn = _ensemble_stop_fn(config, ent_floor_mode)
    dyn = config.dynamics
    for g in graphs:
        if (g.deg == 0).any():
            raise ValueError("entropy_ensemble requires isolate-free graphs")
    datas = [BDCMData(g, p=dyn.p, c=dyn.c, attr_value=dyn.attr_value,
                      rule=dyn.rule, tie=dyn.tie, dtype=config.dtype)
             for g in graphs]
    ens = EnsembleBDCM(datas)
    block = slice(None)
    reduce = gather = None
    if mesh is not None:
        from graphdyn_torch.parallel.mesh import (
            all_gather_tiled,
            axis_index,
            axis_size,
            pmax,
            rank_device,
        )

        shards = axis_size(mesh, graph_axis)
        if len(graphs) % shards:
            raise ValueError(
                f"entropy_ensemble(mesh=...) needs the graph count divisible "
                f"by the {graph_axis!r} axis ({len(graphs)} graphs, "
                f"{shards} shards) — pad the ensemble or shrink the mesh")
        Gl = len(graphs) // shards
        r = axis_index(mesh, graph_axis)
        block = slice(r * Gl, (r + 1) * Gl)
        full = ens
        ens = EnsembleBDCM(datas[block])
        dev = rank_device(device)

        def reduce(d):
            return pmax(d, mesh, graph_axis)

        def gather(x):
            return all_gather_tiled(x.contiguous(), mesh, graph_axis, dim=0)
    else:
        full = ens
        dev = resolve_device(device)
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
                               chunk_sweeps=CHUNK_SWEEPS, reduce=reduce)

    def observe(c, lm):
        phi, m0 = phi_fn(c, lm), minit_fn(c)
        return (phi, m0) if gather is None else (gather(phi), gather(m0))

    if lambdas is None:
        lambdas = lambda_ladder(config)

    def chi_init():
        # the whole ensemble's draw, then this rank's block of it
        return (full.init_messages(seed) if chi0 is None
                else torch.as_tensor(np.asarray(chi0), dtype=ens.dtype)
                )[block].to(dev)

    def ladder_fn(lam, chi, ck, meta, xtra, prev_rows=None):
        return _run_ladder(
            lam, chi, set_leaves=set_leaves, fixed_point=fixed_point,
            observe=observe,
            eps=config.eps, stop_fn=stop_fn,
            plateau_eps=config.plateau_eps,
            plateau_patience=config.plateau_patience, checkpointer=ck,
            checkpoint_meta=meta, checkpoint_extra_arrays=xtra,
            prev_rows=prev_rows, sync=sync, global_chi=gather)

    if checkpoint_path is not None:
        rows, nonconverged, chi = _run_managed_ladder(
            checkpoint_path, checkpoint_interval_s, id_key="ens_id",
            id_value=_ensemble_id(graphs, config, seed, lambdas,
                                  ent_floor_mode, chi0),
            what="congruent-ensemble", lambdas=lambdas, stop_fn=stop_fn,
            chi_init=chi_init, dtype=ens.dtype, device=dev,
            ladder_fn=ladder_fn, base_meta={"seed": seed}, sync=sync,
            local_chi=lambda c: c[block])
    else:
        rows, nonconverged, chi = _ladder_rows(ladder_fn(
            np.asarray(lambdas, float), chi_init(), None, None, None))
    if gather is not None:
        chi = gather(chi)
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
    checkpoint_interval_s: float = 30.0,
    verbose: bool = False,
    mesh=None,
    edge_axis: str = "edge",
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
    ladder). ``chi0`` resumes from a previous result's union chi.
    ``checkpoint_path``: the managed λ-granular resume
    (:func:`_run_managed_ladder`); ``checkpointer``: a caller-managed
    :class:`~graphdyn_torch.utils.io.PeriodicCheckpointer` (one of the two).
    ``mesh``: run every fixed point edge-sharded over the mesh's
    ``edge_axis`` dimension (module docstring); every rank of it calls this
    together (chi is replicated, so its checkpoint is any rank's chi, and
    rank 0 writes it)."""
    sync = _mesh_sync(mesh, checkpoint_path, checkpointer)
    if checkpoint_path is not None and checkpointer is not None:
        raise ValueError("pass either checkpoint_path (managed resume) or "
                         "checkpointer (caller-managed), not both")
    config = config or EntropyConfig()
    stop_fn = _ensemble_stop_fn(config, ent_floor_mode)
    if mesh is not None:
        from graphdyn_torch.parallel.mesh import rank_device

        dev = rank_device(device)
    else:
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
    # the identity comes before the all-edgeless shortcut, so a foreign
    # checkpoint is refused there too
    union_id = (None if checkpoint_path is None else
                _ensemble_id(graphs, config, seed, lambdas, ent_floor_mode,
                             chi0))

    if gu.num_edges == 0:
        # every member is edgeless (all isolates): the analytic closed form
        # is the whole answer — φ_g = −λ·n_iso/n, m_init = 1 per member
        n_iso_a = np.asarray(n_isos, float)
        n_tot_a = np.asarray(n_totals, float)
        lam = np.asarray(lambdas, float)
        ent = -lam[:, None] * n_iso_a[None, :] / n_tot_a[None, :]
        m0 = np.broadcast_to(n_iso_a / n_tot_a, (lam.size, G)).copy()
        K = 2 ** (dyn.p + dyn.c)
        if union_id is not None and (sync is None or sync.writer):
            from graphdyn_torch.utils.io import load_validated, open_checkpoint

            load_validated(checkpoint_path, "union_id", union_id,
                           "union-ensemble")
            open_checkpoint(checkpoint_path).remove()
        return UnionEnsembleEntropyResult(
            lambdas=lam, ent=ent, m_init=m0, ent1=ent + lam[:, None] * m0,
            sweeps=np.zeros(lam.size, int), nonconverged=0.0,
            chi=np.zeros((0, K, K)), edge_gid=edge_gid,
        )

    data = BDCMData(gu, p=dyn.p, c=dyn.c, attr_value=dyn.attr_value,
                    rule=dyn.rule, tie=dyn.tie, dtype=config.dtype)
    if mesh is not None:
        from graphdyn_torch.parallel.sharded import make_sharded_fixed_point

        fixed_point = make_sharded_fixed_point(
            data, mesh, damp=config.damp, eps=float(config.eps),
            max_sweeps=int(config.max_sweeps), eps_clamp=config.eps_clamp,
            edge_axis=edge_axis, kernel=kernel, device=dev)
    else:
        fixed_point = make_fixed_point(data, config, kernel=kernel,
                                       device=dev)
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

    def chi_init():
        return (data.init_messages(seed) if chi0 is None
                else torch.as_tensor(np.asarray(chi0), dtype=data.dtype)
                ).to(dev)

    def ladder_fn(lam, chi, ck, meta, xtra, prev_rows=None):
        return _run_ladder(
            lam, chi, set_leaves=set_leaves, fixed_point=fixed_point,
            observe=observables, eps=config.eps, stop_fn=stop_fn,
            verbose=verbose, plateau_eps=config.plateau_eps,
            plateau_patience=config.plateau_patience, checkpointer=ck,
            checkpoint_meta=meta, checkpoint_extra_arrays=xtra,
            prev_rows=prev_rows, sync=sync)

    edge_gid_np = np.asarray(edge_gid)
    if union_id is not None:
        rows, nonconverged, chi = _run_managed_ladder(
            checkpoint_path, checkpoint_interval_s, id_key="union_id",
            id_value=union_id, what="union-ensemble", lambdas=lambdas,
            stop_fn=stop_fn, chi_init=chi_init, dtype=data.dtype,
            device=dev, ladder_fn=ladder_fn, base_meta={"seed": seed},
            extra_arrays={"edge_gid": edge_gid_np}, sync=sync)
    else:
        rows, nonconverged, chi = _ladder_rows(ladder_fn(
            np.asarray(lambdas, float), chi_init(), checkpointer,
            {"seed": seed}, {"edge_gid": edge_gid_np}))
    return UnionEnsembleEntropyResult(**rows, nonconverged=nonconverged,
                                      chi=chi.cpu().numpy(), edge_gid=edge_gid)


class _GridCheckpointAdapter:
    """Injects grid coordinates into the per-sweep checkpoint metadata (so a
    resumed run knows which (deg, rep, λ) cell to continue from) and the
    grid result arrays into the payload (so completed cells survive the
    restart). ``extra_arrays`` holds live references — the driver mutates
    the grids in place, so each save captures their current state."""

    def __init__(self, checkpointer, extra_meta: dict, extra_arrays: dict):
        self._ck = checkpointer
        self._extra = extra_meta
        self._extra_arrays = extra_arrays
        self.ckpt = checkpointer.ckpt

    def due(self) -> bool:
        return self._ck.due()

    def maybe_save(self, arrays, meta) -> bool:
        return self._ck.maybe_save(
            {**arrays, **self._extra_arrays}, {**meta, **self._extra}
        )

    def save_now(self, arrays, meta) -> bool:
        """Shutdown snapshot: same coordinate/grid injection, no interval
        gate — the restored cell must know which (deg, rep, λ) it was."""
        return self._ck.save_now(
            {**arrays, **self._extra_arrays}, {**meta, **self._extra}
        )


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


def _next_cell_after(cell, num_rep: int):
    """The (deg, rep) cell after ``cell`` in grid iteration order."""
    di, rep = cell
    return (di, rep + 1) if rep + 1 < num_rep else (di + 1, 0)


def _load_grid_resume(checkpoint_path, grid_id, grids, lambdas, max_sweeps):
    """Load + normalize an entropy-grid snapshot into ``(start_cell,
    resume_cells, done_cells)`` — the ONE reader both execution paths use.

    Two writer formats, interchangeable by construction:

    - the SERIAL in-flight-cell format (``deg_index``/``rep``/
      ``lmbd_offset`` + the cell's λ-segment arrays + ``chi``) written by
      the per-cell ladder's :class:`_GridCheckpointAdapter`;
    - the GROUPED format (``cells`` = per-in-flight-cell ``[di, rep,
      visited, failed]`` + per-cell ``chi_<di>_<rep>`` arrays +
      ``done_cells``), which ALSO carries the serial keys for its first
      in-flight cell, so a ``group_size=0`` rerun can resume a grouped
      snapshot (and vice versa — per-cell results depend only on the cell
      seed and its λ cursor, so regrouping cannot change them).
    """
    from graphdyn_torch.utils.io import load_validated

    loaded = load_validated(checkpoint_path, "grid_id", grid_id,
                            "entropy grid")
    if loaded is None:
        return (0, 0), {}, set()
    arrays, meta = loaded
    for key, arr in grids.items():
        if key in arrays:
            arr[:] = arrays[key]
    resume: dict = {}
    done: set = set()
    ent1 = grids["grid_ent1"]
    if "cells" in meta:
        start = tuple(int(v) for v in meta["next_cell"])
        for di, rep, vis, failed in meta["cells"]:
            di, rep, vis = int(di), int(rep), int(vis)
            if vis < 1:
                continue                      # never visited: cold start
            resume[(di, rep)] = {
                "chi": arrays[f"chi_{di}_{rep}"],
                "visited": vis,
                "last_lmbd": float(lambdas[vis - 1]),
                "last_e1": float(ent1[di, rep, vis - 1]),
                "failed": bool(failed),
            }
        for di, rep in meta.get("done_cells", []):
            done.add((int(di), int(rep)))
    else:
        start = (int(meta["deg_index"]), int(meta["rep"]))
        # the interrupted cell: λ points [k_off, k_off+seg) of the ladder
        # live in the sweep-local arrays; earlier segments of a
        # twice-interrupted cell are already in the grid rows
        k_off = int(meta.get("lmbd_offset", 0))
        seg = int(arrays["lambdas"].size)
        sl = slice(k_off, k_off + seg)
        grids["grid_ent"][start[0], start[1], sl] = arrays["ent"]
        grids["grid_m_init"][start[0], start[1], sl] = arrays["m_init"]
        ent1[start[0], start[1], sl] = arrays["ent1"]
        if "grid_sweeps" in grids:
            # keep the restored cell's per-λ sweep counts truthful for any
            # later grouped snapshot's compat "sweeps" segment
            grids["grid_sweeps"][start[0], start[1], sl] = arrays["sweeps"]
        resume[start] = {
            "chi": arrays["chi"],
            "visited": k_off + seg,
            "last_lmbd": float(arrays["lambdas"][-1]),
            "last_e1": float(arrays["ent1"][-1]),
            # the recorded flag, not a sweeps>=max inference — a fixed
            # point that converges on exactly the last allowed sweep is
            # NOT a failure (legacy snapshots without the flag fall back
            # to the inference)
            "failed": bool(meta.get(
                "failed", int(arrays["sweeps"][-1]) >= max_sweeps,
            )),
        }
    return start, resume, done


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
    checkpoint_interval_s: float = 30.0,
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
    overlap cannot change results. ``graph_method``: the ER sampler of
    :func:`~graphdyn_torch.graphs.erdos_renyi_graph` (``'numpy'``,
    ``'networkx'`` or ``'native'``), on both paths.

    ``checkpoint_path``: snapshots every ``checkpoint_interval_s`` seconds
    (and at once on a graceful shutdown) with exact resume, as the JAX
    package's: a rerun restores every completed cell, re-enters each
    interrupted cell at its first unvisited λ with its saved chi, and
    refuses a snapshot of another run (n, grid, config, seed, sampler).
    Snapshots pass between the serial and grouped paths and between group
    sizes (:func:`_load_grid_resume`). The file is removed once the results
    are saved."""
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
    grids = {
        "grid_ent": ent, "grid_m_init": m_init, "grid_ent1": ent1,
        "grid_counts": counts, "grid_nodes_isolated": nodes_isolated,
        "grid_mean_degrees": mean_degrees, "grid_max_degrees": max_degrees,
        "grid_mean_degrees_total": mean_degrees_total,
        "grid_n_lambda": n_lambda, "grid_sweeps": sweeps,
    }

    checkpointer = None
    grid_id = None
    resume_cells: dict = {}
    done_cells: set = set()
    start_cell = (0, 0)
    if checkpoint_path is not None:
        from graphdyn_torch.utils.io import (
            PeriodicCheckpointer,
            run_fingerprint,
        )

        grid_id = run_fingerprint(
            n, np.asarray(deg_grid, float), config, seed, graph_method,
            class_bucket, "graphdyn_torch")
        start_cell, resume_cells, done_cells = _load_grid_resume(
            checkpoint_path, grid_id, grids, lambdas, config.max_sweeps)
        checkpointer = PeriodicCheckpointer(checkpoint_path,
                                            interval_s=checkpoint_interval_s)
    # restored cells that had already stopped (failed, entropy floor, whole
    # ladder) are recorded and retired before anything runs
    for cell, rc in list(resume_cells.items()):
        if rc["failed"] or rc["last_e1"] < config.ent_floor \
                or rc["visited"] >= L:
            di, rep = cell
            if rc["failed"]:
                counts[di, rep] = rc["last_lmbd"]
            n_lambda[di, rep] = rc["visited"]
            done_cells.add(cell)
            del resume_cells[cell]

    from graphdyn_torch.pipeline.groups import group_ranges
    from graphdyn_torch.pipeline.prefetch import HostPrefetcher

    pending = [(di, rep) for di in range(D) for rep in range(Rr)
               if (di, rep) >= start_cell and (di, rep) not in done_cells]

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
                rc = resume_cells.get((di, rep))
                k0 = rc["visited"] if rc is not None else 0
                ck = None if checkpointer is None else _GridCheckpointAdapter(
                    checkpointer, {"deg_index": di, "rep": rep,
                                   "lmbd_offset": k0, "grid_id": grid_id},
                    grids)
                res = entropy_sweep(
                    g, config, seed=seed + 1000 * di + rep,
                    lambdas=lambdas[k0:],
                    chi0=rc["chi"] if rc is not None else None,
                    verbose=verbose, checkpointer=ck,
                    class_bucket=class_bucket, kernel=kernel, device=dev,
                    prev_rows=((m_init[di, rep, :k0], ent1[di, rep, :k0])
                               if k0 > 0 else None),
                )
                k = res.lambdas.size
                sl = slice(k0, k0 + k)
                ent[di, rep, sl] = res.ent
                m_init[di, rep, sl] = res.m_init
                ent1[di, rep, sl] = res.ent1
                counts[di, rep] = res.nonconverged
                n_lambda[di, rep] = k0 + k
                sweeps[di, rep, sl] = res.sweeps
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
                cells, k0s, chis, prevs = [], [], [], []
                for (di, rep), (g, data, n_iso) in zip(cellmap, items):
                    cell_stats(g, di, rep)
                    cells.append((data, g.n, n_iso))
                    rc = resume_cells.get((di, rep))
                    k0 = rc["visited"] if rc is not None else 0
                    if k0 > 0:
                        # the restored prefix counts as visited even when
                        # the cell exits at once (a plateau in the prefix)
                        n_lambda[di, rep] = k0
                    k0s.append(k0)
                    chis.append(
                        torch.as_tensor(np.asarray(rc["chi"]),
                                        dtype=data.dtype)
                        if rc is not None
                        else data.init_messages(seed + 1000 * di + rep))
                    prevs.append((m_init[di, rep, :k0], ent1[di, rep, :k0])
                                 if k0 > 0 else None)
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

                def boundary(stopping, info, _cm=cellmap):
                    if not (stopping or checkpointer.due()):
                        return
                    _save_grid_boundary(
                        checkpointer, stopping, info, _cm, grids, lambdas,
                        done_cells, grid_id, Rr)

                run_cell_ladder(
                    ex, chis, lambdas, eps=config.eps,
                    ent_floor=config.ent_floor, k0=k0s,
                    plateau_eps=config.plateau_eps,
                    plateau_patience=config.plateau_patience,
                    prev_rows=prevs, record=record,
                    # no callback without a checkpoint: the runner copies
                    # each cell's chi to the host only for one
                    boundary=boundary if checkpointer is not None else None,
                    verbose=verbose,
                )
                done_cells.update(cellmap)

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
    # the checkpoint goes only once the results are saved: a failed final
    # save leaves it for another resume
    if checkpointer is not None:
        checkpointer.remove()
    return out


def _save_grid_boundary(checkpointer, stopping: bool, info, cellmap, grids,
                        lambdas, done_cells, grid_id, num_rep: int) -> None:
    """The grouped grid's snapshot at a λ boundary (the JAX package's
    format): every grid array, each in-flight cell's last-boundary chi as
    ``chi_<di>_<rep>`` and its cursor in ``meta['cells']``, the cells done,
    and the serial format's keys for the first in-flight cell."""
    ent, m_init, ent1 = grids["grid_ent"], grids["grid_m_init"], \
        grids["grid_ent1"]
    counts, n_lambda, sweeps = grids["grid_counts"], grids["grid_n_lambda"], \
        grids["grid_sweeps"]
    inflight = sorted(info, key=lambda d_: cellmap[d_["g"]])
    visited = [d_ for d_ in inflight if d_["visited"] >= 1]
    if inflight and not visited:
        # nothing recorded yet for any cell in flight: no resumable state
        # beyond the previous snapshot's (cold starts re-derive)
        return
    if inflight:
        lead = inflight[0]
        next_cell = cellmap[lead["g"]]
        di0, rep0 = next_cell
        vis0 = lead["visited"]
    else:
        # the whole group retired at this boundary
        next_cell = _next_cell_after(max(cellmap), num_rep)
        di0, rep0 = max(cellmap)
        vis0 = int(n_lambda[di0, rep0])
        lead = None
    arrays = dict(grids)
    for d_ in inflight:
        di, rep = cellmap[d_["g"]]
        arrays[f"chi_{di}_{rep}"] = d_["chi"]
    arrays["chi"] = (lead["chi"] if lead is not None
                     else arrays.get(f"chi_{di0}_{rep0}",
                                     np.zeros((0,), np.float32)))
    arrays["lambdas"] = lambdas[:vis0]
    arrays["ent"] = ent[di0, rep0, :vis0].copy()
    arrays["m_init"] = m_init[di0, rep0, :vis0].copy()
    arrays["ent1"] = ent1[di0, rep0, :vis0].copy()
    arrays["sweeps"] = sweeps[di0, rep0, :vis0].copy()
    inflight_set = {cellmap[d_["g"]] for d_ in inflight}
    known_done = done_cells | (set(cellmap) - inflight_set)
    meta = {
        "grid_id": grid_id,
        "deg_index": di0, "rep": rep0, "lmbd_offset": 0,
        "lmbd": (lead["lmbd"] if lead is not None
                 else float(lambdas[max(vis0 - 1, 0)])),
        "failed": (bool(lead["failed"]) if lead is not None
                   else bool(counts[di0, rep0])),
        "next_cell": list(next_cell),
        "cells": [[*cellmap[d_["g"]], d_["visited"], bool(d_["failed"])]
                  for d_ in visited],
        "done_cells": sorted([list(c) for c in known_done
                              if c >= next_cell]),
    }
    if stopping:
        checkpointer.save_now(arrays, meta)
    else:
        checkpointer.maybe_save(arrays, meta)
