"""Cell-parallel BDCM λ-ladders (the port of
``graphdyn/pipeline/entropy_group.py``).

The entropy grid's (deg, rep) cells each run a warm-started λ-ladder of
~10² fixed-point sweeps per λ. The ladder is sequential in λ and
independent across cells, so a group of ``G`` cells advances as one
program: the per-cell BDCM tables stack to ``[G, Ed_max, …]``
(:func:`graphdyn_torch.ops.bdcm.stack_bdcm`, ragged edge counts padded with
the ghost row), chi carries a leading cell axis, and each cell solves its
own λ: the tilted factor is per group, ``[G, K, K, M]``, one launch of the
BDCM sweep kernel per sweep with the cell axis as its group axis.

The group advances in chunks of ``CHUNK_SWEEPS`` sweeps with no host read
inside a chunk (:func:`graphdyn_torch.ops.bdcm.fixed_point_sweeps`): each
lane's delta is computed on the device every sweep, and a lane that reaches
its own fixed point (``max|Δchi| ≤ eps``) or ``max_sweeps`` is frozen by
mask, so its sweep count and state are the serial ladder's, merely sliced
into chunks. At the chunk boundary the host reads every lane's (delta, t)
once, records the cells that finished, and moves them to their next λ (leaf
write, new factor, carry reset) while the others keep iterating.

Serial == grouped bit for bit is structural:
:func:`graphdyn_torch.models.entropy.entropy_sweep` advances through this
executor at G=1. Each lane's sweep does not depend on G: the plain class
update is elementwise with reductions over fixed trailing axes, the
kernel's per-edge order does not depend on G, the tilt and the leaf
message are computed per cell at a fixed size
(:func:`~graphdyn_torch.ops.bdcm.tilt_vector`), and the delta is a max. φ
and m_init run per cell through the serial observables on the cell's own
``chi[:2E]`` slice.

At each chunk boundary where a cell crossed a λ, the ladder beats, offers
the grid's checkpoint callback every unfinished cell's last-boundary chi
and cursor, honours a graceful shutdown (exit 75) and passes the
``lambda.boundary`` fault site once per crossed cell; the ``sweep.nan`` site
is checked once per completed fixed point per cell. Each chunk runs in a
``pipeline.entropy.chunk`` span (closed after the chunk's host read), with
the ``obs.mem.*`` gauges after it, a ``pipeline.lambda.boundary`` counter per
crossed cell, and a ``pipeline.sweep.nan`` counter and a flight post-mortem
at a poisoned cell. Not ported yet: the cell-axis mesh (A15b).
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch import obs
from graphdyn_torch.ops.bdcm import (
    CHUNK_SWEEPS,
    _flat_ids,
    _SweepSpec,
    _sweep_core,
    fixed_point_sweeps,
    leaf_message,
    make_free_entropy,
    make_mean_m_init,
    resolve_modes,
    sweep_tables,
    run_fixed_point,
    stack_bdcm,
    tilt_vector,
)
from graphdyn_torch.utils.platform import resolve_device

log = logging.getLogger("graphdyn_torch.pipeline")


class EntropyCellExec:
    """One (padded) group of entropy λ-ladder cells on the device: the
    stacked tables, the per-class factors, the chunked fixed point and the
    per-cell observables. ``entropy_sweep`` runs the G=1 instance and the
    grouped ``entropy_grid`` a G=``group_size`` instance.

    ``cells``: ``(BDCMData, n_total, n_iso)`` per real cell (the
    isolate-removed graph's tables and the analytic isolate terms).
    ``group_size`` pads the stack with inactive copies of cell 0. chi lives
    as ``[G, 2E_max + 1, K, K]``: the last row of each lane is the ghost row
    that padded class members gather from and scatter into, reset to the
    uniform message after every sweep. ``kernel``: ``'auto'`` runs every
    class through the CUDA kernel on the card (a class the kernel refuses
    raises) and the plain version on the CPU; ``'cuda'`` requires the
    kernel; ``'plain'`` forces the plain version."""

    def __init__(self, cells, config, *, group_size: int | None = None,
                 kernel: str = "auto", device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= is not ported to graphdyn_torch yet (ROADMAP.md A15b: "
                "the ensemble meshes)")
        G_real = len(cells)
        G = group_size or G_real
        if G < G_real:
            raise ValueError(f"group_size={G} < group population {G_real}")
        dev = resolve_device(device)
        padded = list(cells) + [cells[0]] * (G - G_real)
        stk = stack_bdcm([c[0] for c in padded])
        self.stk = stk
        self.G, self.G_real, self.device = G, G_real, dev
        self.dtype = stk.dtype
        self.rows = stk.twoE_max + 1
        self.eps = float(config.eps)
        self.t_max = int(config.max_sweeps)
        ds = [d for d, _, _, _ in stk.edge_classes]
        self.spec = _SweepSpec(
            T=stk.T, K=stk.K, damp=float(config.damp),
            eps_clamp=float(config.eps_clamp), mask_invalid_src=True,
            with_bias=False, padded=True, class_ds=tuple(ds),
            modes=resolve_modes(ds, T=stk.T, dtype=stk.dtype, kernel=kernel,
                                device=dev),
        )
        self.valid = torch.as_tensor(stk.valid, dtype=stk.dtype, device=dev)
        self.tables = sweep_tables(
            [(_flat_ids(list(idx), self.rows, dev),
              _flat_ids(list(ie), self.rows, dev))
             for _, idx, ie, _ in stk.edge_classes], self.spec, G=G,
            rows=self.rows, valid=self.valid)
        self.As = [torch.as_tensor(A, dtype=stk.dtype, device=dev)
                   for _, _, _, A in stk.edge_classes]
        self.leaf_idx = _flat_ids(list(stk.leaf_idx), self.rows, dev)  # [G, L]
        K = stk.K
        self._ghost = torch.full((K, K), 1.0 / (K * K), dtype=stk.dtype,
                                 device=dev)
        # per-cell observables: the serial ones, on the cell's own slice
        self._observe = [
            (make_free_entropy(data, n_total=n_total, n_iso=n_iso,
                               eps_clamp=config.eps_clamp, device=dev),
             make_mean_m_init(data, n_total=n_total, n_iso=n_iso,
                              eps_clamp=config.eps_clamp, device=dev))
            for data, n_total, n_iso in cells
        ]

    # -- stacked (group) surface ----------------------------------------

    def stack_chi(self, chi_list) -> torch.Tensor:
        """``[G, 2E_max + 1, K, K]`` on the device from per-real-cell chi
        (pad lanes get copies of cell 0's chi; their lane is never active),
        with the ghost row appended."""
        padded = list(chi_list) + [chi_list[0]] * (self.G - self.G_real)
        stacked = self.stk.stack_chi(padded).to(self.device)
        ghost = self._ghost.expand(self.G, 1, -1, -1)
        return torch.cat([stacked, ghost], dim=1)

    def factors(self, lmbd_vec) -> list:
        """The per-group tilted factor ``A·exp(−λ_g·x_i(0))`` of every class,
        ``[G, K, K, M]``, for the lanes' λ (host floats)."""
        tilt = torch.stack([tilt_vector(lm, self.stk.x0, self.dtype)
                            for lm in lmbd_vec]).to(self.device)
        return [A[None] * tilt[:, :, None, None] for A in self.As]

    def set_leaves(self, chi, lmbd_vec, active) -> torch.Tensor:
        """Write each ``active`` lane's closed-form leaf messages at its own
        λ into ``chi`` (in place; returned). Pad leaf slots target the ghost
        row, which is reset to the uniform message afterwards, so it adds
        nothing to the next sweep's delta."""
        lanes = [g for g in range(self.G) if active[g]]
        if not lanes or self.leaf_idx.shape[1] == 0:
            return chi
        K = self.spec.K
        msgs = torch.stack([leaf_message(lmbd_vec[g], self.stk.leaf01,
                                         self.stk.x0, self.dtype)
                            for g in lanes]).to(self.device)
        ids = self.leaf_idx[lanes]                           # [A, L]
        chi.view(-1, K, K)[ids.reshape(-1)] = \
            msgs[:, None].expand(-1, ids.shape[1], -1, -1).reshape(-1, K, K)
        chi[:, -1] = self._ghost
        return chi

    def sweep(self, chi, a_tilted) -> torch.Tensor:
        """One sweep of every lane (a new tensor; the ghost rows reset)."""
        new = _sweep_core(chi, a_tilted, None, self.valid, self.tables,
                          self.spec)
        new[:, -1] = self._ghost
        return new

    def fixed_point_chunk(self, chi, a_tilted, active, delta, t):
        """``(chi', delta[G], t[G])`` after at most ``CHUNK_SWEEPS`` more
        sweeps of every unfinished lane (device tensors, no host read)."""
        return fixed_point_sweeps(lambda c: self.sweep(c, a_tilted), chi,
                                  delta, t, active, eps=self.eps,
                                  t_max=self.t_max, sweeps=CHUNK_SWEEPS)

    def poison_cell(self, chi, g: int) -> torch.Tensor:
        """The ``sweep.nan`` fault payload for cell ``g``: one NaN at its
        first element (in place; returned)."""
        chi[g, 0, 0, 0] = float("nan")
        return chi

    def unstack_chi(self, chi, g: int) -> torch.Tensor:
        """Cell ``g``'s own ``[2E_g, K, K]`` slice of the stacked chi."""
        return chi[g, : int(self.stk.twoE[g])]

    def observe(self, chi, g: int, lmbd: float):
        """(φ, m_init) of cell ``g`` via its serial observables, as 0-d
        device tensors."""
        phi_fn, m_fn = self._observe[g]
        cg = self.unstack_chi(chi, g)
        return phi_fn(cg, lmbd), m_fn(cg)

    def observe_fns(self, g: int):
        return self._observe[g]

    # -- G=1 (serial-ladder) surface ------------------------------------

    def set_leaves1(self, chi, lmbd):
        """The single cell's leaf write: ``chi`` ``[2E, K, K]`` -> a new
        chi."""
        c = self.stack_chi([chi])
        return self.unstack_chi(self.set_leaves(c, [lmbd], [True]), 0).clone()

    def fixed_point1(self, chi, lmbd):
        """The single cell's full fixed point, ``(chi, lmbd) -> (chi*,
        sweeps, delta)``, through the group program at G=1 in host-driven
        chunks."""
        a_t = self.factors([lmbd])
        c, t, delta = run_fixed_point(lambda x: self.sweep(x, a_t),
                                      self.stack_chi([chi]), eps=self.eps,
                                      t_max=self.t_max,
                                      chunk_sweeps=CHUNK_SWEEPS)
        return self.unstack_chi(c, 0), t, delta


class CellLadderResult(NamedTuple):
    """Per-cell ladder outputs (lists indexed by real cell)."""

    lambdas: list          # visited λ values per cell
    ent: list              # φ rows per cell
    m_init: list
    ent1: list
    sweeps: list
    nonconverged: np.ndarray   # [G_real] — λ whose fixed point failed, or 0
    chi: list              # final [2E_g, K, K] state per cell (numpy)


def run_cell_ladder(
    ex: EntropyCellExec,
    chi_list,
    lambdas: np.ndarray,
    *,
    eps: float,
    ent_floor: float,
    k0=None,
    plateau_eps: float = 0.0,
    plateau_patience: int = 3,
    prev_rows=None,
    record=None,
    boundary=None,
    verbose: bool = False,
) -> CellLadderResult:
    """Advance every cell of the group through its own ladder,
    chunk-pipelined: a converged cell moves on to its next λ while
    slower cells keep iterating (module docstring). The exits are the serial
    ladder's, per cell: the entropy floor, a failed or non-finite fixed
    point, the end of the ladder and the opt-in plateau.

    ``k0[g]`` is cell g's first unvisited ladder index (a resumed cell
    starts mid-ladder); ``prev_rows[g] = (m_init_rows, ent1_rows)`` its
    restored prefix, from which its plateau streak is rebuilt. ``record(g,
    k, lmbd, phi, m0, e1, sweeps, failed)`` fires per cell per visited λ;
    ``boundary(stopping, info)`` at each chunk boundary where a cell
    crossed a λ (and at every chunk while a shutdown is pending), before the
    shutdown raise and the ``lambda.boundary`` faults, with ``{"g",
    "visited", "lmbd", "failed", "chi"}`` for every unfinished cell, ``chi``
    its last-boundary state on the host (copied only when ``boundary`` is
    given)."""
    from graphdyn_torch.models.entropy import _plateau_prefix
    from graphdyn_torch.resilience import faults as _faults
    from graphdyn_torch.resilience.shutdown import (
        raise_if_requested,
        shutdown_requested,
    )
    from graphdyn_torch.resilience.supervisor import beat as _beat

    G, Gr = ex.G, ex.G_real
    lambdas = np.asarray(lambdas, float)
    L = lambdas.size
    plateau_patience = max(1, int(plateau_patience))
    k = np.zeros(G, np.int64)
    if k0 is not None:
        k[:Gr] = np.asarray(k0, np.int64)
    active = np.zeros(G, bool)
    active[:Gr] = k[:Gr] < L

    rows_l = [[] for _ in range(Gr)]
    rows_e = [[] for _ in range(Gr)]
    rows_m = [[] for _ in range(Gr)]
    rows_e1 = [[] for _ in range(Gr)]
    rows_t = [[] for _ in range(Gr)]
    nonconv = np.zeros(Gr)
    streak = np.zeros(Gr, np.int64)
    prev_m: list = [None] * Gr
    prev_e: list = [None] * Gr
    for g in range(Gr):
        pr = prev_rows[g] if prev_rows is not None and g < len(prev_rows) \
            else None
        streak[g], prev_m[g], prev_e[g] = _plateau_prefix(
            pr, plateau_eps, plateau_patience)
        if plateau_eps > 0 and streak[g] >= plateau_patience:
            active[g] = False       # already exited inside the prefix

    dev = ex.device
    chi = ex.stack_chi(chi_list)
    capture = boundary is not None
    # each cell's last-λ-boundary chi (the snapshot's state): before its
    # first crossing, its start state
    bchi = [np.asarray(torch.as_tensor(c).cpu()) if capture else None
            for c in chi_list]

    def info_active():
        return [{"g": g, "visited": int(k[g]),
                 "lmbd": float(lambdas[max(k[g] - 1, 0)]), "failed": False,
                 "chi": bchi[g]}
                for g in range(Gr) if active[g]]
    lam = np.zeros(G)
    lam[:Gr] = lambdas[np.minimum(k[:Gr], L - 1)]
    delta = torch.full((G,), torch.inf, dtype=ex.dtype, device=dev)
    t = torch.zeros(G, dtype=torch.int32, device=dev)
    need_leaf = active.copy()          # lanes entering a fresh λ
    a_t = None

    rec = obs.current()
    chunk_i = 0
    t_prev = np.zeros(G, np.int64)
    while active[:Gr].any():
        if need_leaf.any():
            chi = ex.set_leaves(chi, lam, need_leaf)
            a_t = ex.factors(lam)
            fresh = torch.as_tensor(need_leaf, device=dev)
            delta = torch.where(fresh, torch.inf, delta)
            t = torch.where(fresh, 0, t)
            t_prev[need_leaf] = 0
            need_leaf[:] = False
        # the chunk span closes after the chunk's host read of (delta, t),
        # so its wall includes the card; cold marks the first chunk
        with rec.span("pipeline.entropy.chunk", chunk=chunk_i,
                      cold=chunk_i == 0) as sp:
            chi, delta, t = ex.fixed_point_chunk(
                chi, a_t, torch.as_tensor(active, device=dev), delta, t)
            delta_h, t_h = delta.cpu().numpy(), t.cpu().numpy()
            if rec.enabled:
                sp.set(sweeps_advanced=int(np.sum(t_h[active]
                                                  - t_prev[active])),
                       active=int(np.sum(active[:Gr])))
        if rec.enabled:
            obs.memband.emit_memory_gauges(dev, loop="entropy.chunk",
                                           chunk=chunk_i)
        chunk_i += 1
        t_prev[:] = t_h

        # a lane is at its λ boundary when its own fixed point finished:
        # converged (delta <= eps; a NaN delta reads `> eps` as False) or
        # out of sweep budget
        crossed = [g for g in range(Gr) if active[g] and (
            not (float(delta_h[g]) > eps) or int(t_h[g]) >= ex.t_max)]
        for g in crossed:
            # one sweep.nan check per completed fixed point per cell
            if _faults.transform_spec("sweep.nan", "nan") is not None:
                chi = ex.poison_cell(chi, g)
                delta_h[g] = np.nan
        observed = {g: ex.observe(chi, g, float(lambdas[k[g]]))
                    for g in crossed}
        fired = []
        for g in crossed:
            lmv = float(lambdas[k[g]])
            phi, m0 = (x.cpu().numpy() for x in observed[g])
            e1 = phi + lmv * m0
            t_g = int(t_h[g])
            failed = float(delta_h[g]) > eps
            poisoned = bool(np.isnan(float(delta_h[g])) or np.isnan(phi).any()
                            or np.isnan(m0).any())
            if poisoned:
                failed = True
                log.warning(
                    "non-finite sweep state at lambda=%g (cell %d, delta=%r) "
                    "— recording non-convergence and stopping the cell's "
                    "ladder", lmv, g, delta_h[g])
                rec.counter("pipeline.sweep.nan", cell=g, lmbd=lmv)
                # the degrade is survivable, the evidence is kept: the
                # flight post-mortem (or the live ledger's obs.crash event)
                obs.flight.dump("sweep.nan",
                                site=f"entropy cell={g} lambda={lmv:g}")
            if failed:
                nonconv[g] = lmv
            rec.counter("pipeline.lambda.boundary", cell=g, lmbd=lmv,
                        sweeps=t_g, failed=failed)
            rows_l[g].append(lmv)
            rows_e[g].append(phi)
            rows_m[g].append(m0)
            rows_e1[g].append(e1)
            rows_t[g].append(t_g)
            if record is not None:
                record(g, int(k[g]), lmv, phi, m0, e1, t_g, failed)
            if verbose:
                print(f"cell={g} lambda={lmv:.2f} t={t_g} m_init={m0:.5f}")
            if capture:
                bchi[g] = ex.unstack_chi(chi, g).cpu().numpy()
            fired.append(lmv)

            # per-cell exits, then the next ladder position
            k[g] += 1
            if bool(np.all(np.asarray(e1) < ent_floor)) or failed \
                    or k[g] >= L:
                active[g] = False
                continue
            if plateau_eps > 0:
                if prev_m[g] is not None:
                    moved = max(float(np.max(np.abs(m0 - prev_m[g]))),
                                float(np.max(np.abs(e1 - prev_e[g]))))
                    streak[g] = streak[g] + 1 if moved < plateau_eps else 0
                    if streak[g] >= plateau_patience:
                        active[g] = False
                prev_m[g], prev_e[g] = m0, e1
                if not active[g]:
                    continue
            lam[g] = lambdas[k[g]]
            need_leaf[g] = True

        _beat("lambda")
        stopping = shutdown_requested()
        if boundary is not None and (fired or stopping):
            boundary(stopping, info_active())
        if stopping:
            raise_if_requested(where="lambda")
        for lmv in fired:
            _faults.maybe_fail("lambda.boundary", key=f"lmbd={lmv:g}")

    return CellLadderResult(
        lambdas=[np.array(r) for r in rows_l],
        ent=[np.array(r) for r in rows_e],
        m_init=[np.array(r) for r in rows_m],
        ent1=[np.array(r) for r in rows_e1],
        sweeps=[np.array(r, np.int64) for r in rows_t],
        nonconverged=nonconv,
        chi=[ex.unstack_chi(chi, g).cpu().numpy() for g in range(Gr)],
    )
