"""Batched multi-graph HPr chains (the port of
``graphdyn/pipeline/hpr_group.py``).

A group of ``G`` repetitions runs as one program: the per-repetition BDCM
index tables stack to ``[G, Ed, ...]`` ids into the flattened group axis,
chi carries a leading group axis, and the sweep (one launch of the sweep
kernel per sweep over every edge class and the group axis, one shared
``A·tilt``, the node biases read through each edge's source), the marginals, the reinforcement and the rollout stop test run
over the whole group. :func:`graphdyn_torch.models.hpr.hpr_solve` runs the
G=1 instance of the same executor, so grouped == serial holds by
construction: every op is elementwise, a gather, or a reduction over a fixed
trailing axis, and the kernel's per-edge arithmetic does not depend on G.

The reinforcement stream. The JAX package draws the uniforms from
``jax.random`` key splits, which the port does not reproduce. Every chain
here draws from a counter-based Threefry-2x32 stream
(:func:`graphdyn_torch.ops.fused.threefry2x32`) with

- key ``(chain seed, HPR_STREAM_TAG)``: the chain seed is ``seed + k`` for
  repetition k (the seed of ``hpr_solve``), ``seed + r`` for chain r of a
  batch;
- counter ``(sweep t, node i)``, node index local to the chain;
- float32 uniforms from the top 24 bits of the first output word, float64
  from 32 bits of the first word and the top 21 of the second (53 bits).

The stream of a chain is thus independent of the group size and of the
union block, the same on the CPU and the card, and needs no host state, so
the kernel path and the plain path see the same draws. Tests inject the
reference's own draws instead (``uniforms=``).

``run`` advances ``chunk_sweeps`` sweeps per chunk as a host loop of torch
ops with no device→host read inside the chunk; finished chains are frozen
by masks, so sweeps past the last stop change nothing. The host reads
``any(active)`` once per chunk. ``lower_loop`` has no counterpart
(ROADMAP A18); checkpoints come with A16.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.config import HPRConfig
from graphdyn_torch.graphs import stack_graphs
from graphdyn_torch.ops.bdcm import (
    NodeBias,
    _flat_ids,
    _SweepSpec,
    _sweep_core,
    as_dtype,
    marginal_tables,
    marginals_group,
    resolve_modes,
    sweep_tables,
    tilted_factors,
)
from graphdyn_torch.ops.dynamics import batched_rollout
from graphdyn_torch.ops.fused import _M32, _check_seed, threefry2x32
from graphdyn_torch.ops.packed import _inv_n
from graphdyn_torch.utils.platform import resolve_device

# key word 1 of the reinforcement stream (key word 0 is the chain seed)
HPR_STREAM_TAG = 0x48505231  # b"HPR1"
_U_ELEMS = 1 << 22           # uniforms generated per block (int64 temporaries)


def hpr_uniforms(seeds: torch.Tensor, t0: int, t1: int, n: int,
                 dtype) -> torch.Tensor:
    """The reinforcement stream of the chains ``seeds`` (int64 [G], uint32
    values) for sweeps ``t0 .. t1-1``: uniforms ``[t1 - t0, G, n]`` in
    ``dtype`` on ``seeds``' device (see the module docstring)."""
    dt = as_dtype(dtype)
    dev = seeds.device
    t = (torch.arange(t0, t1, dtype=torch.int64, device=dev) & _M32)
    y0, y1 = threefry2x32(seeds.to(torch.int64)[None, :, None], HPR_STREAM_TAG,
                          t[:, None, None],
                          torch.arange(n, dtype=torch.int64, device=dev))
    if dt == torch.float32:
        return (y0 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return ((y0 << 21) | (y1 >> 11)).to(torch.float64) * (1.0 / (1 << 53))


def reinforce_threshold(t: int, gamma: float, dtype) -> float:
    """``1 − (1 + t)^(−γ)`` in the message dtype (host numpy, so the CPU and
    the card compare against the same value): reinforce a node when its
    uniform falls below it (`HPR_pytorch_RRG.py:135-145`)."""
    f = np.float32 if as_dtype(dtype) == torch.float32 else np.float64
    return float(f(1.0) - (f(1.0) + f(t)) ** (-f(gamma)))


def reinforce(marg, biases, u, thr: float, pm_minus, pm_plus):
    """One reinforcement step (`new_biases_i`, `HPR:137-145`): bias toward
    the marginal winner where ``u < thr``; returns ``(biases', s')`` with
    ``s' = argmax bias`` as int8 ±1."""
    minus_wins = marg[..., 1] >= marg[..., 0]
    new_bias = torch.where(minus_wins[..., None], pm_minus, pm_plus)
    update = u < thr
    biases_new = torch.where(update[..., None], new_bias, biases)
    s_new = torch.where(biases_new[..., 0] > biases_new[..., 1], 1, -1)
    return biases_new, s_new.to(torch.int8)


def as_uniforms(u, dtype, device) -> torch.Tensor:
    """An injected uniform draw (numpy array or tensor) as a tensor."""
    if isinstance(u, torch.Tensor):
        return u.to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(u), dtype=dtype, device=device)


class _HPRGroupSpec(NamedTuple):
    """Static configuration of one grouped HPr program."""

    T: int
    K: int
    n: int
    damp: float
    eps: float            # marginal ε-clamp (`HPR:147`)
    TT: int
    rollout_steps: int
    rule: str
    tie: str
    class_ds: tuple       # per-edge-class incoming-message count d
    modes: tuple          # per class 'cuda' | 'plain'


class _HPRGroupState(NamedTuple):
    chi: torch.Tensor      # [G, 2E, K, K]
    biases: torch.Tensor   # [G, n, 2]
    s: torch.Tensor        # int8 [G, n]
    seeds: torch.Tensor    # int64 [G], the chains' stream seeds
    t: int                 # shared sweep clock (host)
    m_final: torch.Tensor  # f32 [G]
    active: torch.Tensor   # bool [G]
    steps: torch.Tensor    # int32 [G], per-chain stop sweep


def _group_m_of_end(nbr_union, s, spec: _HPRGroupSpec, inv_n):
    """Per-repetition rollout magnetization, each on its own graph: the
    group's graphs as one disjoint union, rolled as one row (integer
    arithmetic, exact), summed per member, times the f32 reciprocal of n
    (the JAX package's compiled division)."""
    G, n = s.shape
    s_end = batched_rollout(nbr_union, s.reshape(1, G * n),
                            spec.rollout_steps, spec.rule, spec.tie)
    return s_end.reshape(G, n).sum(dim=1, dtype=torch.int32).to(
        torch.float32) * inv_n


class HPRGroupResult(NamedTuple):
    s: np.ndarray          # int8[G, n]
    num_steps: np.ndarray  # int32[G]
    m_final: np.ndarray    # f32[G]


def host_init(rng, num_directed: int, K: int, n: int, np_dtype, chi0=None):
    """``hpr_solve``'s numpy init, the JAX package's bit for bit: row-
    normalised chi ``[num_directed, K, K]`` (unless ``chi0`` is given), then
    the biases ``[n, 2]``, from one stream ``rng``, cast to the message
    dtype; and the trial solution ``s0`` from the cast biases, the values the
    device compares. Returns ``(chi0, biases0, s0)``."""
    if chi0 is None:
        chi0 = rng.random((num_directed, K, K))
        chi0 /= chi0.sum(axis=(1, 2), keepdims=True)
    biases0 = rng.random((n, 2))
    biases0 /= biases0.sum(axis=1, keepdims=True)
    biases0 = biases0.astype(np_dtype)
    s0 = np.where(biases0[:, 0] > biases0[:, 1], 1, -1).astype(np.int8)
    return np.asarray(chi0).astype(np_dtype, copy=False), biases0, s0


def _build_rep(n, d, config: HPRConfig, rep_seed: int, graph_method: str):
    """Host build for ONE repetition — everything that depends only on
    ``seed + k``: graph, edge tables, BDCM factor data, and the serial
    solver's exact host init (:func:`host_init` from ``default_rng(seed +
    k)``)."""
    from graphdyn_torch.graphs import build_edge_tables, random_regular_graph
    from graphdyn_torch.ops.bdcm import BDCMData

    dyn = config.dynamics
    g = random_regular_graph(n, d, seed=rep_seed, method=graph_method)
    tables = build_edge_tables(g)
    data = BDCMData(
        g, tables, p=dyn.p, c=dyn.c, attr_value=dyn.attr_value,
        rule=dyn.rule, tie=dyn.tie, dtype=config.dtype,
    )
    return (g, data) + host_init(np.random.default_rng(rep_seed),
                                 data.num_directed, data.K, n, data.np_dtype)


class HPRGroupExec:
    """One (padded) group of congruent HPr chains: stacked tables on the
    device, the static spec, init and chunked advance. The single executor
    every HPr chain of the drivers runs through (``hpr_solve`` at G=1, the
    grouped ensemble at G=``group_size``).

    ``kernel``: ``'auto'`` runs each sweep through the CUDA sweep kernel on
    the card and the plain version on the CPU; ``'cuda'`` requires the
    kernel; ``'plain'`` forces the plain version (tests). ``uniforms``:
    None (the port's Threefry stream) or ``callable(t) -> [G_real, n]``, an
    injected draw for sweep t."""

    def __init__(self, items, config: HPRConfig, *,
                 group_size: int | None = None, kernel: str = "auto",
                 device=None, uniforms=None):
        G_real = len(items)
        G = group_size or G_real
        if G < G_real:
            raise ValueError(f"group_size={G} < group population {G_real}")
        dev = resolve_device(device)
        dyn = config.dynamics
        datas = [it[1] for it in items]
        d0 = datas[0]
        sig = [(c.d, c.idx.shape[0]) for c in d0.edge_classes]
        for dd in datas[1:]:
            if (dd.n != d0.n or dd.K != d0.K
                    or [(c.d, c.idx.shape[0]) for c in dd.edge_classes] != sig):
                raise ValueError(
                    "grouped HPr repetitions must be structurally congruent "
                    "(same n and degree-class signature — RRG ensembles are)"
                )
        if d0.leaf_idx.size:
            raise ValueError(
                "the batched HPr program does not cover leaf edges "
                "(degree-1 nodes)"
            )
        if d0.padded:
            raise ValueError("the grouped HPr program takes unpadded classes")

        padded = list(items) + [items[0]] * (G - G_real)
        pdatas = [it[1] for it in padded]
        dt = d0.dtype
        n, twoE, K = d0.n, d0.num_directed, d0.K
        self.G, self.G_real, self.d0, self.device = G, G_real, d0, dev
        self.dtype = dt
        self.uniforms = uniforms
        class_ds = tuple(c.d for c in d0.edge_classes)
        self.spec = _HPRGroupSpec(
            T=d0.T, K=K, n=n, damp=float(config.damp),
            eps=float(config.eps_clamp), TT=int(config.max_sweeps),
            rollout_steps=dyn.p + dyn.c - 1, rule=dyn.rule, tie=dyn.tie,
            class_ds=class_ds,
            modes=resolve_modes(class_ds, T=d0.T, dtype=dt, kernel=kernel,
                                device=dev),
        )
        # the HPr sweep variant (`hpr.py:95-98`): bias-weighted, invalid
        # sources unmasked, no ε-clamp
        self.sweep_spec = _SweepSpec(
            T=d0.T, K=K, damp=float(config.damp), eps_clamp=0.0,
            mask_invalid_src=False, with_bias=True, padded=False,
            class_ds=class_ds, modes=self.spec.modes,
        )
        # the bias of each in-edge is read through its source node
        # (`positions_biases`, `HPR:120-133`): no [G, 2E, K] tensor
        self.tables = sweep_tables(
            [(_flat_ids([dd.edge_classes[k].idx for dd in pdatas], twoE, dev),
              _flat_ids([dd.edge_classes[k].in_edges for dd in pdatas], twoE,
                        dev))
             for k in range(len(class_ds))], self.sweep_spec, G=G, rows=twoE,
            valid=torch.as_tensor(d0.valid, dtype=dt, device=dev),
            src=_flat_ids([dd.tables.src for dd in pdatas], n, dev).reshape(-1))
        self.rev, self.out_edges, self.sel_plus = marginal_tables(pdatas, dev)
        nbr = stack_graphs([it[0] for it in padded]).nbr.astype(np.int64)
        off = (np.arange(G, dtype=np.int64) * n)[:, None, None]
        self.nbr_union = torch.as_tensor(
            np.where(nbr == n, G * n, nbr + off).reshape(G * n, -1),
            dtype=torch.int32, device=dev)
        x0 = torch.as_tensor(d0.x0, dtype=dt, device=dev)
        # one λ across the group -> the SHARED A_tilted variant
        self.a_tilted = tilted_factors(
            [torch.as_tensor(c.A, dtype=dt, device=dev)
             for c in d0.edge_classes], x0, torch.tensor(config.lmbd, dtype=dt,
                                                         device=dev))
        pie = torch.tensor(config.pie, dtype=dt, device=dev)
        self.pm_minus = torch.stack([pie, 1 - pie])
        self.pm_plus = torch.stack([1 - pie, pie])
        self.gamma = float(config.gamma)
        self.inv_n = _inv_n(n, dev)

    def init_state(self, chi0, biases0, s0, rep_seeds, *, t=0, m_final=None,
                   steps=None) -> _HPRGroupState:
        """State from per-member host arrays (length ``G_real`` lists; pad
        rows are appended here and start frozen). ``m_final=None`` runs
        the initial rollout stop test — the serial solver's
        ``m_of_end(s0)``."""
        dev, dt, G = self.device, self.dtype, self.G

        def stack(rows, dtype):
            rows = list(rows) + [rows[0]] * (G - self.G_real)
            return torch.stack([torch.as_tensor(np.asarray(r), dtype=dtype)
                                for r in rows]).to(dev)

        seeds = [_check_seed(sd) for sd in rep_seeds]
        seeds = torch.tensor(seeds + [seeds[0]] * (G - self.G_real),
                             dtype=torch.int64, device=dev)
        s = stack(s0, torch.int8)
        real = torch.zeros(G, dtype=torch.bool, device=dev)
        real[:self.G_real] = True
        if m_final is None:
            m0 = _group_m_of_end(self.nbr_union, s, self.spec, self.inv_n)
        else:
            m0 = stack([np.float32(m) for m in m_final], torch.float32)
        steps0 = (torch.full((G,), int(t), dtype=torch.int32, device=dev)
                  if steps is None else stack(steps, torch.int32))
        return _HPRGroupState(
            chi=stack(chi0, dt), biases=stack(biases0, dt), s=s, seeds=seeds,
            t=int(t), m_final=m0, active=(m0 < 1.0) & real, steps=steps0,
        )

    def _uniform_block(self, st: _HPRGroupState, t0: int, t1: int):
        """Uniforms ``[t1 - t0, G, n]`` for sweeps t0..t1-1: the injected
        draws (pad rows 0) or the Threefry stream."""
        G, n = self.G, self.spec.n
        if self.uniforms is None:
            return hpr_uniforms(st.seeds, t0, t1, n, self.dtype)
        out = torch.zeros((t1 - t0, G, n), dtype=self.dtype, device=self.device)
        for i, t in enumerate(range(t0, t1)):
            u = as_uniforms(self.uniforms(t), self.dtype, self.device)
            out[i, :self.G_real] = u.reshape(self.G_real, n)
        return out

    def sweep_terms(self, st: _HPRGroupState, u: torch.Tensor) -> dict:
        """The terms of sweep ``st.t`` from ``st``: the new messages, the
        marginals, the threshold and the reinforced ``(biases, s)`` before
        the freeze masks (the loop body, and the near-tie replay)."""
        G, n = self.G, self.spec.n
        chi_new = _sweep_core(st.chi, self.a_tilted,
                              NodeBias(st.biases.reshape(G * n, 2)), None,
                              self.tables, self.sweep_spec)
        marg = marginals_group(chi_new, self.rev, self.out_edges,
                               self.sel_plus, self.spec.eps)   # [G, n, 2]
        thr = reinforce_threshold(st.t, self.gamma, self.dtype)
        biases_new, s_new = reinforce(marg, st.biases, u, thr, self.pm_minus,
                                      self.pm_plus)
        return {"chi": chi_new, "marg": marg, "thr": thr, "u": u,
                "biases": biases_new, "s": s_new}

    def step(self, st: _HPRGroupState, u: torch.Tensor,
             terms: dict | None = None) -> _HPRGroupState:
        """One sweep with the freeze masks (no host read)."""
        spec = self.spec
        terms = terms or self.sweep_terms(st, u)
        t_new = st.t + 1
        if t_new > spec.TT:
            m_new = torch.full_like(st.m_final, 2.0)
        else:
            m_new = _group_m_of_end(self.nbr_union, terms["s"], spec,
                                    self.inv_n)
        an = st.active                               # frozen chains keep state
        m_final = torch.where(an, m_new, st.m_final)
        active = an & (m_final < 1.0) if t_new <= spec.TT else \
            torch.zeros_like(an)
        return _HPRGroupState(
            chi=torch.where(an[:, None, None, None], terms["chi"], st.chi),
            biases=torch.where(an[:, None, None], terms["biases"], st.biases),
            s=torch.where(an[:, None], terms["s"], st.s),
            seeds=st.seeds,
            t=t_new,
            m_final=m_final,
            active=active,
            steps=torch.where(an, torch.full_like(st.steps, t_new), st.steps),
        )

    def advance(self, st: _HPRGroupState, t_end: int) -> _HPRGroupState:
        """Sweeps ``st.t .. t_end-1`` as a host loop of torch ops, with no
        device→host read."""
        per_block = max(1, _U_ELEMS // (self.G * self.spec.n))
        t0 = st.t
        while t0 < t_end:
            t1 = min(t_end, t0 + per_block)
            U = self._uniform_block(st, t0, t1)
            for i in range(t1 - t0):
                st = self.step(st, U[i])
            t0 = t1
        return st

    def run(self, st: _HPRGroupState, *,
            chunk_sweeps: int = 200) -> _HPRGroupState:
        """Advance until every member stops, ``chunk_sweeps`` sweeps per
        chunk, reading ``any(active)`` once per chunk."""
        if chunk_sweeps < 1:
            raise ValueError(f"chunk_sweeps must be >= 1, got {chunk_sweeps}")
        while bool(st.active.any()):
            st = self.advance(st, min(st.t + int(chunk_sweeps),
                                      self.spec.TT + 2))
        return st


def run_hpr_group(items, rep_seeds, config: HPRConfig, *,
                  group_size: int | None = None, chunk_sweeps: int = 200,
                  kernel: str = "auto", device=None,
                  uniforms=None) -> HPRGroupResult:
    """Run one group of HPr chains (one per freshly sampled graph).
    ``items`` are :func:`_build_rep` outputs; ``group_size`` pads with
    inactive rows; ``uniforms`` as in :class:`HPRGroupExec`."""
    ex = HPRGroupExec(items, config, group_size=group_size, kernel=kernel,
                      device=device, uniforms=uniforms)
    st = ex.init_state([it[2] for it in items], [it[3] for it in items],
                       [it[4] for it in items], rep_seeds)
    st = ex.run(st, chunk_sweeps=chunk_sweeps)
    return HPRGroupResult(
        s=st.s[:ex.G_real].cpu().numpy(),
        num_steps=st.steps[:ex.G_real].cpu().numpy(),
        m_final=st.m_final[:ex.G_real].cpu().numpy(),
    )


def hpr_ensemble_grouped(
    n: int,
    d: int,
    config: HPRConfig | None = None,
    *,
    n_rep: int = 1,
    seed: int = 0,
    graph_method: str = "pairing",
    save_path: str | None = None,
    checkpoint_path: str | None = None,
    group_size: int = 8,
    prefetch: int = 2,
    chunk_sweeps: int = 200,
    kernel: str = "auto",
    device=None,
    uniforms=None,
):
    """The grouped HPr experiment driver: ``n_rep`` repetitions on fresh
    RRG(n, d) instances, ``group_size`` at a time as one program, with the
    next repetitions' graphs and tables built on a background thread.
    Element-wise identical to the serial ``hpr_ensemble(group_size=0)``.
    ``uniforms``: None or ``callable(t) -> [n_rep, n]`` (each group takes
    its rows). Per-repetition wall time is the group's divided evenly."""
    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.models.hpr import HPREnsembleResult, _refuse
    from graphdyn_torch.pipeline.groups import group_ranges
    from graphdyn_torch.pipeline.prefetch import HostPrefetcher
    from graphdyn_torch.utils.io import save_results_npz

    _refuse(checkpoint_path)
    config = config or HPRConfig()
    dev = resolve_device(device)
    mag = np.empty(n_rep, np.float64)
    conf = np.empty((n_rep, n), np.int8)
    steps = np.empty(n_rep, np.int64)
    graphs = np.empty((n_rep, n, d), np.int32)
    times = np.empty(n_rep, np.float64)


    def build(k):
        return _build_rep(n, d, config, seed + k, graph_method)

    with HostPrefetcher(build, range(n_rep), depth=prefetch) as pf:
        for ks in group_ranges(0, n_rep, group_size):
            t0 = time.perf_counter()
            items = [pf.get(i) for i in ks]
            u_grp = None if uniforms is None else (
                lambda t, ks=ks: np.asarray(uniforms(t))[ks])
            res = run_hpr_group(
                items, [seed + i for i in ks], config,
                group_size=group_size, chunk_sweeps=chunk_sweeps,
                kernel=kernel, device=dev, uniforms=u_grp,
            )
            elapsed = time.perf_counter() - t0
            for j, i in enumerate(ks):
                conf[i] = res.s[j]
                # the serial result's f32 mean, widened into the f64 array
                mag[i] = np.float32(res.s[j].astype(np.float64).mean())
                steps[i] = res.num_steps[j]
                graphs[i] = items[j][0].nbr
                times[i] = elapsed / len(ks)
    out = HPREnsembleResult(mag, conf, steps, graphs, times)
    if save_path:
        save_results_npz(
            save_path,
            mag_reached=out.mag_reached,
            conf=out.conf,
            num_steps=out.num_steps,
            graphs=out.graphs,
            time=out.time,
        )
    return out
