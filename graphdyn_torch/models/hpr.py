"""History-Passing reinforcement (HPr), the reinforced-BP solver (the port
of ``graphdyn/models/hpr.py``).

The reference's HPr loop (`HPR_pytorch_RRG.py:342-356`): iterate the
bias-weighted BDCM sweep, compute node marginals, reinforce per-node biases
toward the marginal winner with probability ``1−(1+t)^{−γ}``, read off the
trial solution ``s = argmax bias``, and stop when ``s`` flows to the all-+1
attractor under the (p,c) rollout, or after ``TT`` sweeps (sentinel
``m_final = 2``, `HPR:355`). The λ-tilt is ``exp(−λ·x_i(0))`` with λ = 25;
the DP does not mask invalid-endpoint source trajectories; marginals are
ε-clamped at 1e-15 (`HPR:147`).

Three drivers:

- :func:`hpr_solve`: one chain on one graph, through the grouped executor
  :class:`graphdyn_torch.pipeline.hpr_group.HPRGroupExec` at G=1 (so the
  grouped ensemble equals a loop of it);
- :func:`hpr_solve_batch`: R chains on one graph as a disjoint union in the
  replica-major layout (BASELINE config 2), with the union tables built on
  the device;
- :func:`hpr_ensemble`: ``n_rep`` repetitions on fresh RRGs, grouped
  (default) or serial (``group_size=0``).

Each sweep is one launch of the CUDA sweep kernel on the card
(``csrc/bdcm_sweep.cu``) and runs its plain PyTorch route on the CPU.
The reinforcement draws come from the port's counter-based stream
(:mod:`graphdyn_torch.pipeline.hpr_group`), or from ``uniforms=`` in tests.

Not ported yet: ``checkpoint_path`` (ROADMAP A16), ``mesh=`` (A15), and
``device_init=True`` (the reference draws that init from ``jax.random``;
A11's remainder). Each raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.config import HPRConfig
from graphdyn_torch.graphs import Graph, build_edge_tables
from graphdyn_torch.ops.bdcm import BDCMData, make_marginals, make_sweep
from graphdyn_torch.ops.dynamics import batched_rollout
from graphdyn_torch.ops.fused import _check_seed
from graphdyn_torch.ops.packed import _inv_n
from graphdyn_torch.pipeline.hpr_group import (
    as_uniforms,
    host_init,
    hpr_uniforms,
    reinforce,
    reinforce_threshold,
)
from graphdyn_torch.utils.platform import resolve_device


def _not_ported(arg: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{arg} is not ported to graphdyn_torch yet (ROADMAP.md {item})")


def _refuse(checkpoint_path=None, mesh=None, device_init=False) -> None:
    if checkpoint_path is not None:
        raise _not_ported("checkpoint_path", "A16: checkpoints and resilience")
    if mesh is not None:
        raise _not_ported("mesh=", "A15: parallel/ onto torch.distributed")
    if device_init:
        raise _not_ported(
            "device_init=True", "A11's remainder: the reference draws that "
            "initial state from jax.random; the port's union tables are "
            "built on the device already")


class HPRResult(NamedTuple):
    s: np.ndarray            # int8[n] — trial solution at stop
    mag_reached: np.ndarray  # f32 scalar — m(s) at stop (`HPR:359`)
    num_steps: int           # sweeps taken (`HPR:360`)
    m_final: float           # 1.0 success, 2.0 timeout sentinel
    biases: np.ndarray       # [n, 2] — final reinforcement biases
    chi: np.ndarray          # final messages
    elapsed_s: float         # wall-clock seconds (`HPR:257,364`)


class _HPRSetup(NamedTuple):
    """Per-graph preparation of the batched solver: the reference-faithful
    quirks (eps_clamp=0, unmasked invalid sources, the bias-to-edge
    gather)."""

    data: BDCMData
    sweep: object
    marginals: object
    bias_to_edge: object
    lmbd: torch.Tensor
    pie: torch.Tensor
    gamma: float
    TT: int
    n: int
    dtype: torch.dtype
    device: torch.device


def _prep(graph: Graph, config: HPRConfig, *, tables=None, kernel="auto",
          data: BDCMData | None = None, device=None) -> _HPRSetup:
    dyn = config.dynamics
    dev = resolve_device(device)
    tables = tables if tables is not None else build_edge_tables(graph)
    if data is None:
        data = BDCMData(
            graph, tables, p=dyn.p, c=dyn.c, attr_value=dyn.attr_value,
            rule=dyn.rule, tie=dyn.tie, dtype=config.dtype,
        )
    dt = data.dtype
    sweep = make_sweep(data, damp=config.damp, eps_clamp=0.0,
                       mask_invalid_src=False, with_bias=True, kernel=kernel,
                       device=dev)
    marginals = make_marginals(data, eps=config.eps_clamp, device=dev)
    src = torch.as_tensor(tables.src, device=dev).to(torch.int64)
    sel_plus = torch.as_tensor(data.x0 == 1, device=dev)

    def bias_to_edge(biases):
        # bias of the *source* node at its trajectory's initial value
        # (`positions_biases`, `HPR:120-133`): [2E, K]
        return torch.where(sel_plus, biases[src, 0, None], biases[src, 1, None])

    return _HPRSetup(
        data=data, sweep=sweep, marginals=marginals, bias_to_edge=bias_to_edge,
        lmbd=torch.tensor(config.lmbd, dtype=dt, device=dev),
        pie=torch.tensor(config.pie, dtype=dt, device=dev),
        gamma=float(config.gamma), TT=int(config.max_sweeps), n=graph.n,
        dtype=dt, device=dev,
    )


def hpr_solve(
    graph: Graph,
    config: HPRConfig | None = None,
    *,
    seed: int = 0,
    chi0=None,
    checkpoint_path: str | None = None,
    chunk_sweeps: int = 200,
    kernel: str = "auto",
    uniforms=None,
    device=None,
) -> HPRResult:
    """Run one HPr chain on one graph instance, on ``device`` (default
    CUDA; raises on a CUDA-less host unless given ``device='cpu'``).

    The chain advances through the grouped executor at G=1, ``chunk_sweeps``
    sweeps per host check of its stop flag (the chunking does not change the
    chain). ``kernel``: ``'auto'`` (the CUDA kernel on the card, the plain
    version on the CPU), ``'cuda'`` or ``'plain'``. ``uniforms``: None (the
    port's stream, keyed by ``seed``) or ``callable(t) -> [1, n]``, the
    reinforcement draw of sweep t."""
    from graphdyn_torch.pipeline.hpr_group import HPRGroupExec

    t_start = time.perf_counter()
    _refuse(checkpoint_path)
    dev = resolve_device(device)
    config = config or HPRConfig()
    dyn = config.dynamics
    n = graph.n
    tables = build_edge_tables(graph)
    data = BDCMData(
        graph, tables, p=dyn.p, c=dyn.c, attr_value=dyn.attr_value,
        rule=dyn.rule, tie=dyn.tie, dtype=config.dtype,
    )
    ex = HPRGroupExec([(graph, data)], config, kernel=kernel, device=dev,
                      uniforms=uniforms)
    chi0, biases0, s0 = host_init(np.random.default_rng(seed),
                                  data.num_directed, data.K, n, data.np_dtype,
                                  chi0=chi0)
    st = ex.init_state([chi0], [biases0], [s0], [seed])
    st = ex.run(st, chunk_sweeps=chunk_sweeps)
    s = st.s[0].cpu().numpy()
    return HPRResult(
        s=s,
        mag_reached=np.float32(s.astype(np.float64).mean()),
        num_steps=int(st.steps[0]),
        m_final=float(st.m_final[0]),
        biases=st.biases[0].cpu().numpy(),
        chi=st.chi[0].cpu().numpy(),
        elapsed_s=time.perf_counter() - t_start,
    )


class HPRBatchResult(NamedTuple):
    """Per-chain results of the replica-batched solver."""

    s: np.ndarray            # int8[R, n]
    mag_reached: np.ndarray  # f32[R]
    num_steps: np.ndarray    # int32[R] — sweeps until that chain stopped
    m_final: np.ndarray      # f32[R] — 1.0 success, 2.0 timeout sentinel
    elapsed_s: float


def union_setup(graph: Graph, config: HPRConfig, R: int, *, kernel="auto",
                device=None) -> _HPRSetup:
    """R-replica disjoint-union HPr setup in the REPLICA-MAJOR edge layout:
    replica ``r``'s directed edges occupy the rows ``[r·2E, (r+1)·2E)``, so
    every gather of the sweep, the marginals and the bias stays inside one
    replica's block. The union tables are built on ``device`` from the base
    graph's host tables (:func:`graphdyn_torch.ops.bdcm.
    replicate_bdcm_device`); only the base tables cross the host link."""
    from graphdyn_torch.ops.bdcm import replicate_bdcm_device

    dev = resolve_device(device)
    dyn = config.dynamics
    base = BDCMData(
        graph, p=dyn.p, c=dyn.c, attr_value=dyn.attr_value,
        rule=dyn.rule, tie=dyn.tie, dtype=config.dtype,
    )
    data_u = replicate_bdcm_device(base, R, dev)
    return _prep(data_u.graph, config, tables=data_u.tables, data=data_u,
                 kernel=kernel, device=dev)


def _draw_union_chi(rng, R: int, twoE: int, K: int, np_dt) -> np.ndarray:
    """Row-normalized random chi for the R-replica union, drawn replica by
    replica straight into the target dtype (a float64 draw of the whole
    union would be about 20 GB of host memory at config 2)."""
    out = np.empty((R * twoE, K, K), np_dt)
    for r in range(R):
        blk = rng.random((twoE, K, K))
        blk /= blk.sum(axis=(1, 2), keepdims=True)
        out[r * twoE : (r + 1) * twoE] = blk
    return out


class _BatchState(NamedTuple):
    chi: torch.Tensor       # [R·2E, K, K]
    biases: torch.Tensor    # [R·n, 2]
    s: torch.Tensor         # int8 [R·n]
    seeds: torch.Tensor     # int64 [R], the chains' stream seeds
    t: int                  # shared sweep clock (host)
    m_final: torch.Tensor   # f32 [R]
    active: torch.Tensor    # bool [R]
    steps: torch.Tensor     # int32 [R]


def _make_hpr_batch_body(setup: _HPRSetup, graph: Graph, R: int, uniforms):
    """One HPr iteration over an ``R``-replica union: sweep, marginals,
    reinforcement, per-replica rollout stop test, freeze masks. No host
    read. ``uniforms``: None (the Threefry stream of each chain's seed) or
    ``callable(t) -> [R·n]``."""
    n = graph.n
    data = setup.data
    steps_roll = data.p + data.c - 1
    dev, dt = setup.device, setup.dtype
    twoE = setup.data.num_directed // R
    nbr_b = torch.as_tensor(graph.nbr, dtype=torch.int32, device=dev)
    pm_minus = torch.stack([setup.pie, 1 - setup.pie])
    pm_plus = torch.stack([1 - setup.pie, setup.pie])
    inv_n = _inv_n(n, dev)

    def m_per_replica(s_u):
        # chains are structural copies of the BASE graph — roll them as a
        # batch over its neighbor table
        s_end = batched_rollout(nbr_b, s_u.reshape(R, n), steps_roll,
                                data.rule, data.tie)
        return s_end.sum(dim=1, dtype=torch.int32).to(torch.float32) * inv_n

    def body(st: _BatchState) -> _BatchState:
        chi_new = setup.sweep(st.chi, setup.lmbd, biases=st.biases)
        marg = setup.marginals(chi_new)                   # [R·n, 2]
        if uniforms is None:
            u = hpr_uniforms(st.seeds, st.t, st.t + 1, n, dt).reshape(R * n)
        else:
            u = as_uniforms(uniforms(st.t), dt, dev).reshape(R * n)
        thr = reinforce_threshold(st.t, setup.gamma, dt)
        biases_new, s_new = reinforce(marg, st.biases, u, thr, pm_minus,
                                      pm_plus)
        del marg, u
        t_new = st.t + 1
        m_new = (torch.full_like(st.m_final, 2.0) if t_new > setup.TT
                 else m_per_replica(s_new))
        # frozen chains keep their final state
        a = st.active
        an = a.repeat_interleave(n)
        chi = torch.where(a.repeat_interleave(twoE)[:, None, None], chi_new,
                          st.chi)
        del chi_new
        m_final = torch.where(a, m_new, st.m_final)
        return _BatchState(
            chi=chi,
            biases=torch.where(an[:, None], biases_new, st.biases),
            s=torch.where(an, s_new, st.s),
            seeds=st.seeds,
            t=t_new,
            m_final=m_final,
            active=(a & (m_final < 1.0) if t_new <= setup.TT
                    else torch.zeros_like(a)),
            steps=torch.where(a, torch.full_like(st.steps, t_new), st.steps),
        )

    return body


def make_hpr_batch_chunk(graph: Graph, config: HPRConfig, Rtot: int, *,
                         kernel: str = "auto", uniforms=None, device=None):
    """Build the chunk program ``(state, t_end) -> state`` advancing
    ``Rtot`` batched HPr chains until the sweep clock reaches ``t_end`` (a
    host loop of the body, no device→host read; frozen chains stay frozen),
    and its setup. Single device."""
    setup = union_setup(graph, config, Rtot, kernel=kernel, device=device)
    body = _make_hpr_batch_body(setup, graph, Rtot, uniforms)

    def run_chunk(st: _BatchState, t_end: int) -> _BatchState:
        while st.t < t_end:
            st = body(st)
        return st

    return run_chunk, setup


def hpr_solve_batch(
    graph: Graph,
    config: HPRConfig | None = None,
    *,
    n_replicas: int | None = None,
    seed: int = 0,
    mesh=None,
    checkpoint_path: str | None = None,
    chunk_sweeps: int = 200,
    device_init: bool = False,
    kernel: str = "auto",
    uniforms=None,
    device=None,
) -> HPRBatchResult:
    """Run R independent HPr chains on ONE graph as a single batched
    program — the BASELINE config-2 replica axis (`N=1e5, 256 replicas`).

    Chains batch as a disjoint-union graph in the replica-major edge layout
    (:func:`union_setup`, tables built on the device); chi is ``[R·2E, K,
    K]`` and replica ``r`` owns rows ``[r·2E, (r+1)·2E)``. The initial state
    is the reference's numpy draw (chi per replica, then the biases, from
    one ``default_rng(seed)``); chain r's reinforcement stream is keyed by
    ``seed + r``. Finished chains freeze under per-replica masks; the host
    reads ``any(active)`` once per ``chunk_sweeps`` sweeps. ``uniforms``:
    None or ``callable(t) -> [R·n]``."""
    t_start = time.perf_counter()
    _refuse(checkpoint_path, mesh, device_init)
    dev = resolve_device(device)
    config = config or HPRConfig()
    R = n_replicas if n_replicas is not None else config.n_replicas
    n = graph.n
    twoE = 2 * graph.num_edges
    dyn = config.dynamics
    K = 2 ** (dyn.p + dyn.c)
    if chunk_sweeps < 1:
        raise ValueError(f"chunk_sweeps must be >= 1, got {chunk_sweeps}")
    seeds = [_check_seed(seed + r) for r in range(R)]

    run_chunk, setup = make_hpr_batch_chunk(graph, config, R, kernel=kernel,
                                            uniforms=uniforms, device=dev)
    np_dt = setup.data.np_dtype
    rng = np.random.default_rng(seed)
    chi0, biases0, s0 = host_init(rng, R * twoE, K, R * n, np_dt,
                                  chi0=_draw_union_chi(rng, R, twoE, K, np_dt))

    s_dev = torch.as_tensor(s0, device=dev)
    # initial stop test: the base-graph batched rollout on the device; only
    # the [R] sums come back, the f64 division happens on the host
    s_end = batched_rollout(
        torch.as_tensor(graph.nbr, dtype=torch.int32, device=dev),
        s_dev.reshape(R, n), dyn.p + dyn.c - 1, dyn.rule, dyn.tie)
    sums = s_end.sum(dim=1, dtype=torch.int32).cpu().numpy()
    m0 = (sums.astype(np.int64) / n).astype(np.float32)
    st = _BatchState(
        chi=torch.from_numpy(chi0).to(dev),
        biases=torch.from_numpy(biases0).to(dev),
        s=s_dev,
        seeds=torch.tensor(seeds, dtype=torch.int64, device=dev),
        t=0,
        m_final=torch.from_numpy(m0).to(dev),
        active=torch.from_numpy(m0 < 1.0).to(dev),
        steps=torch.zeros(R, dtype=torch.int32, device=dev),
    )
    del chi0
    while bool(st.active.any()):
        st = run_chunk(st, min(st.t + int(chunk_sweeps), setup.TT + 2))
    s = st.s.cpu().numpy().reshape(R, n)
    return HPRBatchResult(
        s=s,
        mag_reached=s.astype(np.float64).mean(axis=1).astype(np.float32),
        num_steps=st.steps.cpu().numpy(),
        m_final=st.m_final.cpu().numpy(),
        elapsed_s=time.perf_counter() - t_start,
    )


class HPREnsembleResult(NamedTuple):
    """The reference driver's per-repetition arrays
    (`HPR_pytorch_RRG.py:251-255,359-362`)."""

    mag_reached: np.ndarray  # f[n_rep]
    conf: np.ndarray         # int8[n_rep, n]
    num_steps: np.ndarray    # int[n_rep]
    graphs: np.ndarray       # int32[n_rep, n, d]
    time: np.ndarray         # f[n_rep] wall-clock seconds (`HPR:364,370`)


def hpr_ensemble(
    n: int,
    d: int,
    config: HPRConfig | None = None,
    *,
    n_rep: int = 1,
    seed: int = 0,
    graph_method: str = "pairing",
    save_path: str | None = None,
    checkpoint_path: str | None = None,
    group_size: int | None = None,
    prefetch: int = 2,
    kernel: str = "auto",
    uniforms=None,
    device=None,
) -> HPREnsembleResult:
    """The reference's experiment driver (`HPR_pytorch_RRG.py:259-377`):
    ``n_rep`` repetitions, each on a freshly sampled RRG(n, d) with seed
    ``seed + k``; ``save_path`` writes the npz with the reference's keys
    (`HPR:377`). ``group_size``: None runs ``min(n_rep, 8)`` repetitions at
    a time as one program (:func:`graphdyn_torch.pipeline.hpr_group.
    hpr_ensemble_grouped`, with host prefetch); 0 runs the serial loop of
    :func:`hpr_solve`. Both give the same results element by element.
    ``uniforms``: None or ``callable(t) -> [n_rep, n]``."""
    _refuse(checkpoint_path)
    dev = resolve_device(device)
    if group_size is None:
        group_size = min(max(n_rep, 1), 8)
    if group_size:
        from graphdyn_torch.pipeline.hpr_group import hpr_ensemble_grouped

        return hpr_ensemble_grouped(
            n, d, config, n_rep=n_rep, seed=seed, graph_method=graph_method,
            save_path=save_path, group_size=group_size, prefetch=prefetch,
            kernel=kernel, device=dev, uniforms=uniforms,
        )
    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.utils.io import save_results_npz

    config = config or HPRConfig()
    mag = np.empty(n_rep, np.float64)
    conf = np.empty((n_rep, n), np.int8)
    steps = np.empty(n_rep, np.int64)
    graphs = np.empty((n_rep, n, d), np.int32)
    times = np.empty(n_rep, np.float64)
    for k in range(n_rep):
        g = random_regular_graph(n, d, seed=seed + k, method=graph_method)
        u_k = None if uniforms is None else (
            lambda t, k=k: np.asarray(uniforms(t))[k:k + 1])
        res = hpr_solve(g, config, seed=seed + k, kernel=kernel, uniforms=u_k,
                        device=dev)
        mag[k] = float(res.mag_reached)
        conf[k] = res.s
        steps[k] = res.num_steps
        graphs[k] = g.nbr
        times[k] = res.elapsed_s
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
