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

``checkpoint_path`` gives exact resume, as in the JAX package: the chain
solvers snapshot their whole float state between chunks
(:class:`graphdyn_torch.utils.io.ChainCheckpointer`), so a resumed chain
equals the uninterrupted one bit for bit on the same device (the sweep
kernel's per-edge order does not depend on the grid); ``hpr_ensemble``
snapshots its completed repetitions (and, serially, the chain in flight at
``<path>_chain<k>``). The snapshot's identity carries the port's tag: the
JAX package's chains draw from ``jax.random``, so their snapshots are
refused.

``hpr_solve_batch(device_init=True)`` draws the initial chi, biases and
chain seeds on the device from the port's Threefry stream
(:func:`graphdyn_torch.ops.bdcm.draw_chi_device`), so nothing union-sized
crosses the host link; the draw is the same bits on the CPU and the card.

Not ported yet: ``mesh=`` (ROADMAP.md A15b, the ensemble meshes), which
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch import obs
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


#: the chain snapshot's arrays (``hpr_solve``)
_HPR_CHAIN_FIELDS = ("chi", "biases", "s", "seed", "t", "m_final")
#: the batched chains' snapshot arrays (``hpr_solve_batch``)
_HPR_BATCH_FIELDS = ("chi", "biases", "s", "seeds", "t", "m_final", "active",
                     "steps")


def _refuse(mesh=None) -> None:
    if mesh is not None:
        raise _not_ported("mesh=", "A15b: the ensemble meshes of hpr, "
                          "entropy and temper")


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
    checkpoint_interval_s: float = 30.0,
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
    reinforcement draw of sweep t. ``checkpoint_path``: exact resume
    (module docstring)."""
    from graphdyn_torch.pipeline.hpr_group import HPRGroupExec

    # the one timing idiom: an always-measuring obs span; its wall
    # feeds elapsed_s and its event lands in a live ledger
    _sw = obs.timed("solver.hpr").start()
    try:
        if chunk_sweeps < 1:
            raise ValueError(f"chunk_sweeps must be >= 1, got {chunk_sweeps}")
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
        ckpt = st = None
        if checkpoint_path is not None:
            from graphdyn_torch.utils.io import (
                ChainCheckpointer,
                run_fingerprint,
            )

            ckpt = ChainCheckpointer(
                checkpoint_path, kind="hpr_chain", seed=seed,
                fp=run_fingerprint(graph.edges, config, "graphdyn_torch",
                                   uniforms is not None),
                interval_s=checkpoint_interval_s)
            arrays = ckpt.load_state(
                check=lambda a: a["s"].shape == (n,) and a["chi"].shape
                == (data.num_directed, data.K, data.K))
            if arrays is not None:
                st = ex.init_state([arrays["chi"]], [arrays["biases"]],
                                   [arrays["s"]], [int(arrays["seed"])],
                                   t=int(arrays["t"]),
                                   m_final=[np.float32(arrays["m_final"])])
        if st is None:
            chi0, biases0, s0 = host_init(np.random.default_rng(seed),
                                          data.num_directed, data.K, n,
                                          data.np_dtype, chi0=chi0)
            st = ex.init_state([chi0], [biases0], [s0], [seed])
        if ckpt is None:
            st = ex.run(st, chunk_sweeps=chunk_sweeps)
        else:
            st = ckpt.drive(
                st, advance=lambda x: ex.advance(
                    x, min(x.t + int(chunk_sweeps), ex.spec.TT + 2)),
                active=lambda x: bool(x.active[0]),
                payload=lambda x: dict(zip(_HPR_CHAIN_FIELDS, (
                    x.chi[0].cpu().numpy(), x.biases[0].cpu().numpy(),
                    x.s[0].cpu().numpy(), np.int64(seed), np.int64(x.t),
                    x.m_final[0].cpu().numpy()))))
        s = st.s[0].cpu().numpy()
        return HPRResult(
            s=s,
            mag_reached=np.float32(s.astype(np.float64).mean()),
            num_steps=int(st.steps[0]),
            m_final=float(st.m_final[0]),
            biases=st.biases[0].cpu().numpy(),
            chi=st.chi[0].cpu().numpy(),
            elapsed_s=_sw.stop().wall_s,
        )
    finally:
        _sw.stop()      # the exception path closes the span too


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
    checkpoint_interval_s: float = 30.0,
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
    None or ``callable(t) -> [R·n]``. ``checkpoint_path``: exact resume
    (module docstring).

    ``device_init=True`` draws the initial state on the device instead
    (:func:`device_init_state`: chi, biases and the chains' stream seeds
    from the Threefry init stream keyed by ``seed``), the JAX package's
    ``device_init`` path with the port's own stream: only statistics
    compare with the host draw. As in the JAX package it refuses ``mesh=``
    and ``checkpoint_path=``."""
    # the one timing idiom: an always-measuring obs span; its wall
    # feeds elapsed_s and its event lands in a live ledger
    _sw = obs.timed("solver.hpr_batch").start()
    try:
        if device_init and mesh is not None:
            raise ValueError("device_init=True is incompatible with mesh=")
        if device_init and checkpoint_path is not None:
            raise ValueError(
                "device_init=True is incompatible with checkpoint_path=")
        _refuse(mesh)
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

        run_chunk, setup = make_hpr_batch_chunk(graph, config, R,
                                                kernel=kernel,
                                                uniforms=uniforms, device=dev)
        np_dt = setup.data.np_dtype
        ckpt = None
        st = None
        if checkpoint_path is not None:
            from graphdyn_torch.utils.io import (
                ChainCheckpointer,
                run_fingerprint,
            )

            ckpt = ChainCheckpointer(
                checkpoint_path, kind="hpr_batch_chain", seed=seed,
                fp=run_fingerprint(graph.edges, config, R, "graphdyn_torch",
                                   uniforms is not None),
                interval_s=checkpoint_interval_s)
            arrays = ckpt.load_state(
                check=lambda a: a["s"].shape == (R * n,)
                and a["t"].shape == (R,))
            if arrays is not None:
                st = _BatchState(**{
                    f: (int(arrays["t"][0]) if f == "t" else
                        torch.from_numpy(np.asarray(arrays[f])).to(dev))
                    for f in _HPR_BATCH_FIELDS})
        if st is None and device_init:
            st = _initial_state(graph, config, R, *device_init_state(
                R, n, twoE, K, setup.dtype, seed, dev))
        elif st is None:
            st = _batch_init(graph, config, R, seed, seeds, np_dt, K, twoE,
                             dev)
        if ckpt is None:
            while bool(st.active.any()):
                st = run_chunk(st, min(st.t + int(chunk_sweeps), setup.TT + 2))
        else:
            st = ckpt.drive(
                st, advance=lambda x: run_chunk(
                    x, min(x.t + int(chunk_sweeps), setup.TT + 2)),
                active=lambda x: bool(x.active.any()),
                payload=lambda x: {f: (np.full(R, x.t, np.int32) if f == "t"
                                       else getattr(x, f).cpu().numpy())
                                   for f in _HPR_BATCH_FIELDS})
        s = st.s.cpu().numpy().reshape(R, n)
        return HPRBatchResult(
            s=s,
            mag_reached=s.astype(np.float64).mean(axis=1).astype(np.float32),
            num_steps=st.steps.cpu().numpy(),
            m_final=st.m_final.cpu().numpy(),
            elapsed_s=_sw.stop().wall_s,
        )
    finally:
        _sw.stop()      # the exception path closes the span too


def _batch_init(graph: Graph, config: HPRConfig, R: int, seed: int, seeds,
                np_dt, K: int, twoE: int, dev) -> _BatchState:
    """The batched chains' initial state: the reference's numpy draw and
    the initial rollout stop test."""
    n = graph.n
    rng = np.random.default_rng(seed)
    chi0, biases0, s0 = host_init(rng, R * twoE, K, R * n, np_dt,
                                  chi0=_draw_union_chi(rng, R, twoE, K, np_dt))
    return _initial_state(
        graph, config, R, torch.from_numpy(chi0).to(dev),
        torch.from_numpy(biases0).to(dev), torch.as_tensor(s0, device=dev),
        torch.tensor(seeds, dtype=torch.int64, device=dev))


def device_init_state(R: int, n: int, twoE: int, K: int, dtype, seed: int,
                      device):
    """The on-device initial state of ``R`` batched chains, from the
    Threefry init stream keyed by ``seed``
    (:func:`graphdyn_torch.ops.bdcm.counter_draw`), the counterpart of the
    JAX package's ``device_init`` draw (``graphdyn/models/hpr.py:583-606``):
    chi ``[R·2E, K, K]`` row-normalized (purpose 0), biases ``[R·n, 2]``
    normalized per row (purpose 1), ``s0 = +1`` where ``b[:, 0] > b[:, 1]``,
    and one uint32 stream seed per chain (purpose 2, word 0 of counter
    ``r``). Every value is exact integer work or an IEEE add or divide in a
    fixed order, so the CPU and the card draw the same bits. Returns
    ``(chi0, biases0, s0, seeds)`` on ``device``."""
    from graphdyn_torch.ops.bdcm import counter_draw, draw_chi_device

    seed = _check_seed(seed)
    chi0 = draw_chi_device(seed, R * twoE, K, dtype, device)
    b = counter_draw(seed, 1, 0, 2 * R * n, dtype, device).view(R * n, 2)
    biases0 = b / (b[:, :1] + b[:, 1:])
    s0 = torch.where(biases0[:, 0] > biases0[:, 1], 1, -1).to(torch.int8)
    seeds = counter_draw(seed, 2, 0, R, torch.int64, device)
    return chi0, biases0, s0, seeds


def _initial_state(graph: Graph, config: HPRConfig, R: int, chi0, biases0,
                   s0, seeds) -> _BatchState:
    """The batched chains' state at t = 0 from device tensors: the initial
    rollout stop test on the base graph (only the [R] sums come back; the
    f64 division happens on the host)."""
    n = graph.n
    dyn = config.dynamics
    dev = s0.device
    s_end = batched_rollout(
        torch.as_tensor(graph.nbr, dtype=torch.int32, device=dev),
        s0.reshape(R, n), dyn.p + dyn.c - 1, dyn.rule, dyn.tie)
    sums = s_end.sum(dim=1, dtype=torch.int32).cpu().numpy()
    m0 = (sums.astype(np.int64) / n).astype(np.float32)
    return _BatchState(
        chi=chi0, biases=biases0, s=s0, seeds=seeds, t=0,
        m_final=torch.from_numpy(m0).to(dev),
        active=torch.from_numpy(m0 < 1.0).to(dev),
        steps=torch.zeros(R, dtype=torch.int32, device=dev),
    )


def ensemble_run_id(n: int, d: int, config: HPRConfig, *, n_rep: int,
                    seed: int, graph_method: str) -> dict:
    """The identity stamped into every ``hpr_ensemble`` driver snapshot,
    serial and grouped alike: the JAX package's keys and ``backend`` naming
    the port (whose reinforcement stream is not the JAX package's)."""
    return {"seed": seed, "n_rep": n_rep, "n": n, "d": d,
            "graph_method": graph_method, "config": repr(config),
            "backend": "graphdyn_torch"}


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
    checkpoint_interval_s: float = 30.0,
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
    ``uniforms``: None or ``callable(t) -> [n_rep, n]``.

    ``checkpoint_path`` makes the driver preemption-safe, as
    ``sa_ensemble``'s: the completed repetitions are snapshotted with the
    next repetition's index; serially the chain in flight checkpoints
    itself at ``<path>_chain<k>``, grouped an interrupted group runs again
    from its start. Snapshots pass between the paths and group sizes."""
    dev = resolve_device(device)
    if group_size is None:
        group_size = min(max(n_rep, 1), 8)
    if group_size:
        from graphdyn_torch.pipeline.hpr_group import hpr_ensemble_grouped

        return hpr_ensemble_grouped(
            n, d, config, n_rep=n_rep, seed=seed, graph_method=graph_method,
            save_path=save_path, checkpoint_path=checkpoint_path,
            checkpoint_interval_s=checkpoint_interval_s,
            group_size=group_size, prefetch=prefetch,
            kernel=kernel, device=dev, uniforms=uniforms,
        )
    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.pipeline.groups import GroupDriver
    from graphdyn_torch.resilience.shutdown import ShutdownRequested
    from graphdyn_torch.utils.io import save_results_npz

    config = config or HPRConfig()
    mag = np.empty(n_rep, np.float64)
    conf = np.empty((n_rep, n), np.int8)
    steps = np.empty(n_rep, np.int64)
    graphs = np.empty((n_rep, n, d), np.int32)
    times = np.empty(n_rep, np.float64)

    def payload():
        return {"mag_reached": mag, "conf": conf, "num_steps": steps,
                "time": times}

    drv = GroupDriver(checkpoint_path, checkpoint_interval_s,
                      ensemble_run_id(n, d, config, n_rep=n_rep, seed=seed,
                                      graph_method=graph_method), payload)
    start_k = drv.resume_into(payload())
    for k in range(start_k, n_rep):
        g = random_regular_graph(n, d, seed=seed + k, method=graph_method)
        u_k = None if uniforms is None else (
            lambda t, k=k: np.asarray(uniforms(t))[k:k + 1])
        try:
            res = hpr_solve(
                g, config, seed=seed + k, kernel=kernel, uniforms=u_k,
                checkpoint_path=(f"{checkpoint_path}_chain{k}"
                                 if checkpoint_path else None),
                checkpoint_interval_s=checkpoint_interval_s, device=dev)
        except ShutdownRequested:
            drv.save_prefix(k)
            raise
        mag[k] = float(res.mag_reached)
        conf[k] = res.s
        steps[k] = res.num_steps
        graphs[k] = g.nbr
        times[k] = res.elapsed_s
        drv.rep_boundary(k)
    for k in range(start_k):    # resumed prefix: graphs re-derive from seed+k
        graphs[k] = random_regular_graph(n, d, seed=seed + k,
                                         method=graph_method).nbr
    drv.finish()
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
