"""Chromatic-sweep annealing driver, the whole-independent-set search (the
port of ``graphdyn/search/chromatic.py``).

A distance-2 greedy colouring (deterministic per seed, host numpy)
partitions the graph into χ classes; each class step proposes and accepts
one entire class with the exact per-site ΔE of the SA objective
(:mod:`graphdyn_torch.ops.chromatic`), so a sweep costs χ class steps
instead of the serial chain's n. Restricted to ``p = c = 1``, the
interaction radius the colouring covers.

R independent replicas anneal together, 32 per word, each recording its
first passage to the target end-state magnetization. The uniforms come from
the port's counter stream (:func:`~graphdyn_torch.ops.chromatic.
sweep_uniforms`), so sweeps are reproducible per seed on the CPU and the
card alike; the reference draws from ``jax.random``, so in that mode only
statistics compare with it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.config import SAConfig
from graphdyn_torch.ops.chromatic import (
    ChromaticTables,
    ChromState,
    build_chromatic_tables,
    chromatic_chunk,
    replica_end_sums,
)
from graphdyn_torch.ops.packed import WORD, pack_spins, unpack_spins
from graphdyn_torch.resilience.shutdown import raise_if_requested
from graphdyn_torch.utils.platform import resolve_device


class ChromaticResult(NamedTuple):
    s: np.ndarray                # int8[R, n] configurations at stop
    m_end: np.ndarray            # f64[R] rolled-out end-state magnetization
    mag_reached: np.ndarray      # f64[R] m(s(0)) at stop
    steps_to_target: np.ndarray  # int64[R] first-passage class steps, −1
    sweeps_to_target: np.ndarray  # f64[R] the same in full sweeps, −1
    chi: int                     # colour classes = class steps per sweep
    sweeps: int                  # full sweeps run
    device_steps: int            # class steps run (= sweeps · χ)
    accepted: int                # cumulative accepted flips


def chromatic_anneal(
    graph,
    config: SAConfig | None = None,
    *,
    n_replicas: int = 32,
    seed: int = 0,
    m_target: float = 0.9,
    max_sweeps: int = 5000,
    chunk_sweeps: int = 64,
    stop_on_first: bool = False,
    tables: ChromaticTables | None = None,
    device=None,
) -> ChromaticResult:
    """Anneal R packed replicas by chromatic sweeps on ``device`` (default
    CUDA) until each reaches ``Σs_end ≥ ceil(m_target·n)`` or
    ``max_sweeps`` is spent, in chunks of ``chunk_sweeps`` sweeps with one
    host read before each chunk. The colouring and the initial replicas
    derive from ``seed`` as in the reference."""
    config = config or SAConfig()
    dyn = config.dynamics
    if dyn.p + dyn.c - 1 != 1:
        raise ValueError(
            "chromatic sweeps require p = c = 1 (one-step rollout): the "
            "distance-2 coloring covers interaction radius 2 exactly; "
            f"got p={dyn.p}, c={dyn.c} — use temper_search or the serial "
            "solver for longer rollouts"
        )
    if not (0.0 < m_target <= 1.0):
        raise ValueError(f"m_target must be in (0, 1], got {m_target}")
    if chunk_sweeps < 1:
        raise ValueError(f"chunk_sweeps must be >= 1, got {chunk_sweeps}")
    if max_sweeps < 1:
        raise ValueError(f"max_sweeps must be >= 1, got {max_sweeps}")
    dev = resolve_device(device)
    n = graph.n
    if tables is None:
        tables = build_chromatic_tables(graph, seed=seed)
    chi = tables.chi
    R = n_replicas
    W = -(-R // WORD)
    Rp = W * WORD
    rng = np.random.default_rng(seed)
    s0 = (2 * rng.integers(0, 2, size=(R, n)) - 1).astype(np.int8)
    sp = pack_spins(torch.from_numpy(s0).to(dev))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    nbr_ext, nbr_self, deg_ext = (t(tables.nbr_ext), t(tables.nbr_self),
                                  t(tables.deg_ext))
    masks = t(tables.masks.view(np.int32))
    class_sizes = t(tables.class_sizes.astype(np.int32))
    sum_end0 = replica_end_sums(sp, nbr_ext, deg_ext, n, tables.dmax,
                                dyn.rule, dyn.tie)
    target_sum = int(np.ceil(m_target * n))
    real = torch.zeros(Rp, dtype=torch.bool, device=dev)
    real[:R] = True
    # pad replicas (all −1 spins) freeze at t=0 and never record a passage
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    state = ChromState(
        sp=sp, sum_end=sum_end0,
        a=torch.full((Rp,), config.a0_frac * n, dtype=torch.float32,
                     device=dev),
        b=torch.full((Rp,), config.b0_frac * n, dtype=torch.float32,
                     device=dev),
        steps=zero, sweeps=zero,
        t_target=torch.where(real & (sum_end0 >= target_sum), 0,
                             -1).to(torch.int32),
        active=real & (sum_end0 < target_sum),
        accepted=zero, chunk_s=zero,
    )
    static = dict(
        n=n, dmax=tables.dmax, rule=dyn.rule, tie=dyn.tie,
        par_a=float(config.par_a), par_b=float(config.par_b),
        a_cap=float(config.a_cap_frac * n), b_cap=float(config.b_cap_frac * n),
        target_sum=target_sum, stop_on_first=bool(stop_on_first),
    )

    def running(st: ChromState) -> bool:
        go = bool(st.active.any())
        if stop_on_first:
            go = go and not bool((st.t_target >= 0).any())
        return go

    full, tail = divmod(int(max_sweeps), int(chunk_sweeps))
    # graftlint: disable-next-line=GD003,GD014  chunk_sweeps is a host int (the planned chunk sizes), not a tensor
    for cs in [int(chunk_sweeps)] * full + ([tail] if tail else []):
        if not running(state):
            break
        state = chromatic_chunk(
            state._replace(chunk_s=zero), seed, masks, class_sizes,
            nbr_ext, nbr_self, deg_ext, chunk_sweeps=cs, **static)
        # heartbeat; a graceful shutdown exits 75 here (nothing to save:
        # the sweeps re-derive from the seed)
        raise_if_requested(where="chunk")

    s_final = unpack_spins(state.sp, R).cpu().numpy()
    t_tgt = state.t_target[:R].cpu().numpy().astype(np.int64)
    return ChromaticResult(
        s=s_final,
        m_end=state.sum_end[:R].cpu().numpy().astype(np.float64) / n,
        mag_reached=s_final.astype(np.float64).sum(axis=1) / n,
        steps_to_target=t_tgt,
        sweeps_to_target=np.where(t_tgt >= 0, t_tgt / chi, -1.0),
        chi=chi,
        sweeps=int(state.sweeps),
        device_steps=int(state.steps),
        accepted=int(state.accepted),
    )
