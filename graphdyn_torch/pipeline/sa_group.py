"""Batched multi-graph SA ensembles (the port of
``graphdyn/pipeline/sa_group.py``).

The serial driver (:func:`graphdyn_torch.models.sa.sa_ensemble`) runs
``n_stat`` single-replica chains one after another, each on its own RRG.
Here a group of ``G`` repetitions runs as one batched program: the neighbor
tables stack to ``nbr[G, n, dmax]``, the chain state has a leading group
axis, and each row's candidate rolls out on its own graph (one gather whose
index rows point into each row's own state,
:func:`graphdyn_torch.ops.lightcone._neighbor_index`; the serial solver's
end sum with that index is the reference's ``_group_end_sum``).

Element for element equal to the serial path by construction: the chunk is
the serial solver's own :func:`~graphdyn_torch.models.sa._sa_loop` (same
draws, same Metropolis arithmetic, integer rollouts), a repetition's stream
is keyed by ``seed + k`` in both, and finished rows are frozen by the same
``active`` mask. A short tail group is padded with inactive copies of its
first row, so every group has the same shape.

The JAX package's ``GroupDriver`` checkpoints wait for ROADMAP A16
(``checkpoint_path`` raises there, as in
:func:`~graphdyn_torch.models.sa.sa_ensemble`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.config import SAConfig
from graphdyn_torch.models import sa as _sa
from graphdyn_torch.ops.dynamics import rule_coefficients
from graphdyn_torch.ops.lightcone import _neighbor_index
from graphdyn_torch.utils.platform import resolve_device


class _SAGroupState(NamedTuple):
    s: torch.Tensor         # int8[G, n]
    sum_end: torch.Tensor   # int32[G]
    a: torch.Tensor         # f[G]
    b: torch.Tensor         # f[G]
    t: torch.Tensor         # int32[G]
    m_final: torch.Tensor   # f[G]
    active: torch.Tensor    # bool[G]
    key: torch.Tensor       # int64[G] — each repetition's stream seed
    chunk_t: torch.Tensor   # int32[]


def _sa_group_init(idx, s0, key0, a0, b0, real, *, rollout_steps: int,
                   R_coef: int, C_coef: int) -> _SAGroupState:
    st = _sa._sa_init(idx, s0, key0, a0, b0, rollout_steps=rollout_steps,
                      R_coef=R_coef, C_coef=C_coef)
    return _SAGroupState(*st[:6], st.active & real, st.key, st.chunk_t)


def _sa_group_loop(idx, state: _SAGroupState, consts: dict, *,
                   rollout_steps: int, R_coef: int, C_coef: int,
                   max_steps: int, chunk_steps: int) -> _SAGroupState:
    """``chunk_steps`` masked steps of every chain of the group: the serial
    solver's chunk on the group axis, in counter-stream mode."""
    G = state.s.shape[0]
    placeholder = torch.zeros((G, 1), dtype=torch.int32, device=state.s.device)
    st = _sa._sa_loop(
        idx, _sa._SAState(*state, traj=state.s.new_zeros((G, 0, 0))), consts,
        placeholder, placeholder, rollout_steps=rollout_steps,
        R_coef=R_coef, C_coef=C_coef, max_steps=max_steps, injected=False,
        stream_len=1, chunk_steps=chunk_steps)
    return _SAGroupState(*st[:9])


class SAGroupResult(NamedTuple):
    s: np.ndarray          # int8[G, n]
    num_steps: np.ndarray  # int[G]
    m_final: np.ndarray    # f[G]


def _assemble_group(graphs, preps, rep_seeds, config: SAConfig, *, dtype,
                    group_size, device):
    """The group's tables, initial state and constants: the stacked
    per-repetition gather index (a short group padded with copies of its
    first row, inactive), the :func:`~graphdyn_torch.models.sa.
    prepare_sa_inputs` tuples' ``s0``/``a0``/``b0``, and stream seeds
    ``seed + k``."""
    G_real = len(graphs)
    G = group_size or G_real
    if G < G_real:
        raise ValueError(f"group_size={G} < group population {G_real}")
    dyn = config.dynamics
    R_coef, C_coef = rule_coefficients(dyn.rule, dyn.tie)
    rollout = dyn.p + dyn.c - 1
    dt = _sa.resolve_dtype(dtype)
    np_dt = np.float32 if dt == torch.float32 else np.float64
    n = graphs[0].n
    budgets = {int(p[7]) for p in preps}
    if len(budgets) != 1:
        raise ValueError(f"group mixes step budgets: {sorted(budgets)}")
    max_steps = budgets.pop()

    def pad(rows):
        return rows + [rows[0]] * (G - G_real)

    from graphdyn_torch.graphs import stack_graphs

    nbr = torch.from_numpy(stack_graphs(pad(list(graphs))).nbr).to(device)
    idx = _neighbor_index(nbr, n)
    s0 = np.concatenate(pad([p[2] for p in preps]))
    a0 = np.concatenate(pad([p[3] for p in preps])).astype(np_dt)
    b0 = np.concatenate(pad([p[4] for p in preps])).astype(np_dt)
    keys = torch.tensor([int(s) & 0xFFFFFFFF for s in pad(list(rep_seeds))],
                        dtype=torch.int64, device=device)
    real = torch.zeros(G, dtype=torch.bool, device=device)
    real[:G_real] = True
    state = _sa_group_init(
        idx, torch.from_numpy(s0).to(device), keys,
        torch.from_numpy(a0).to(device), torch.from_numpy(b0).to(device),
        real, rollout_steps=rollout, R_coef=R_coef, C_coef=C_coef)
    consts = _sa.sa_consts(config, n, dt, device)
    static = dict(rollout_steps=rollout, R_coef=R_coef, C_coef=C_coef,
                  max_steps=max_steps)
    return G_real, idx, state, consts, static


def run_sa_group(graphs, preps, rep_seeds, config: SAConfig, *,
                 dtype="float32", group_size: int | None = None,
                 chunk_steps: int = _sa.CHUNK_STEPS, on_chunk=None,
                 device=None) -> SAGroupResult:
    """Run one group of single-replica SA chains as one batched program on
    ``device`` (default CUDA): ``graphs``/``preps``/``rep_seeds`` per repetition (the
    graph, the :func:`~graphdyn_torch.models.sa.prepare_sa_inputs` tuple for
    ``n_replicas=1, seed=seed+k``, and ``seed+k``). ``group_size`` pads the
    batch with inactive rows; ``on_chunk(state)`` is called after each
    chunk. One host read per chunk."""
    G_real, idx, state, consts, static = _assemble_group(
        graphs, preps, rep_seeds, config, dtype=dtype, group_size=group_size,
        device=resolve_device(device))

    def advance(st):
        return _sa_group_loop(
            idx, st._replace(chunk_t=torch.zeros_like(st.chunk_t)), consts,
            chunk_steps=int(chunk_steps), **static)

    state = _sa.run_chunks(advance, state, on_chunk=on_chunk)
    return SAGroupResult(
        s=state.s[:G_real].cpu().numpy(),
        num_steps=state.t[:G_real].cpu().numpy(),
        m_final=state.m_final[:G_real].cpu().numpy(),
    )


def sa_ensemble_grouped(
    n: int,
    d: int,
    config: SAConfig | None = None,
    *,
    n_stat: int = 5,
    seed: int = 0,
    graph_method: str = "pairing",
    max_steps: int | None = None,
    save_path: str | None = None,
    checkpoint_path: str | None = None,
    group_size: int = 8,
    prefetch: int = 2,
    chunk_steps: int = _sa.CHUNK_STEPS,
    device=None,
):
    """The grouped SA experiment driver: ``n_stat`` repetitions on fresh
    RRG(n, d) instances, ``group_size`` at a time as one batched program,
    with the next graphs built on a background thread (``prefetch`` items
    ahead; 0 builds in line). Element for element equal to the serial
    :func:`graphdyn_torch.models.sa.sa_ensemble`."""
    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.pipeline.groups import group_ranges
    from graphdyn_torch.pipeline.prefetch import HostPrefetcher

    if checkpoint_path is not None:
        raise _sa._not_ported("checkpoint_path",
                              "A16: checkpoints and resilience")
    dev = resolve_device(device)
    config = config or SAConfig()
    mag = np.empty(n_stat, np.float64)
    steps = np.empty(n_stat, np.int64)
    conf = np.empty((n_stat, n), np.int8)
    graphs = np.empty((n_stat, n, d), np.int32)
    m_final = np.empty(n_stat, np.float64)

    def build(k):
        g = random_regular_graph(n, d, seed=seed + k, method=graph_method)
        prep = _sa.prepare_sa_inputs(g, config, n_replicas=1, seed=seed + k,
                                     max_steps=max_steps)
        return g, prep

    with HostPrefetcher(build, range(n_stat), depth=prefetch) as pf:
        for ks in group_ranges(0, n_stat, group_size):
            items = [pf.get(i) for i in ks]
            res = run_sa_group(
                [it[0] for it in items], [it[1] for it in items],
                [seed + i for i in ks], config, group_size=group_size,
                chunk_steps=chunk_steps, device=dev)
            for j, i in enumerate(ks):
                conf[i] = res.s[j]
                # exact f64 sum, then the serial result's f32 cast
                mag[i] = np.float32(res.s[j].astype(np.float64).sum() / n)
                steps[i] = res.num_steps[j]
                m_final[i] = res.m_final[j]
                graphs[i] = items[j][0].nbr
    out = _sa.SAEnsembleResult(mag, steps, conf, graphs, m_final)
    if save_path:
        _sa.save_ensemble_npz(save_path, out)
    return out
