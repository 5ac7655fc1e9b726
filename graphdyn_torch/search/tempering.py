"""Replica-exchange (parallel tempering) for the SA initialization search
(the port of ``graphdyn/search/tempering.py``).

K lanes anneal scaled Hamiltonians side by side on the batched replica
axis: lane k's chain is the serial SA chain
(:func:`graphdyn_torch.models.sa._full_step`, the same draw and Metropolis
arithmetic) with its end-state drive ``b`` and cap scaled by ``β_k``. Every
``swap_interval`` steps a chunk ends with the seeded even/odd swap move:
round parity alternates the pairing, acceptance ``u < exp(−Δ)`` with ``Δ =
[(a_i−a_j)(S0_j−S0_i) − (b_i−b_j)(Se_j−Se_i)]/n``; configurations (``s``,
``Σs_end``) migrate while each lane keeps its ``a``, ``b``, stream and step
counter. Inactive lanes never swap, and swaps happen only at full chunks.

Randomness: lane k's steps draw the SA counter stream keyed by ``seed + k``
(so with swaps off the ladder is :func:`~graphdyn_torch.models.sa.
simulated_annealing` with ``n_replicas=K`` on the same ``a0``/``b0`` and
caps), or read injected ``proposals``/``uniforms``; round r's swap uniform
for lane k is Threefry-2x32 block ``(r, k)`` under key ``(seed,
SWAP_STREAM_TAG)``. The reference draws both from ``jax.random``, so in
counter-stream mode only statistics compare with it.

The port's state also counts attempts and accepts per lane pair
(``pair_attempts``/``pair_accepts``), which the reference sums.

``checkpoint_path`` snapshots the ladder at swap boundaries through
:class:`graphdyn_torch.utils.io.ChainCheckpointer` and resumes it bit for
bit; without it a graceful shutdown (SIGTERM, ``--deadline``) exits 75 at
the next chunk with nothing to save (the ladder re-derives from the seed).
Not ported yet: ``mesh=`` lane sharding (ROADMAP A15b); it raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.config import SAConfig
from graphdyn_torch.models import sa as _sa
from graphdyn_torch.ops.dynamics import rule_coefficients
from graphdyn_torch.ops.fused import _bits_to_uniform, threefry2x32
from graphdyn_torch.ops.lightcone import _neighbor_index
from graphdyn_torch.utils.platform import resolve_device

#: key word 1 of the swap stream (key word 0 is the run seed); the
#: reference folds b"SWAP" into its swap key
SWAP_STREAM_TAG = 0x53574150  # b"SWAP"
#: longest fixed-budget chunk plan a drive loop dispatches without reading
#: the lanes' liveness back (the reference's bound)
MAX_FIXED_PLAN_CHUNKS = 4096


class TemperResult(NamedTuple):
    """Per-lane results + ladder statistics."""

    s: np.ndarray                  # int8[K, n] configuration at stop
    mag_reached: np.ndarray        # f32[K] m(s(0)) at stop
    num_steps: np.ndarray          # int[K] MCMC steps per lane
    m_final: np.ndarray            # f32[K] (2.0 timeout sentinel)
    t_target: np.ndarray           # int[K] first-passage step, −1
    betas: np.ndarray              # f64[K] the ladder
    swap_attempts: int
    swap_accepts: int
    swap_acceptance_rate: float    # accepts/attempts (0.0 when 0 attempts)
    steps_to_target: int           # min positive first passage, −1 if none
    target_lane: int               # lane that got there first, −1 if none
    pair_attempts: np.ndarray      # int64[K−1] attempts of pair (k, k+1)
    pair_accepts: np.ndarray       # int64[K−1] accepts of pair (k, k+1)


class _TemperState(NamedTuple):
    s: torch.Tensor          # int8[K, n]
    sum_end: torch.Tensor    # int32[K]
    a: torch.Tensor          # f[K]
    b: torch.Tensor          # f[K]
    t: torch.Tensor          # int[K]
    m_final: torch.Tensor    # f[K]
    active: torch.Tensor     # bool[K]
    key: torch.Tensor        # int64[K] — each lane's stream seed
    t_target: torch.Tensor   # int[K] first step with Σs_end ≥ target, −1
    chunk_t: torch.Tensor    # int32[]
    swap_round: torch.Tensor  # int32[]
    swap_att: torch.Tensor   # int32[] cumulative attempted pair swaps
    swap_acc: torch.Tensor   # int32[] cumulative accepted pair swaps
    pair_att: torch.Tensor   # int32[K−1] attempts per lane pair (k, k+1)
    pair_acc: torch.Tensor   # int32[K−1] accepts per lane pair


def ladder_betas(n_lanes: int, beta_min: float = 1.0,
                 beta_max: float = 64.0) -> np.ndarray:
    """The default geometric drive ladder, reference → greedy: lane k
    scales ``b0`` and ``b_cap`` by ``β_k`` (``a`` keeps the reference
    schedule). ``n_lanes == 1`` returns the reference's β = 1."""
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    if n_lanes == 1:
        return np.ones(1)
    return np.geomspace(beta_min, beta_max, n_lanes)


def swap_uniforms(seed: int, swap_round: torch.Tensor, K: int,
                  dt) -> torch.Tensor:
    """Round ``swap_round``'s swap uniforms, one per lane: word 1 of
    Threefry block ``(round, lane)`` under key ``(seed, SWAP_STREAM_TAG)``."""
    lane = torch.arange(K, dtype=torch.int64, device=swap_round.device)
    _, x1 = threefry2x32(int(seed) & 0xFFFFFFFF, SWAP_STREAM_TAG,
                         swap_round.to(torch.int64) & 0xFFFFFFFF, lane)
    return _bits_to_uniform(x1).to(dt)


def _temper_chunk(idx, state: _TemperState, consts: dict, swap_seed: int,
                  proposals, uniforms, *, rollout_steps: int, R_coef: int,
                  C_coef: int, max_steps: int, swap_interval: int,
                  swap_moves: bool = True, target_sum: int,
                  stop_on_first: bool = False, injected: bool = False,
                  stream_len: int = 1) -> _TemperState:
    """One ladder chunk with no host read: ``swap_interval`` loop steps of
    every active lane (a step runs only while a lane is active and, with
    ``stop_on_first``, none has reached the target, as the reference's loop
    condition; a step that does not run changes nothing), then the swap
    move if the chunk ran all its steps."""
    K, n = state.s.shape
    dt = state.a.dtype
    i_all, u_all = _sa.draw_sa_proposal(
        state.key, state.t, proposals, uniforms, injected=injected,
        stream_len=stream_len, n=n, dt=dt, steps=swap_interval)
    i_all, u_all = i_all.T.contiguous(), u_all.T.contiguous()
    s_ext = torch.cat([state.s, state.s.new_zeros(K, 1)], dim=1)
    sum_end, a, b, t = state.sum_end, state.a, state.b, state.t
    m_final, active, t_target = state.m_final, state.active, state.t_target
    chunk_t = state.chunk_t
    for j in range(swap_interval):
        go = active.any()
        if stop_on_first:
            go = go & ~(t_target >= 0).any()
        live = active & go
        s_ext, sum_end, a, b, t_new, m_final, active_new = _sa._full_step(
            s_ext, sum_end, a, b, t, m_final, live, i_all[j], u_all[j], idx,
            consts, rollout_steps=rollout_steps, R_coef=R_coef,
            C_coef=C_coef, max_steps=max_steps, n=n)
        hit = live & (t_target < 0) & (sum_end >= target_sum)
        t_target = torch.where(hit, t_new, t_target)
        t = t_new
        active = torch.where(go, active_new, active)
        chunk_t = chunk_t + go.to(torch.int32)
    s = s_ext[:, :n]
    st = state._replace(s=s.contiguous(), sum_end=sum_end, a=a, b=b, t=t,
                        m_final=m_final, active=active, t_target=t_target,
                        chunk_t=chunk_t)
    if not swap_moves:
        return st._replace(swap_round=st.swap_round + 1)

    full_chunk = st.chunk_t == swap_interval
    parity = st.swap_round % 2
    idx_k = torch.arange(K, device=s.device)
    low = (idx_k - parity) % 2 == 0           # lower member of its pair
    partner = torch.where(low, idx_k + 1, idx_k - 1)
    valid = (partner >= 0) & (partner < K)
    pidx = partner.clamp(0, K - 1)
    eligible = valid & st.active & st.active[pidx] & full_chunk
    s0_sum = st.s.sum(dim=1, dtype=torch.int32)
    inv_n = consts["inv_n"]
    # symmetric under i <-> j: both members of a pair take one decision
    delta = ((st.a - st.a[pidx]) * (s0_sum[pidx] - s0_sum).to(dt)
             - (st.b - st.b[pidx]) * (st.sum_end[pidx] - st.sum_end).to(dt)
             ) * inv_n
    u = swap_uniforms(swap_seed, st.swap_round, K, dt)
    u_pair = u[torch.minimum(idx_k, pidx)]    # one draw per pair
    accept = eligible & (u_pair < _sa._accept_prob(delta))
    perm = torch.where(accept, pidx, idx_k)
    s_sw = st.s[perm]
    sum_end_sw = st.sum_end[perm]
    m_final = torch.where(accept, sum_end_sw.to(dt) * inv_n, st.m_final)
    hit = st.active & (st.t_target < 0) & (sum_end_sw >= target_sum)
    t_target = torch.where(hit, st.t, st.t_target)
    lower = low & valid                        # pair (k, k+1) counted at k
    return st._replace(
        s=s_sw, sum_end=sum_end_sw, m_final=m_final, t_target=t_target,
        swap_round=st.swap_round + 1,
        swap_att=st.swap_att + eligible.sum(dtype=torch.int32) // 2,
        swap_acc=st.swap_acc + accept.sum(dtype=torch.int32) // 2,
        pair_att=st.pair_att + (eligible & lower)[:K - 1].to(torch.int32),
        pair_acc=st.pair_acc + (accept & lower)[:K - 1].to(torch.int32),
    )


def _assemble_ladder(graph, config: SAConfig, betas, seed: int, max_steps,
                     dtype, device, proposals=None, uniforms=None):
    """The ladder's tables, initial state and constants: per-lane ``a0 =
    a0_frac·n``, ``b0 = β·b0_frac·n`` and caps ``a_cap_frac·n``,
    ``β·b_cap_frac·n``; ``s0`` and streams as
    :func:`~graphdyn_torch.models.sa.prepare_sa_inputs` gives them."""
    n = graph.n
    K = len(betas)
    dyn = config.dynamics
    R_coef, C_coef = rule_coefficients(dyn.rule, dyn.tie)
    rollout = dyn.p + dyn.c - 1
    dt = _sa.resolve_dtype(dtype)
    np_dt = np.float32 if dt == torch.float32 else np.float64
    a0 = np.ones_like(betas) * config.a0_frac * n
    b0 = betas * config.b0_frac * n
    (_, seed, s0, a0b, b0b, proposals, uniforms, max_steps, stream_len,
     injected) = _sa.prepare_sa_inputs(
        graph, config, n_replicas=K, seed=seed, a0=a0, b0=b0,
        proposals=proposals, uniforms=uniforms, max_steps=max_steps,
        dtype=dt)
    nbr = torch.from_numpy(np.asarray(graph.nbr, np.int32)).to(device)
    idx = _neighbor_index(nbr, n)
    st = _sa._sa_init(
        idx, torch.from_numpy(s0).to(device), _sa.chain_keys(seed, K, device),
        torch.from_numpy(a0b.astype(np_dt)).to(device),
        torch.from_numpy(b0b.astype(np_dt)).to(device),
        rollout_steps=rollout, R_coef=R_coef, C_coef=C_coef)

    def zero(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    state = _TemperState(
        s=st.s, sum_end=st.sum_end, a=st.a, b=st.b, t=st.t,
        m_final=st.m_final, active=st.active, key=st.key,
        t_target=torch.full_like(st.t, -1), chunk_t=zero(),
        swap_round=zero(), swap_att=zero(), swap_acc=zero(),
        pair_att=zero(max(K - 1, 0)), pair_acc=zero(max(K - 1, 0)),
    )
    consts = _sa.sa_consts(config, n, dt, device,
                           a_cap=np.ones_like(betas) * config.a_cap_frac * n,
                           b_cap=betas * config.b_cap_frac * n)
    streams = dict(
        proposals=torch.from_numpy(np.array(proposals)).to(device),
        uniforms=torch.from_numpy(uniforms.astype(np_dt)).to(device),
        injected=injected, stream_len=stream_len)
    static = dict(rollout_steps=rollout, R_coef=R_coef, C_coef=C_coef,
                  max_steps=int(max_steps))
    return idx, state, consts, streams, static, np_dt


def temper_search(
    graph,
    config: SAConfig | None = None,
    *,
    n_lanes: int = 8,
    betas=None,
    beta_min: float = 1.0,
    beta_max: float = 64.0,
    seed: int = 0,
    max_steps: int | None = None,
    swap_interval: int = 1000,
    swap_moves: bool = True,
    m_target: float = 1.0,
    stop_on_first: bool = False,
    sync_stop: bool | None = None,
    dtype="float32",
    checkpoint_path: str | None = None,
    checkpoint_interval_s: float = 30.0,
    mesh=None,
    proposals=None,
    uniforms=None,
    device=None,
) -> TemperResult:
    """Run a K-lane replica-exchange annealing ladder on one graph on
    ``device`` (default CUDA).

    ``betas`` (default :func:`ladder_betas`) is the drive ladder.
    ``swap_interval`` is part of the chain law (swaps every
    ``swap_interval`` steps) and the chunk length: one host read per chunk.
    ``m_target`` defines the first-passage record ``t_target``;
    ``stop_on_first`` ends the run at the first passage. ``sync_stop``
    (default: only where it is needed) reads the lanes' liveness once per
    chunk; a fixed-budget run without it dispatches the whole plan of
    ``ceil((max_steps+1)/swap_interval)`` chunks with no read between them,
    the chunks after every lane stops doing nothing. ``proposals``/
    ``uniforms`` ``[K, L]`` inject the lanes' step streams.
    ``checkpoint_path`` snapshots the ladder between chunks (module
    docstring); it needs the per-chunk read, so ``sync_stop=False`` is
    refused with it."""
    from graphdyn_torch.resilience.shutdown import raise_if_requested

    if checkpoint_path is not None and sync_stop is False:
        raise ValueError(
            "sync_stop=False is incompatible with checkpoint_path: snapshot "
            "scheduling polls lane liveness at every chunk boundary")
    if mesh is not None:
        raise _sa._not_ported("mesh= (lane sharding)",
                              "A15b: the ensemble meshes")
    dev = resolve_device(device)
    config = config or SAConfig()
    n = graph.n
    if betas is None:
        betas = ladder_betas(n_lanes, beta_min, beta_max)
    betas = np.asarray(betas, dtype=np.float64)
    K = betas.size
    if not (0.0 < m_target <= 1.0):
        raise ValueError(f"m_target must be in (0, 1], got {m_target}")
    if swap_interval < 1:
        raise ValueError(f"swap_interval must be >= 1, got {swap_interval}")
    target_sum = int(np.ceil(m_target * n))
    idx, state, consts, streams, static, np_dt = _assemble_ladder(
        graph, config, betas, seed, max_steps, dtype, dev,
        proposals=proposals, uniforms=uniforms)
    # a lane whose initial configuration already rolls out past the target
    # records first passage at step 0
    state = state._replace(t_target=torch.where(
        state.sum_end >= target_sum, 0, state.t_target).to(state.t.dtype))
    chunk_kwargs = dict(swap_interval=int(swap_interval),
                        swap_moves=bool(swap_moves), target_sum=target_sum,
                        stop_on_first=bool(stop_on_first),
                        injected=streams["injected"],
                        stream_len=streams["stream_len"], **static)

    def chunk(st: _TemperState) -> _TemperState:
        return _temper_chunk(
            idx, st._replace(chunk_t=torch.zeros_like(st.chunk_t)), consts,
            seed, streams["proposals"], streams["uniforms"], **chunk_kwargs)

    advance = _sa.chunk_caller(chunk)

    def running(st: _TemperState) -> bool:
        _sa.HOST_READS += 1
        go = bool(st.active.any())
        if stop_on_first:
            go = go and not bool((st.t_target >= 0).any())
        return go

    if checkpoint_path is not None:
        from graphdyn_torch.utils.io import ChainCheckpointer, run_fingerprint

        ckpt = ChainCheckpointer(
            checkpoint_path, kind="temper_ladder", seed=seed,
            # the ladder, the swap law and the target are part of the
            # chain; the port's tag refuses the JAX package's snapshots
            fp=run_fingerprint(
                graph.edges, config, betas, int(static["max_steps"]),
                int(swap_interval), bool(swap_moves), target_sum,
                bool(stop_on_first), np_dt, "graphdyn_torch counter stream",
                *((np.asarray(streams["proposals"].cpu()),
                   np.asarray(streams["uniforms"].cpu()))
                  if streams["injected"] else ())),
            interval_s=checkpoint_interval_s, extra_meta={"K": int(K)})
        arrays = ckpt.load_state(check=lambda a: a["s"].shape == (K, n))
        if arrays is not None:
            state = _TemperState(**{
                f: (torch.zeros((), dtype=torch.int32, device=dev)
                    if f == "chunk_t" else
                    torch.from_numpy(np.asarray(arrays[f])).to(dev))
                for f in _TemperState._fields})

        def payload(st):
            return {k: v.cpu().numpy() for k, v in st._asdict().items()
                    if k != "chunk_t"}

        state = ckpt.drive(state, advance=advance, active=running,
                           payload=payload)
        return _temper_result(state, betas, n, np_dt)

    n_chunks = -(-(int(static["max_steps"]) + 1) // int(swap_interval))
    if sync_stop is None:
        sync = bool(stop_on_first) or n_chunks > MAX_FIXED_PLAN_CHUNKS
    else:
        sync = bool(sync_stop)
        if not sync and stop_on_first:
            raise ValueError(
                "sync_stop=False is incompatible with stop_on_first: early "
                "exit IS the per-chunk stop test")
        if not sync and n_chunks > MAX_FIXED_PLAN_CHUNKS:
            raise ValueError(
                f"sync_stop=False needs a plannable budget: max_steps="
                f"{static['max_steps']} / swap_interval={swap_interval} is "
                f"{n_chunks} chunks (> {MAX_FIXED_PLAN_CHUNKS}) — lower "
                f"max_steps or raise swap_interval")
    # each chunk ends at a heartbeat and honours a graceful shutdown (exit
    # 75; nothing to save: the ladder re-derives from the seed)
    if sync:
        while running(state):
            state = advance(state)
            raise_if_requested(where="chunk")
    else:
        for _ in range(n_chunks):
            state = advance(state)
            raise_if_requested(where="chunk")
    return _temper_result(state, betas, n, np_dt)


def _temper_result(state: _TemperState, betas, n: int, np_dt) -> TemperResult:
    t_target = state.t_target.cpu().numpy()
    reached = t_target >= 0
    if reached.any():
        target_lane = int(np.argmin(np.where(
            reached, t_target, np.iinfo(t_target.dtype).max)))
        steps_to_target = int(t_target[target_lane])
    else:
        target_lane, steps_to_target = -1, -1
    att, acc = int(state.swap_att), int(state.swap_acc)
    s_final = state.s.cpu().numpy()
    return TemperResult(
        s=s_final,
        mag_reached=(s_final.astype(np.float64).sum(axis=1) / n).astype(np_dt),
        num_steps=state.t.cpu().numpy(),
        m_final=state.m_final.cpu().numpy(),
        t_target=t_target,
        betas=betas,
        swap_attempts=att,
        swap_accepts=acc,
        swap_acceptance_rate=(acc / att) if att else 0.0,
        steps_to_target=steps_to_target,
        target_lane=target_lane,
        pair_attempts=state.pair_att.cpu().numpy().astype(np.int64),
        pair_accepts=state.pair_acc.cpu().numpy().astype(np.int64),
    )
