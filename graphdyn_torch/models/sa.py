"""Simulated-annealing search for strategic initializations (the port of
``graphdyn/models/sa.py``).

The reference chain (`SA_RRG.py:58-88`): Metropolis over single-spin flips
of the *initial* configuration, energy ``E = (a·Σs(0) − b·Σs(end))/n``,
per-step annealing ``a ← par_a·a`` capped at ``a_cap`` (cap checked before
the multiply), stop when the rolled-out end state is all +1, timeout after
``max_steps`` with the sentinel ``m_final = 2``. The end-state sum of the
current configuration is carried, so a step costs one rollout (of the
flipped candidate), or one ball roll in light-cone mode
(:mod:`graphdyn_torch.ops.lightcone`).

On the card the JAX package runs the whole chain as one ``lax.while_loop``.
The port advances it in chunks of ``chunk_steps`` masked steps with no host
read inside a chunk: a finished chain is frozen by ``active`` (``t``, ``a``,
``b``, ``m_final``, the spins and the trajectory stay put), so the steps a
chunk runs past a chain's end change nothing, and the chunk length cannot
change the chain. One host read of ``active.any()`` per chunk decides
whether to go on (:data:`HOST_READS` counts them).

Randomness, two modes:

- **injected streams**, ``proposals``/``uniforms`` ``[R, L]``: step ``t``
  reads column ``min(t, L−1)``. The same streams into both packages give
  the same chain (the parity lever of ``tests/test_sa.py``).
- **counter stream** otherwise: step ``t`` of the chain keyed by ``seed_r``
  (``seed + r`` for replica r, as the reference keys its replicas) draws
  one Threefry-2x32 block, key ``(seed_r, SA_STREAM_TAG)``, counter ``(t,
  0)``: word 0 gives the site ``(x0·n) >> 32``, word 1 the uniform (its
  top 24 bits). A chain's draws depend only on its seed and step, so a
  grouped run equals the serial runs and the card equals the CPU. The
  reference's ``jax.random`` key tree is not reproduced: in this mode only
  statistics compare with the JAX package.

The float step: ``ΔH`` in the chain's dtype in the reference's compiled
order, ``((a·−2)·s_i + b·(Σ − Σ'))·(1/n)`` with ``1/n`` the dtype's
reciprocal (XLA rewrites each division by the constant n into that
multiplication: ΔH, ``m0`` and ``m_new``), then ``u < exp(−ΔH)``. In f32
the exponential is the correctly rounded one (computed in f64 and rounded),
so the CPU and the card take the same decisions; XLA's f32 ``exp`` may
differ from it in the last bit, so a chain held against the JAX package may
part only where ``u`` is within an ulp or two of ``exp(−ΔH)`` (the near-tie
rule of :mod:`graphdyn_torch.search.reference`).

Layouts, as the JAX package routes them: ``layout='auto'`` relabels a
graph whose degree CV crosses the bucketed threshold bucket-major
(``degree_buckets`` order, ``permute_nodes``), runs the padded chain on it
and maps the spins back, as ``layout='bucketed'`` does; ``layout='streamed'``
is the host-stepped chain of :func:`_sa_streamed`, every end sum from the
out-of-core streamed rollout. Not ported yet: ``checkpoint_path`` (A16); it
raises, naming the item.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.config import SAConfig
from graphdyn_torch.ops.dynamics import rule_coefficients
from graphdyn_torch.ops.fused import _bits_to_uniform, _check_seed, threefry2x32
from graphdyn_torch.ops.lightcone import (
    _neighbor_index,
    batched_trajectory,
    lightcone_accept,
    lightcone_flip_delta,
    resolve_lightcone_tables,
    rollout_ext,
)
from graphdyn_torch.utils.platform import resolve_device

#: key word 1 of the SA proposal stream (key word 0 is the chain's seed)
SA_STREAM_TAG = 0x53414E4E  # b"SANN"
#: masked steps per chunk between two host reads
CHUNK_STEPS = 256
#: host reads of a chain's ``active`` flags (one per chunk), for the
#: chip smoke test's count; set to 0 before a run and read after it
HOST_READS = 0
_M32 = 0xFFFFFFFF
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class SAResult(NamedTuple):
    """Per-replica results, the reference's arrays (`SA_RRG.py:53-56`)."""

    s: np.ndarray            # int8[R, n] — configuration at stop
    mag_reached: np.ndarray  # f[R] — m(s(0)) at stop (`SA_RRG.py:86`)
    num_steps: np.ndarray    # int[R] — MCMC steps taken (`:87`)
    m_final: np.ndarray      # f[R] — 1.0 on success, 2.0 sentinel on timeout


class _SAState(NamedTuple):
    s: torch.Tensor         # int8[R, n] (stale in light-cone mode: traj[:, 0])
    sum_end: torch.Tensor   # int32[R]
    a: torch.Tensor         # f[R]
    b: torch.Tensor         # f[R]
    t: torch.Tensor         # int32[R] (int64 in float64 chains)
    m_final: torch.Tensor   # f[R]
    active: torch.Tensor    # bool[R]
    key: torch.Tensor       # int64[R] — each chain's stream seed
    chunk_t: torch.Tensor   # int32[] — loop steps with a chain active, this chunk
    traj: torch.Tensor      # int8[R, T+1, n+2] light-cone trajectory; [R, 0, 0] in full mode


def _not_ported(arg: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{arg} is not ported to graphdyn_torch yet (ROADMAP.md {item})")


def resolve_dtype(dtype) -> torch.dtype:
    """``'float32'``/``'float64'`` (or the torch dtype) -> the torch dtype."""
    if isinstance(dtype, torch.dtype) and dtype in _DTYPES.values():
        return dtype
    if dtype in _DTYPES:
        return _DTYPES[dtype]
    raise ValueError(f"dtype must be 'float32' or 'float64', got {dtype!r}")


def _recip(n: int, dt: torch.dtype, device) -> torch.Tensor:
    """``1/n`` rounded to ``dt`` (the constant XLA multiplies by)."""
    return (torch.ones((), dtype=dt) / n).to(device)


def _accept_prob(delta_h: torch.Tensor) -> torch.Tensor:
    """``exp(−ΔH)`` in ΔH's dtype; in f32 the correctly rounded value."""
    if delta_h.dtype == torch.float32:
        return torch.exp(-delta_h.double()).float()
    return torch.exp(-delta_h)


def draw_sa_proposal(key, t, proposals, uniforms, *, injected: bool,
                     stream_len: int, n: int, dt, steps: int = 1):
    """Proposals ``(i int64[R, steps], u dt[R, steps])`` for the next
    ``steps`` steps of each chain from its step counter ``t``: injected
    streams read column ``min(t + j, L − 1)``; the counter stream draws
    block ``(t + j, 0)`` under key ``(key_r, SA_STREAM_TAG)``. A chain that
    stops inside the window ignores the rest of its draws."""
    tt = t.to(torch.int64)[:, None] + torch.arange(steps, device=t.device)
    if injected:
        tt = tt.clamp(max=stream_len - 1)
        i = torch.gather(proposals, 1, tt).to(torch.int64)
        u = torch.gather(uniforms, 1, tt).to(dt)
        return i, u
    x0, x1 = threefry2x32(key[:, None], SA_STREAM_TAG, tt & _M32, 0)
    return (x0 * n) >> 32, _bits_to_uniform(x1).to(dt)


def metropolis_anneal_update(
    active, a, b, t, m_final, sum_end, sum_end_flip, s_i, u,
    *, par_a, par_b, a_cap, b_cap, max_steps, n, inv_n=None,
):
    """The per-replica Metropolis accept + anneal + sentinel arithmetic
    (`SA_RRG.py:32-37,74-85`) in the reference's order of operations.
    ``par_*``/``*_cap`` are tensors of the chain's dtype (scalars, or one
    per replica); ``inv_n`` is ``1/n`` in that dtype on the chain's device
    (made here when not given: pass it in a loop, so that no step copies a
    constant to the card). Returns ``(do, sum_end_new, a_new, b_new, t_new,
    m_final_new, active_new)``; ``do`` masks the accepted flips."""
    dt = a.dtype
    if inv_n is None:
        inv_n = _recip(n, dt, a.device)
    delta_h = ((a * -2.0) * s_i.to(dt)
               + b * (sum_end - sum_end_flip).to(dt)) * inv_n
    do = active & (u < _accept_prob(delta_h))
    sum_end_new = torch.where(do, sum_end_flip, sum_end)
    a_new = torch.where(active & (a < a_cap), a * par_a, a)
    b_new = torch.where(active & (b < b_cap), b * par_b, b)
    t_new = torch.where(active, t + 1, t)
    timeout = t_new > max_steps
    m_new = torch.where(timeout, torch.full_like(a, 2.0),
                        sum_end_new.to(dt) * inv_n)
    m_final_new = torch.where(active, m_new, m_final)
    active_new = active & (m_final_new < 1.0) & ~timeout
    return do, sum_end_new, a_new, b_new, t_new, m_final_new, active_new


def _end_sum(s: torch.Tensor, idx: torch.Tensor, steps: int, R_coef: int,
             C_coef: int) -> torch.Tensor:
    """int32 ``Σ_i s_end_i`` per row of ``s: int8[R, n]``."""
    s_ext = torch.cat([s, s.new_zeros(s.shape[0], 1)], dim=1)
    return rollout_ext(s_ext, idx, steps, R_coef, C_coef).sum(
        dim=1, dtype=torch.int32)


def _full_step(s_ext, sum_end, a, b, t, m_final, active, i, u, idx, consts,
               *, rollout_steps: int, R_coef: int, C_coef: int,
               max_steps: int, n: int):
    """One full-rollout chain step on the ghost-extended spins ``int8[R,
    n+1]``: flip each replica's site ``i``, roll the candidate, accept or
    reject. Returns the updated ``(s_ext, sum_end, a, b, t, m_final,
    active)``."""
    s_i = torch.gather(s_ext, 1, i[:, None])[:, 0].to(torch.int32)
    s_flip = s_ext.scatter(1, i[:, None], (-s_i).to(torch.int8)[:, None])
    sum_end_flip = rollout_ext(s_flip, idx, rollout_steps, R_coef,
                               C_coef).sum(dim=1, dtype=torch.int32)
    do, sum_end, a, b, t, m_final, active = metropolis_anneal_update(
        active, a, b, t, m_final, sum_end, sum_end_flip, s_i, u,
        max_steps=max_steps, n=n, **consts)
    return (torch.where(do[:, None], s_flip, s_ext), sum_end, a, b, t,
            m_final, active)


def _sa_init(idx, s0, key0, a0, b0, *, rollout_steps: int, R_coef: int,
             C_coef: int, lightcone: bool = False, nbr=None) -> _SAState:
    """The chain's initial state: the end sum of ``s0`` (and, in light-cone
    mode, its trajectory from ``nbr``), ``m0 = Σ·(1/n)``, ``active = m0 <
    1``, ``t = 0``."""
    R, n = s0.shape
    dt = a0.dtype
    if lightcone:
        traj = batched_trajectory(nbr, s0, rollout_steps, R_coef, C_coef)
        sum_end0 = traj[:, rollout_steps, :n].sum(dim=1, dtype=torch.int32)
    else:
        traj = s0.new_zeros((R, 0, 0))
        sum_end0 = _end_sum(s0, idx, rollout_steps, R_coef, C_coef)
    m0 = sum_end0.to(dt) * _recip(n, dt, s0.device)
    t_dtype = torch.int64 if dt == torch.float64 else torch.int32
    return _SAState(
        s=s0, sum_end=sum_end0, a=a0, b=b0,
        t=torch.zeros(R, dtype=t_dtype, device=s0.device),
        m_final=m0, active=m0 < 1.0, key=key0,
        chunk_t=torch.zeros((), dtype=torch.int32, device=s0.device),
        traj=traj,
    )


def _sa_loop(idx, state: _SAState, consts: dict, proposals, uniforms, *,
             rollout_steps: int, R_coef: int, C_coef: int, max_steps: int,
             injected: bool, stream_len: int, chunk_steps: int,
             lc_tables=None) -> _SAState:
    """Advance every chain ``chunk_steps`` masked steps with no host read
    (the reference's ``_sa_loop`` with ``chunk_steps``: steps after a chain
    stops are no-ops, so re-entering with the returned state continues the
    chain bit for bit). ``consts`` holds ``par_a``, ``par_b``, ``a_cap``,
    ``b_cap`` as tensors of the chain's dtype. With ``lc_tables`` the
    candidates roll only their light cone against ``state.traj``; the
    carried ``s`` then stays the initial placeholder and the current spins
    are ``traj[:, 0, :n]``."""
    R, n = state.s.shape
    dt = state.a.dtype
    i_all, u_all = draw_sa_proposal(
        state.key, state.t, proposals, uniforms, injected=injected,
        stream_len=stream_len, n=n, dt=dt, steps=chunk_steps)
    i_all, u_all = i_all.T.contiguous(), u_all.T.contiguous()
    sum_end, a, b, t = state.sum_end, state.a, state.b, state.t
    m_final, active, chunk_t = state.m_final, state.active, state.chunk_t
    kw = dict(max_steps=max_steps, n=n, **consts)
    if lc_tables is not None:
        traj = state.traj.clone()
        for j in range(chunk_steps):
            i, u = i_all[j], u_all[j]
            chunk_t = chunk_t + active.any()
            s_i = torch.gather(traj[:, 0], 1, i[:, None])[:, 0].to(torch.int32)
            delta, vstack = lightcone_flip_delta(lc_tables, traj, i, R_coef,
                                                 C_coef, rollout_steps)
            do, sum_end, a, b, t, m_final, active = metropolis_anneal_update(
                active, a, b, t, m_final, sum_end, sum_end + delta, s_i, u,
                **kw)
            traj = lightcone_accept(lc_tables, traj, i, vstack, do)
        s = state.s
    else:
        traj = state.traj
        s_ext = torch.cat([state.s, state.s.new_zeros(R, 1)], dim=1)
        for j in range(chunk_steps):
            chunk_t = chunk_t + active.any()
            s_ext, sum_end, a, b, t, m_final, active = _full_step(
                s_ext, sum_end, a, b, t, m_final, active, i_all[j], u_all[j],
                idx, consts, rollout_steps=rollout_steps, R_coef=R_coef,
                C_coef=C_coef, max_steps=max_steps, n=n)
        s = s_ext[:, :n].contiguous()
    return _SAState(s, sum_end, a, b, t, m_final, active, state.key,
                    chunk_t.to(torch.int32), traj)


def prepare_sa_inputs(graph, config: SAConfig, *, n_replicas=None,
                      seed=None, s0=None, a0=None, b0=None, proposals=None,
                      uniforms=None, max_steps=None, dtype="float32"):
    """Host preparation of the solver's inputs, as the reference's: the
    default ``s0`` drawn from ``np.random.default_rng(seed)``, the replica
    broadcast of ``(a0, b0)``, the step budget (default 2n³, clamped to
    2³¹ − 2 for an int32 step counter, i.e. unless the chain is float64,
    which the reference runs with x64 on) and the injected streams' shapes.

    Returns ``(R, seed, s0, a0, b0, proposals, uniforms, max_steps,
    stream_len, injected)``."""
    n = graph.n
    if seed is None:
        seed = config.seed
    if n_replicas is None:
        n_replicas = config.n_replicas if s0 is None else np.shape(s0)[0]
    R = n_replicas

    rng = np.random.default_rng(seed)
    if s0 is None:
        s0 = (2 * rng.integers(0, 2, size=(R, n)) - 1).astype(np.int8)
    s0 = np.asarray(s0, dtype=np.int8).reshape(R, n)
    a0 = np.broadcast_to(np.asarray(
        config.a0_frac * n if a0 is None else a0, dtype=np.float64), (R,))
    b0 = np.broadcast_to(np.asarray(
        config.b0_frac * n if b0 is None else b0, dtype=np.float64), (R,))
    if max_steps is None:
        max_steps = config.max_steps if config.max_steps is not None else 2 * n**3
    if resolve_dtype(dtype) != torch.float64:
        max_steps = min(int(max_steps), 2**31 - 2)
    max_steps = int(max_steps)

    injected = proposals is not None
    if injected:
        proposals = np.asarray(proposals, dtype=np.int32).reshape(R, -1)
        uniforms = np.asarray(uniforms, dtype=np.float64).reshape(R, -1)
        stream_len = proposals.shape[1]
        max_steps = min(max_steps, stream_len)
    else:
        stream_len = 1
        proposals = np.zeros((R, 1), np.int32)
        uniforms = np.zeros((R, 1), np.float64)
    return R, seed, s0, a0, b0, proposals, uniforms, max_steps, stream_len, injected


def chain_keys(seed: int, R: int, device) -> torch.Tensor:
    """Each replica's stream seed, ``(seed + r) mod 2³²`` (the reference
    keys replica r by ``PRNGKey(uint32(seed) + r)``)."""
    seed = _check_seed(int(seed) & _M32)
    return (seed + torch.arange(R, dtype=torch.int64, device=device)) & _M32


def sa_consts(config: SAConfig, n: int, dt: torch.dtype, device, *,
              a_cap=None, b_cap=None) -> dict:
    """The step's constants as tensors of the chain's dtype on ``device``,
    copied there once: ``par_a``, ``par_b``, the caps (scalars, or one per
    replica) and ``inv_n``."""
    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dt,
                               device=device)

    return dict(
        par_a=f(config.par_a), par_b=f(config.par_b),
        a_cap=f(config.a_cap_frac * n if a_cap is None else a_cap),
        b_cap=f(config.b_cap_frac * n if b_cap is None else b_cap),
        inv_n=_recip(n, dt, device),
    )


def graphed(advance, state):
    """``advance`` (a chunk: a function of a NamedTuple of tensors that
    returns one of the same layout) with its calls after the first replayed
    from a CUDA graph. The first call runs ``advance`` as it is (and warms
    it up); one chunk is then captured, reading static copies of the state.
    A later call copies its state in, replays the graph and returns copies
    of the outputs. The graph wraps the chunk's PyTorch ops and replaces
    none of them: a replay issues the same kernels on the same data, so the
    chain is the eager chain. Returns ``(replay, first chunk's state)``."""
    out = advance(state)
    static_in = type(state)(*(t.clone() for t in out))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = advance(static_in)

    def replay(st):
        for dst, src in zip(static_in, st):
            dst.copy_(src)
        graph.replay()
        return type(st)(*(t.clone() for t in static_out))

    return replay, out


def chunk_caller(advance):
    """``advance`` as the drivers call it: when the state lies on the card,
    the first call captures the chunk (:func:`graphed`) and the later calls
    replay it; on the CPU each call runs ``advance``."""
    replay = None

    def call(st):
        nonlocal replay
        if replay is None:
            if not st.active.is_cuda:
                return advance(st)
            replay, out = graphed(advance, st)
            return out
        return replay(st)

    return call


def run_chunks(advance, state, *, on_chunk=None):
    """Call ``advance`` until no chain is active, with one host read of
    ``active.any()`` per chunk (counted in :data:`HOST_READS`); ``on_chunk``
    is called after each chunk. On the card the chunks after the first
    replay a CUDA graph of one chunk (:func:`chunk_caller`)."""
    global HOST_READS
    advance = chunk_caller(advance)
    while True:
        state = advance(state)
        if on_chunk is not None:
            on_chunk(state)
        HOST_READS += 1
        if not bool(state.active.any()):
            return state


def simulated_annealing(
    graph,
    config: SAConfig | None = None,
    *,
    n_replicas: int | None = None,
    seed: int | None = None,
    s0: np.ndarray | None = None,
    a0=None,
    b0=None,
    proposals: np.ndarray | None = None,
    uniforms: np.ndarray | None = None,
    max_steps: int | None = None,
    dtype="float32",
    checkpoint_path: str | None = None,
    chunk_steps: int = CHUNK_STEPS,
    rollout_mode: str = "full",
    lc_tables=None,
    kernel: str = "auto",
    layout: str = "auto",
    stream_chunks: int = 4,
    device=None,
) -> SAResult:
    """Run R batched SA chains on ``graph`` on ``device`` (default CUDA).

    ``rollout_mode``: ``'full'`` re-rolls the whole graph per candidate;
    ``'lightcone'`` rolls only the flip's ball against a cached trajectory
    (bit-identical chains; pass ``lc_tables`` from
    :func:`~graphdyn_torch.ops.lightcone.build_lightcone_tables` to reuse a
    build). ``a0``/``b0`` may be per-replica (a temperature ladder).
    ``proposals``/``uniforms`` ``[R, L]`` switch to injected-stream mode.
    ``chunk_steps`` is the number of masked steps between host reads; it
    does not change the chain.

    ``kernel``: ``'auto'`` and ``'plain'`` run this chain; ``'cuda'`` (the
    reference's ``'pallas'``) is refused, as the reference refuses it: the
    fused one-kernel annealer is a class-parallel chain, another Markov
    chain, run by :func:`graphdyn_torch.search.fused.fused_anneal`.
    ``layout``: ``'auto'`` runs padded unless the degree CV routes the graph
    to the bucketed layout; ``'bucketed'`` relabels the graph bucket-major,
    runs the padded chain on it and maps ``s`` back (injected streams and
    prebuilt ``lc_tables`` are node-indexed and refused there);
    ``'streamed'`` runs :func:`_sa_streamed` with ``stream_chunks`` chunks
    (injected streams allowed: it keeps the caller's labeling).
    ``checkpoint_path`` (A16) is not ported and raises; an auto-routed
    checkpointed run would pin the padded layout, as the JAX package's
    does, once it is."""
    if kernel not in ("auto", "plain"):
        if kernel in ("cuda", "pallas"):
            raise ValueError(
                f"kernel={kernel!r} on the serial SA solver: the fused "
                "one-kernel annealer is a class-parallel chain, not this "
                "chain — run graphdyn_torch.search.fused.fused_anneal (CLI "
                "`fused`) for the LUT-popcount kernel, or keep "
                "kernel='auto'/'plain' here"
            )
        raise ValueError(
            f"kernel must be 'auto', 'plain' or 'cuda', got {kernel!r}")
    if layout not in ("auto", "padded", "bucketed", "streamed"):
        raise ValueError(
            f"layout must be 'auto', 'padded', 'bucketed' or 'streamed', "
            f"got {layout!r}")
    if checkpoint_path is not None:
        raise _not_ported("checkpoint_path", "A16: checkpoints and resilience")
    if layout == "auto":
        from graphdyn_torch.ops.bucketed import auto_layout

        layout = auto_layout(graph.deg)
    if layout == "bucketed":
        if proposals is not None or uniforms is not None:
            raise ValueError(
                "injected proposals/uniforms are node-indexed: pass "
                "layout='padded' to keep the caller's labeling")
        if lc_tables is not None:
            raise ValueError(
                "prebuilt lightcone tables are node-indexed: pass "
                "layout='padded' to keep the caller's labeling")
        from graphdyn_torch.graphs import degree_buckets, permute_nodes

        order = degree_buckets(graph).order
        g_b, inv = permute_nodes(graph, order)
        res = simulated_annealing(
            g_b, config, n_replicas=n_replicas, seed=seed,
            s0=None if s0 is None else np.asarray(s0)[..., order],
            a0=a0, b0=b0, max_steps=max_steps, dtype=dtype,
            chunk_steps=chunk_steps, rollout_mode=rollout_mode,
            kernel=kernel, layout="padded", device=device)
        return res._replace(s=res.s[..., inv])
    if layout == "streamed":
        if rollout_mode != "full":
            raise ValueError(
                "rollout_mode='lightcone' caches a device-resident "
                "trajectory, which is what the out-of-core streamed layout "
                "exists to avoid — use rollout_mode='full'")
        return _sa_streamed(
            graph, config or SAConfig(), n_replicas=n_replicas, seed=seed,
            s0=s0, a0=a0, b0=b0, proposals=proposals, uniforms=uniforms,
            max_steps=max_steps, dtype=dtype, stream_chunks=stream_chunks,
            device=device)
    if rollout_mode not in ("full", "lightcone"):
        raise ValueError(
            f"rollout_mode must be 'full' or 'lightcone', got {rollout_mode!r}")
    if chunk_steps < 1:
        raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    config = config or SAConfig()
    n = graph.n
    dyn = config.dynamics
    R_coef, C_coef = rule_coefficients(dyn.rule, dyn.tie)
    rollout = dyn.p + dyn.c - 1

    (R, seed, s0, a0, b0, proposals, uniforms, max_steps, stream_len,
     injected) = prepare_sa_inputs(
        graph, config, n_replicas=n_replicas, seed=seed, s0=s0, a0=a0,
        b0=b0, proposals=proposals, uniforms=uniforms, max_steps=max_steps,
        dtype=dt)
    np_dt = np.float32 if dt == torch.float32 else np.float64
    nbr = torch.from_numpy(np.asarray(graph.nbr, np.int32)).to(dev)
    idx = _neighbor_index(nbr, n)
    lightcone = rollout_mode == "lightcone"
    lc_tables = (resolve_lightcone_tables(graph, rollout, lc_tables,
                                          device=dev) if lightcone else None)
    state = _sa_init(
        idx, torch.from_numpy(s0).to(dev), chain_keys(seed, R, dev),
        torch.from_numpy(a0.astype(np_dt)).to(dev),
        torch.from_numpy(b0.astype(np_dt)).to(dev),
        rollout_steps=rollout, R_coef=R_coef, C_coef=C_coef,
        lightcone=lightcone, nbr=nbr)
    consts = sa_consts(config, n, dt, dev)
    prop_d = torch.from_numpy(np.array(proposals)).to(dev)
    unif_d = torch.from_numpy(uniforms.astype(np_dt)).to(dev)

    def advance(st):
        return _sa_loop(
            idx, st._replace(chunk_t=torch.zeros_like(st.chunk_t)), consts,
            prop_d, unif_d, rollout_steps=rollout, R_coef=R_coef,
            C_coef=C_coef, max_steps=max_steps, injected=injected,
            stream_len=stream_len, chunk_steps=int(chunk_steps),
            lc_tables=lc_tables)

    state = run_chunks(advance, state)
    s_final = (state.traj[:, 0, :n] if lightcone else state.s).cpu().numpy()
    mag = s_final.astype(np.float64).sum(axis=1) / n
    return SAResult(
        s=s_final,
        mag_reached=mag.astype(np_dt),
        num_steps=state.t.cpu().numpy(),
        m_final=state.m_final.cpu().numpy(),
    )


def _sa_streamed(graph, config: SAConfig, *, n_replicas, seed, s0, a0, b0,
                 proposals, uniforms, max_steps, dtype, stream_chunks,
                 device) -> SAResult:
    """``layout='streamed'``: the same serial Metropolis chain, each
    candidate's end sum from the out-of-core streamed rollout
    (:func:`graphdyn_torch.ops.streamed.streamed_rollout`, its chunks on
    ``device``) instead of a resident one. The chain is host-stepped, one
    streamed rollout per step, its small state on the host; the proposal
    draw and the Metropolis/anneal arithmetic are the padded chain's own
    (:func:`draw_sa_proposal`, :func:`metropolis_anneal_update`), and the
    integer end sums do not depend on the engine, so the chain equals
    ``layout='padded'`` under the same streams. The node labeling is the
    caller's."""
    from graphdyn_torch.ops.packed import WORD, pack_spins, unpack_spins
    from graphdyn_torch.ops.streamed import build_stream_plan, streamed_rollout

    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    host = torch.device("cpu")
    n = graph.n
    dyn = config.dynamics
    rollout = dyn.p + dyn.c - 1
    (R, seed, s0, a0, b0, proposals, uniforms, max_steps, stream_len,
     injected) = prepare_sa_inputs(
        graph, config, n_replicas=n_replicas, seed=seed, s0=s0, a0=a0,
        b0=b0, proposals=proposals, uniforms=uniforms, max_steps=max_steps,
        dtype=dt)
    np_dt = np.float32 if dt == torch.float32 else np.float64
    plan = build_stream_plan(graph, W=-(-R // WORD), n_chunks=stream_chunks)

    def end_sums(s_batch):
        """Integer Σ_i s_end_i per replica through the streamed engine."""
        out = streamed_rollout(graph, pack_spins(s_batch), rollout,
                               rule=dyn.rule, tie=dyn.tie, plan=plan,
                               device=dev)
        return unpack_spins(out, R).sum(dim=1, dtype=torch.int32)

    s = torch.from_numpy(s0)
    a_v = torch.from_numpy(a0.astype(np_dt))
    b_v = torch.from_numpy(b0.astype(np_dt))
    key = chain_keys(seed, R, host)
    consts = sa_consts(config, n, dt, host)
    sum_end = end_sums(s)
    m_final = sum_end.to(dt) * consts["inv_n"]
    t = torch.zeros(R, dtype=torch.int64 if dt == torch.float64
                    else torch.int32)
    active = m_final < 1.0
    prop = torch.from_numpy(np.array(proposals))
    unif = torch.from_numpy(uniforms.astype(np_dt))
    ridx = torch.arange(R)
    while bool(active.any()):
        i, u = draw_sa_proposal(key, t, prop, unif, injected=injected,
                                stream_len=stream_len, n=n, dt=dt)
        i, u = i[:, 0], u[:, 0]
        s_i = s[ridx, i].to(torch.int32)
        s_flip = s.clone()
        s_flip[ridx, i] = (-s_i).to(torch.int8)
        do, sum_end, a_v, b_v, t, m_final, active = metropolis_anneal_update(
            active, a_v, b_v, t, m_final, sum_end, end_sums(s_flip), s_i, u,
            max_steps=max_steps, n=n, **consts)
        s = torch.where(do[:, None], s_flip, s)
    s_final = s.numpy()
    mag = s_final.astype(np.float64).sum(axis=1) / n
    return SAResult(s=s_final, mag_reached=mag.astype(np_dt),
                    num_steps=t.numpy(), m_final=m_final.numpy())


def energy(graph, s, a: float, b: float, p: int, c: int,
           rule: str = "majority", tie: str = "stay", device=None):
    """The SA objective ``E = (a·Σs(0) − b·Σs(end))/n`` (`SA_RRG.py:28-30`),
    in float64 on the host from the rolled-out end state. A batched ``s``
    ``[R, n]`` returns one energy per replica."""
    from graphdyn_torch.ops.dynamics import end_state

    s = np.asarray(s)
    batched = s.ndim == 2
    s2 = s if batched else s[None]
    s_end = end_state(graph, s2.astype(np.int8), p, c, rule, tie,
                      device=device).cpu().numpy()
    n = s2.shape[-1]
    e = (a * s2.astype(np.float64).sum(axis=-1)
         - b * s_end.astype(np.float64).sum(axis=-1)) / n
    return e if batched else float(e[0])


class SAEnsembleResult(NamedTuple):
    """The reference driver's per-repetition arrays (`SA_RRG.py:53-56,86-88`):
    a fresh graph per repetition, its neighbor table in ``graphs``."""

    mag_reached: np.ndarray  # f[N_stat]
    num_steps: np.ndarray    # int[N_stat]
    conf: np.ndarray         # int8[N_stat, n]
    graphs: np.ndarray       # int32[N_stat, n, d]
    m_final: np.ndarray      # f[N_stat]


def save_ensemble_npz(path: str, out: SAEnsembleResult) -> str:
    """The reference's npz keys (`SA_RRG.py:92`)."""
    from graphdyn_torch.utils.io import save_results_npz

    return save_results_npz(path, mag_reached=out.mag_reached,
                            num_steps=out.num_steps, conf=out.conf,
                            graphs=out.graphs)


def sa_ensemble(
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
    rollout_mode: str = "full",
    group_size: int | None = None,
    prefetch: int = 2,
    layout: str = "auto",
    chunk_steps: int = CHUNK_STEPS,
    stream_chunks: int = 4,
    device=None,
) -> SAEnsembleResult:
    """The reference's experiment driver (`SA_RRG.py:58-92`): ``n_stat``
    repetitions, repetition k on a fresh RRG(n, d) drawn from ``seed + k``
    with its chain seeded by ``seed + k``. Pass ``save_path`` for the npz
    with the reference's keys.

    ``group_size`` (default ``min(n_stat, 8)``) runs repetitions that many
    at a time as one batched program
    (:func:`graphdyn_torch.pipeline.sa_group.sa_ensemble_grouped`), element
    for element equal to the serial loop; ``group_size=0`` forces the
    serial loop, which ``rollout_mode='lightcone'`` and the non-padded
    layouts (``'bucketed'``, ``'streamed'`` with ``stream_chunks``) always
    take: each repetition's :func:`simulated_annealing` gets ``layout``.
    ``checkpoint_path`` is not ported (A16)."""
    if layout not in ("auto", "padded", "bucketed", "streamed"):
        raise ValueError(
            f"layout must be 'auto', 'padded', 'bucketed' or 'streamed', "
            f"got {layout!r}")
    if checkpoint_path is not None:
        raise _not_ported("checkpoint_path", "A16: checkpoints and resilience")
    dev = resolve_device(device)
    serial_only = rollout_mode != "full" or layout not in ("auto", "padded")
    if group_size is None:
        group_size = 0 if serial_only else min(max(n_stat, 1), 8)
    if group_size and serial_only:
        raise ValueError(
            "group_size >= 1 requires rollout_mode='full' and a padded-family "
            "layout (pass group_size=0 for the serial loop)")
    if group_size:
        from graphdyn_torch.pipeline.sa_group import sa_ensemble_grouped

        return sa_ensemble_grouped(
            n, d, config, n_stat=n_stat, seed=seed,
            graph_method=graph_method, max_steps=max_steps,
            save_path=save_path, group_size=group_size, prefetch=prefetch,
            chunk_steps=chunk_steps, device=dev)
    from graphdyn_torch.graphs import random_regular_graph

    config = config or SAConfig()
    mag = np.empty(n_stat, np.float64)
    steps = np.empty(n_stat, np.int64)
    conf = np.empty((n_stat, n), np.int8)
    graphs = np.empty((n_stat, n, d), np.int32)
    m_final = np.empty(n_stat, np.float64)
    for k in range(n_stat):
        g = random_regular_graph(n, d, seed=seed + k, method=graph_method)
        res = simulated_annealing(
            g, config, n_replicas=1, seed=seed + k, max_steps=max_steps,
            rollout_mode=rollout_mode, layout=layout,
            chunk_steps=chunk_steps, stream_chunks=stream_chunks, device=dev)
        mag[k] = res.mag_reached[0]
        steps[k] = res.num_steps[0]
        conf[k] = res.s[0]
        graphs[k] = g.nbr
        m_final[k] = res.m_final[0]
    out = SAEnsembleResult(mag, steps, conf, graphs, m_final)
    if save_path:
        save_ensemble_npz(save_path, out)
    return out
