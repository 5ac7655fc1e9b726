"""One-kernel annealing driver: the fused LUT-popcount SA search (the port
of ``graphdyn/search/fused.py``).

Drives :mod:`graphdyn_torch.ops.fused`: the chromatic class-at-a-time chain
with the dynamics rule compiled to a popcount LUT, counter-based Threefry
uniforms generated on the device, and the geometric anneal advanced inside
the device loop. In the default fixed-budget mode the host dispatches a
precomputed chunk plan and reads results back once at the end; each chunk
boundary waits on a CUDA event (a completion wait, not a device→host read).
``stop_on_first``, or a plan longer than :data:`MAX_FIXED_PLAN_CHUNKS`,
adds a per-chunk stop test that reads two flags back.

Restricted to ``p = c = 1`` (the distance-2 coloring's interaction radius).
Replicas are packed 32 per word; an optional per-replica drive ladder
(``betas``) scales each replica's ``(b0, b_cap)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.config import SAConfig
from graphdyn_torch.interop import words_from_numpy
from graphdyn_torch.ops.chromatic import replica_end_sums
from graphdyn_torch.ops.fused import (
    KERNELS,
    FusedDeviceTables,
    FusedState,
    FusedTables,
    build_fused_tables,
    fused_chunk,
    fused_device_tables,
)
from graphdyn_torch.ops.packed import WORD, pack_spins, unpack_spins
from graphdyn_torch.utils.platform import resolve_device

#: plans longer than this keep a per-chunk stop test instead of paying
#: thousands of no-op dispatches (``graphdyn/search/tempering.py:93``)
MAX_FIXED_PLAN_CHUNKS = 4096


class FusedResult(NamedTuple):
    s: np.ndarray                # int8[R, n] configurations at stop
    m_end: np.ndarray            # f64[R] rolled-out end-state magnetization
    mag_reached: np.ndarray      # f64[R] m(s(0)) at stop
    steps_to_target: np.ndarray  # int64[R] first-passage CLASS steps, −1
    sweeps_to_target: np.ndarray  # f64[R] the same in full sweeps, −1
    chi: int                     # colour classes = device steps per sweep
    sweeps: int                  # full sweeps run
    device_steps: int            # class steps run
    accepted: int                # cumulative accepted flips
    kernel_used: str             # 'cuda' | 'plain'


def _assemble_fused(graph, config: SAConfig, *, n_replicas: int, seed: int,
                    m_target: float, betas, tables: FusedTables | None,
                    device: torch.device):
    """The fused chunk's inputs on ``device``: the initial state (drawn with
    numpy from ``seed``, as the reference draws it), the device tables and
    the static sizes."""
    dyn = config.dynamics
    if dyn.p + dyn.c - 1 != 1:
        raise ValueError(
            "fused annealing requires p = c = 1 (one-step rollout: the "
            "distance-2 coloring covers interaction radius 2 exactly); "
            f"got p={dyn.p}, c={dyn.c}"
        )
    if not (0.0 < m_target <= 1.0):
        raise ValueError(f"m_target must be in (0, 1], got {m_target}")
    n = graph.n
    if tables is None:
        tables = build_fused_tables(graph, config, seed=seed)
    R = n_replicas
    W = -(-R // WORD)
    Rp = W * WORD
    if betas is not None:
        betas = np.asarray(betas, np.float64)
        if betas.shape != (R,):
            raise ValueError(
                f"betas must be one per replica ([{R}]), got {betas.shape}"
            )
    rng = np.random.default_rng(seed)
    s0 = (2 * rng.integers(0, 2, size=(R, n)) - 1).astype(np.int8)
    sp = pack_spins(torch.from_numpy(s0).to(device))
    sp_ext = torch.cat([sp, sp.new_zeros(1, W)])
    chrom = tables.chrom
    nbr_ext = torch.from_numpy(chrom.nbr_ext).to(device)
    nbr_self = torch.from_numpy(chrom.nbr_self).to(device)
    sum_end0 = replica_end_sums(
        sp, nbr_ext, torch.from_numpy(chrom.deg_ext).to(device), n,
        tables.dmax, dyn.rule, dyn.tie,
    )
    target_sum = int(np.ceil(m_target * n))
    real = torch.zeros(Rp, dtype=torch.bool, device=device)
    real[:R] = True
    reached = real & (sum_end0 >= target_sum)
    t_target0 = torch.where(reached, 0, -1).to(torch.int32)
    beta_p = np.ones(Rp, np.float32)
    if betas is not None:
        beta_p[:R] = betas.astype(np.float32)
    a0 = np.full(Rp, config.a0_frac * n, np.float32)
    b0 = np.full(Rp, config.b0_frac * n, np.float32) * beta_p
    a_caps = np.full(Rp, config.a_cap_frac * n, np.float32)
    b_caps = np.full(Rp, config.b_cap_frac * n, np.float32) * beta_p

    def dev(x):
        return torch.from_numpy(x).to(device)

    state = FusedState(
        sp_ext=sp_ext,
        sum_end=sum_end0,
        a=dev(a0),
        b=dev(b0),
        t_target=t_target0,
        active=real & (sum_end0 < target_sum),
        steps=torch.zeros((), dtype=torch.int32, device=device),
        accepted=torch.zeros((), dtype=torch.int32, device=device),
    )
    facs = np.stack([tables.fac_a, tables.fac_b], axis=1)
    lm = tables.lut_masks
    tables_dev = fused_device_tables(
        words_from_numpy(tables.masks_ext).to(device),
        dev(facs),
        nbr_ext,
        nbr_self,
        words_from_numpy(lm.reshape(-1, lm.shape[-1])).reshape(lm.shape)
        .to(device),
        dev(a_caps),
        dev(b_caps),
    )
    static = dict(n=n, dmax=tables.dmax, chi=tables.chi,
                  target_sum=target_sum)
    return state, tables_dev, static, tables, R, W, Rp


def _run_plan(state: FusedState, seed: int, tables_dev: FusedDeviceTables,
              kernel: str, plan, *, stop_on_first: bool, sync: bool,
              chi: int, static) -> FusedState:
    """The fused drive loop: dispatch the host-computed chunk plan. In
    fixed-budget mode (``sync=False``) there is no device→host read between
    chunks: a chunk whose replicas have all frozen is one no-op launch (the
    device loop's condition is false at once). Each boundary waits on a
    CUDA event recorded after the chunk, so the host tracks executed work,
    not queued launches, and then beats and honours a graceful shutdown
    (SIGTERM, ``--deadline``: exit 75; nothing to save, the chain re-derives
    from the seed). ``sync=True`` adds the per-chunk early-exit test."""
    from graphdyn_torch.resilience.shutdown import raise_if_requested

    cuda = state.sp_ext.device.type == "cuda"
    for cs in plan:
        if sync:
            # graftlint: disable-next-line=GD003  the chunk's stop test (the sanctioned per-chunk sync)
            if not bool(state.active.any()) or (
                    # graftlint: disable-next-line=GD003  the same per-chunk stop test
                    stop_on_first and bool((state.t_target >= 0).any())):
                break
        state = fused_chunk(state, seed, tables_dev, kernel=kernel,
                            chunk_steps=cs * chi,
                            stop_on_first=stop_on_first, **static)
        if cuda and not sync:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()          # a completion wait, not a read
        raise_if_requested(where="chunk")
    return state


def fused_anneal(
    graph,
    config: SAConfig | None = None,
    *,
    n_replicas: int = 32,
    seed: int = 0,
    m_target: float = 0.9,
    max_sweeps: int = 5000,
    chunk_sweeps: int = 256,
    stop_on_first: bool = False,
    kernel: str = "auto",
    betas=None,
    tables: FusedTables | None = None,
    layout: str = "auto",
    device=None,
) -> FusedResult:
    """Anneal R packed replicas by fused LUT class sweeps until each reaches
    ``Σs_end ≥ ceil(m_target·n)`` (first passage recorded per replica) or
    ``max_sweeps`` is spent, on ``device`` (default CUDA; raises on a host
    without one unless given ``device="cpu"``).

    Seed-deterministic and chunk-split invariant: every uniform derives from
    ``(seed, site, global class step)``. ``chunk_sweeps`` sets the chunk
    granularity only. ``kernel``: ``'auto'`` runs the CUDA kernel on the
    card and the plain version on the CPU; ``'cuda'`` requires the card;
    ``'plain'`` forces the plain PyTorch version (a test mode). ``tables``
    amortizes the coloring and LUT build across calls on one graph.

    ``layout``: ``'auto'`` consults
    :func:`graphdyn_torch.ops.bucketed.auto_layout`; a graph it routes to
    the bucketed layout, or ``layout='bucketed'``, is relabeled bucket-major
    (``degree_buckets`` order) before the coloring and LUT build, and the
    returned configurations are mapped back to the caller's ids, as the JAX
    package does. The seeded chain is labeling-dependent, so the relabeled
    run is another, equally distributed chain; prebuilt ``tables`` pin the
    caller's labeling and need ``layout='padded'`` (``'auto'`` then stays
    padded). The kernel runs any degree (hubs of a power-law graph
    included).
    """
    config = config or SAConfig()
    dev = resolve_device(device)
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "cuda" and dev.type != "cuda":
        raise ValueError("kernel='cuda' launches the CUDA kernel; it needs "
                         f"device='cuda', got {str(dev)!r}")
    if layout not in ("auto", "padded", "bucketed"):
        raise ValueError(
            f"layout must be 'auto', 'padded' or 'bucketed', got {layout!r}"
        )
    if layout == "auto":
        from graphdyn_torch.ops.bucketed import auto_layout

        layout = "padded" if tables is not None else auto_layout(graph.deg)
    if layout == "bucketed":
        if tables is not None:
            raise ValueError(
                "prebuilt FusedTables pin the caller's node labeling: "
                "pass layout='padded' (or tables=None) to relabel"
            )
        from graphdyn_torch.graphs import degree_buckets, permute_nodes

        g_b, inv = permute_nodes(graph, degree_buckets(graph).order)
        res = fused_anneal(
            g_b, config, n_replicas=n_replicas, seed=seed,
            m_target=m_target, max_sweeps=max_sweeps,
            chunk_sweeps=chunk_sweeps, stop_on_first=stop_on_first,
            kernel=kernel, betas=betas, layout="padded", device=dev,
        )
        return res._replace(s=res.s[..., inv])
    if chunk_sweeps < 1:
        raise ValueError(f"chunk_sweeps must be >= 1, got {chunk_sweeps}")
    if max_sweeps < 1:
        raise ValueError(f"max_sweeps must be >= 1, got {max_sweeps}")
    state, tables_dev, static, tables, R, W, Rp = _assemble_fused(
        graph, config, n_replicas=n_replicas, seed=seed, m_target=m_target,
        betas=betas, tables=tables, device=dev,
    )
    chi = tables.chi
    full, tail = divmod(int(max_sweeps), int(chunk_sweeps))
    plan = [int(chunk_sweeps)] * full + ([tail] if tail else [])
    sync = bool(stop_on_first) or len(plan) > MAX_FIXED_PLAN_CHUNKS
    state = _run_plan(state, seed, tables_dev, kernel, plan,
                      stop_on_first=bool(stop_on_first), sync=sync, chi=chi,
                      static=static)

    n = graph.n
    s_final = unpack_spins(state.sp_ext[:n], R).cpu().numpy()
    t_tgt = state.t_target[:R].cpu().numpy().astype(np.int64)
    steps = int(state.steps)
    return FusedResult(
        s=s_final,
        m_end=state.sum_end[:R].cpu().numpy().astype(np.float64) / n,
        mag_reached=s_final.astype(np.float64).sum(axis=1) / n,
        steps_to_target=t_tgt,
        sweeps_to_target=np.where(t_tgt >= 0, t_tgt / chi, -1.0),
        chi=chi,
        sweeps=steps // chi,
        device_steps=steps,
        accepted=int(state.accepted),
        kernel_used="cuda" if dev.type == "cuda" and kernel != "plain"
        else "plain",
    )
