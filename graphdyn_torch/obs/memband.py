"""Device-memory telemetry and the memcheck bands, the port's counterpart of
the JAX package's ``graphdyn/obs/memband.py``.

Two consumers:

- **Per-chunk gauges** (:func:`emit_memory_gauges`): the consensus scan and
  the HPr, entropy and SA chunk loops emit ``obs.mem.bytes_in_use`` /
  ``obs.mem.peak`` from the caching allocator's counters
  (``torch.cuda.memory_stats``, read in its nested form) at every chunk
  boundary while recording.
  These are host-side counters: reading them neither synchronizes nor reads
  the card. The port's kernels allocate nothing of their own (no
  ``cudaMalloc`` in ``csrc/``), so their workspaces are in the allocator's
  count too. A run on the CPU emits one ``obs.mem.unavailable`` gauge per
  recording scope carrying the reason: never silence, never a fake 0.
- **The memcheck rows** (:func:`run_memcheck`, ``python -m
  graphdyn_torch.obs memcheck``): the measured peak of each modelled
  program against its byte model. A program's measured peak is the
  allocator's peak while it ran, less the bytes already allocated when it
  started. Off the card every row reports ``null`` plus the reason and
  passes structurally. The halo row measures one rank's shard on the card
  (the widest shard of the 2-part smoke partition, stepped by the K1/K2′
  launch on the shard layout with its slab buffers) against
  :func:`halo_shard_bytes` of that shard, as the JAX package charges the
  widest shard. The sharded stream's row (``streamed_shard``) charges the
  widest shard of the 2-part smoke plan its two largest chunks
  (:func:`graphdyn_torch.parallel.stream.shard_plan_device_bytes`, the
  number the JAX package's per-shard admission prices) and measures one
  rank's walk of that shard's chunks on the card (KB launches from host
  slabs; one card has no partner rank, and the exchange's slabs are not
  part of the chunk model). The JAX package's ``derived:*`` rows check
  its HLO-derived models, which the port does not have.

The byte models are the JAX package's, held equal to them by the tests. The
bucketed and streamed ones live beside their layouts (``ops/bucketed.py``,
``ops/streamed.py``) and are called through from here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


#: peak-bytes / model-bytes bands per program, (lo, hi): the JAX package's.
#: lo: the peak must at least cover the modelled resident state; hi: a
#: blowup past it means a duplicated state, not allocator slop. An H100
#: measured 2.33 / 3.50 / 1.53 / 2.12 / 1.86 (packed, stack, entropy chunk,
#: bucketed, streamed; PERF.md §6), inside every band.
MEM_BANDS: dict[str, tuple[float, float]] = {
    "packed_state": (0.5, 16.0),
    "bdcm_stack": (0.5, 16.0),
    "entropy_cell_chunk": (0.25, 16.0),
    "halo_shard": (0.25, 16.0),
    "bucketed_state": (0.25, 16.0),
    "streamed_chunk": (0.05, 64.0),
    "streamed_shard": (0.05, 64.0),
}

# ---------------------------------------------------------------------------
# byte models
# ---------------------------------------------------------------------------


# the layouts' own models are imported when called: the layout modules import
# obs for their sites


def bucketed_state_bytes(n: int, W: int, table_entries: int) -> int:
    """:func:`graphdyn_torch.ops.bucketed.bucketed_state_bytes`."""
    from graphdyn_torch.ops import bucketed

    return bucketed.bucketed_state_bytes(n, W, table_entries)


def bucketed_job_bytes(n: int, W: int, n_edges: int) -> int:
    """:func:`graphdyn_torch.ops.bucketed.bucketed_job_bytes`."""
    from graphdyn_torch.ops import bucketed

    return bucketed.bucketed_job_bytes(n, W, n_edges)


def bucketed_table_entries_bound(n: int, n_edges: int) -> int:
    """:func:`graphdyn_torch.ops.bucketed.bucketed_table_entries_bound`."""
    from graphdyn_torch.ops import bucketed

    return bucketed.bucketed_table_entries_bound(n, n_edges)


def streamed_chunk_bytes(C: int, M: int, width: int, W: int) -> int:
    """:func:`graphdyn_torch.ops.streamed.streamed_chunk_bytes`."""
    from graphdyn_torch.ops import streamed

    return streamed.streamed_chunk_bytes(C, M, width, W)


def streamed_min_bytes(dmax: int, W: int) -> int:
    """:func:`graphdyn_torch.ops.streamed.streamed_min_bytes`."""
    from graphdyn_torch.ops import streamed

    return streamed.streamed_min_bytes(dmax, W)


def fused_model_bytes(n: int, W: int, chi: int, dmax: int) -> int:
    """The JAX package's resident-set formula of its fused kernel
    (``graphdyn/ops/pallas_anneal.py:225``, ``fused_vmem_bytes``), the
    service's price of a fused job (``Rp = 32·W`` replica lanes, 4-byte
    words): the double-buffered packed state ``2·4·(n+1)·W``, the CSA planes
    and count masks ``(⌈log₂(dmax+1)⌉ + dmax+1)·4·(n+1)·W``, the tables
    ``4·(n+1)·(χ + 2·(dmax+1) + 2·dmax+1)`` and the per-replica expansion
    ``6·4·(n+1)·Rp``. A formula, not a measurement of K4′."""
    Rp = 32 * W
    n1 = n + 1
    n_planes = max(int(dmax).bit_length(), 1)
    return 4 * n1 * (
        W * (2 + n_planes + dmax + 1)
        + chi
        + 2 * (dmax + 1)
        + (2 * dmax + 1)
        + 6 * Rp
    )


def packed_state_bytes(n: int, d: int, W: int) -> int:
    """Resident device state of the packed rollout: the ``[n, W]`` words
    (32 replicas a word), the ``int32[n, d]`` neighbour table and the
    ``int32[n]`` degrees."""
    return 4 * n * W + 4 * n * d + 4 * n


def halo_shard_bytes(n_local: int, n_ghost: int, W: int) -> int:
    """Resident packed words of one halo shard: its owned rows and the
    ghost rows it refreshes each step."""
    return 4 * n_local * W + 4 * n_ghost * W


def streamed_state_bytes(n: int, W: int, n_edges: int, chunks: int) -> int:
    """Modelled peak device bytes of the streamed rollout at ``chunks``
    chunks: two chunks resident at once (active and prefetched), each
    charged :func:`streamed_chunk_bytes` at the balanced per-chunk shape
    (``C = ⌈n/K⌉`` rows, ``e_c = ⌈(4E+n)/K⌉`` table slots, ``M ≤ C + e_c``
    slab rows)."""
    if chunks < 1:
        raise ValueError(f"chunks must be >= 1, got {chunks}")
    C = -(-n // chunks)
    e_c = -(-bucketed_table_entries_bound(n, n_edges) // chunks)
    # streamed_chunk_bytes charges 4·C·width for the table; at the
    # balanced shape that term is 4·e_c: width=1 plus the correction
    return 2 * streamed_chunk_bytes(C, C + e_c, 1, W) + 4 * e_c - 4 * C


def streamed_chunk_count(n: int, W: int, n_edges: int,
                         budget_bytes: int) -> int | None:
    """The smallest chunk count whose :func:`streamed_state_bytes` fits
    ``budget_bytes``, or None when even one-node chunks do not."""
    if streamed_state_bytes(n, W, n_edges, max(n, 1)) > budget_bytes:
        return None
    lo, hi = 1, 1
    while streamed_state_bytes(n, W, n_edges, hi) > budget_bytes:
        lo, hi = hi, min(hi * 2, max(n, 1))
    while lo < hi:
        mid = (lo + hi) // 2
        if streamed_state_bytes(n, W, n_edges, mid) > budget_bytes:
            lo = mid + 1
        else:
            hi = mid
    return hi


def _itemsize(dtype) -> int:
    """Bytes per element of a torch or numpy dtype."""
    import torch

    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def stacked_bdcm_bytes(stk) -> int:
    """Resident bytes of a stacked BDCM cell group
    (:class:`graphdyn_torch.ops.bdcm.StackedBDCM`): the ``[G, 2E_max+1, K,
    K]`` chi stack (ghost row included), the group's tilted factors
    (``G·K²·M_d`` per degree class) and the int64 index tables."""
    G, K = stk.G, stk.K
    itemsize = _itemsize(stk.dtype)
    chi = G * (stk.twoE_max + 1) * K * K * itemsize
    a_stack = sum(G * K * K * A.shape[-1] * itemsize
                  for (_, _, _, A) in stk.edge_classes)
    tables = sum(8 * (np.size(idx) + np.size(in_edges))
                 for (_, idx, in_edges, _) in stk.edge_classes) \
        + 8 * np.size(stk.leaf_idx)
    return chi + a_stack + tables


def entropy_chunk_bytes(stk) -> int:
    """Working set of one grouped entropy chunk: the resident stack, a
    second chi stack (each sweep writes a new one while the old is live)
    and the widest degree class's DP scratch ``[G, Ed, K, M]``."""
    G, K = stk.G, stk.K
    itemsize = _itemsize(stk.dtype)
    chi = G * (stk.twoE_max + 1) * K * K * itemsize
    scratch = max((G * np.shape(idx)[1] * K * A.shape[-1] * itemsize
                   for (_, idx, _, A) in stk.edge_classes), default=0)
    return stacked_bdcm_bytes(stk) + chi + scratch


# ---------------------------------------------------------------------------
# device stats
# ---------------------------------------------------------------------------


def _device(device):
    import torch

    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    return torch.device(device)


def device_memory_stats(device=None) -> tuple[dict | None, str | None]:
    """``(stats, None)`` from the caching allocator of ``device`` (default:
    the current card, else the CPU), with ``bytes_in_use`` and
    ``peak_bytes_in_use``; or ``(None, reason)`` where there is none."""
    import torch

    dev = _device(device)
    if dev.type != "cuda":
        return None, (f"device {dev.type!r} has no caching-allocator "
                      "memory stats (host memory)")
    try:
        # the nested form: torch.cuda.memory_stats flattens the same dict in
        # Python, which costs a chunk boundary more than the event writes
        raw = torch.cuda.memory_stats_as_nested_dict(dev)
        alloc, reserved = raw["allocated_bytes"]["all"], \
            raw["reserved_bytes"]["all"]
    except Exception as e:  # noqa: BLE001 — telemetry must not kill the run
        return None, f"torch.cuda.memory_stats() failed: {str(e)[:120]}"
    return {"bytes_in_use": int(alloc["current"]),
            "peak_bytes_in_use": int(alloc["peak"]),
            "bytes_reserved": int(reserved["current"])}, None


def emit_memory_gauges(device=None, **attrs) -> None:
    """Emit ``obs.mem.bytes_in_use`` / ``obs.mem.peak`` for ``device`` — the
    per-chunk call of the driver loops. Free when not recording (one
    enabled check); where there are no stats, one ``obs.mem.unavailable``
    gauge per recording scope carries the reason."""
    from graphdyn_torch import obs

    if not obs.enabled():
        return
    stats, reason = device_memory_stats(device)
    if stats is None:
        # once per recording scope: the marker lives on the recorder
        rec = obs.current()
        if not getattr(rec, "_memband_unavailable_warned", False):
            rec._memband_unavailable_warned = True
            obs.gauge("obs.mem.unavailable", 1, reason=reason, **attrs)
        return
    obs.gauge("obs.mem.bytes_in_use", stats["bytes_in_use"], **attrs)
    obs.gauge("obs.mem.peak", stats["peak_bytes_in_use"], **attrs)


def peak_hbm_bytes(device=None) -> tuple[int | None, str | None]:
    """``(peak allocated bytes, None)`` or ``(None, reason)``."""
    stats, reason = device_memory_stats(device)
    if stats is None:
        return None, reason
    return stats["peak_bytes_in_use"], None


# ---------------------------------------------------------------------------
# memcheck
# ---------------------------------------------------------------------------


class MemRow(NamedTuple):
    program: str
    measured: int | None    # peak bytes (None: not measured, see reason)
    model: float            # modelled bytes
    frac: float | None      # measured / model
    lo: float
    hi: float
    reason: str | None      # why measured is None (the structural pass)
    device: str = ""        # the CUDA device name, or "cpu"

    @property
    def ok(self) -> bool:
        if self.frac is None:
            return self.reason is not None
        return self.lo <= self.frac <= self.hi


def _row(program: str, measured: int | None, model: float,
         reason: str | None = None) -> MemRow:
    lo, hi = MEM_BANDS[program]
    frac = (measured / model) if (measured is not None and model) else None
    return MemRow(program, measured, model, frac, lo, hi, reason)


class _Peak:
    """The allocator's peak over a block, less the bytes allocated when it
    began: ``with _Peak(dev) as p: ...; p.bytes``."""

    def __init__(self, dev):
        self.dev = dev
        self.bytes = None

    def __enter__(self):
        import gc

        import torch

        gc.collect()
        torch.cuda.synchronize(self.dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.base = torch.cuda.memory_allocated(self.dev)
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize(self.dev)
        self.bytes = torch.cuda.max_memory_allocated(self.dev) - self.base
        return False


def _smoke_packed(n: int = 32768, d: int = 3, W: int = 8):
    from graphdyn_torch.graphs import random_regular_graph

    g = random_regular_graph(n, d, seed=0)
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint64)
    return g, words.astype(np.uint32).view(np.int32)


def _smoke_stack(n: int = 1024, c: float = 3.0, G: int = 4):
    from graphdyn_torch.obs.roofline import bdcm_instance
    from graphdyn_torch.ops.bdcm import stack_bdcm

    return stack_bdcm([bdcm_instance(n, c, seed=10 + k)[0]
                       for k in range(G)])


def _smoke_powerlaw(n: int = 4096):
    from graphdyn_torch.graphs import degree_buckets, powerlaw_graph

    g = powerlaw_graph(n, gamma=2.5, dmin=2, seed=0)
    return g, degree_buckets(g)


def _smoke_plan(n: int = 4096, chunks: int = 8, W: int = 8):
    from graphdyn_torch.ops.streamed import build_stream_plan

    g, _ = _smoke_powerlaw(n)
    return g, build_stream_plan(g, W=W, n_chunks=chunks)


def _smoke_shard_plan(n: int = 4096, chunks: int = 4, W: int = 8,
                      P: int = 2):
    """The sharded stream's smoke plan: the streamed smoke graph in ``P``
    parts, ``chunks`` chunks a shard."""
    from graphdyn_torch.graphs import partition_graph
    from graphdyn_torch.parallel.stream import build_shard_stream_plan

    g, _ = _smoke_powerlaw(n)
    return g, build_shard_stream_plan(g, W=W, partition=partition_graph(
        g, P, seed=0), n_chunks=chunks)


def _widest_stream_shard(plan, W: int) -> int:
    """The shard whose two largest chunks model the most device bytes."""
    return int(np.argmax([plan.shard_bytes(p, W) for p in range(plan.P)]))


def _halo_smoke_tables(n: int = 8192, P: int = 2):
    """The halo smoke partition's tables (d=3 RRG, the headline degree),
    the JAX package's smoke shape."""
    from graphdyn_torch.graphs import partition_graph, random_regular_graph
    from graphdyn_torch.parallel.halo import build_halo_tables

    g = random_regular_graph(n, 3, seed=0)
    part = partition_graph(g, P, seed=0)
    return g, part, build_halo_tables(g, part)


def _widest_shard(tables) -> int:
    return int(np.argmax(tables.counts + tables.ghost_counts))


def _halo_smoke_model(W: int = 8) -> float:
    """The widest shard's ``halo_shard`` model bytes at the smoke shape."""
    _, _, t = _halo_smoke_tables()
    return float(max(halo_shard_bytes(int(t.counts[p]), int(t.ghost_counts[p]),
                                      W) for p in range(t.P)))


def shard_plan_device_bytes(plan, W: int) -> int:
    """:func:`graphdyn_torch.parallel.stream.shard_plan_device_bytes`."""
    from graphdyn_torch.parallel import stream

    return stream.shard_plan_device_bytes(plan, W)


def _models(W: int = 8) -> dict:
    """Every row's model bytes at the smoke shapes."""
    from graphdyn_torch.ops.streamed import plan_device_bytes

    stk = _smoke_stack()
    _, b = _smoke_powerlaw()
    _, plan = _smoke_plan(W=W)
    return {"packed_state": float(packed_state_bytes(32768, 3, W)),
            "bdcm_stack": float(stacked_bdcm_bytes(stk)),
            "entropy_cell_chunk": float(entropy_chunk_bytes(stk)),
            "halo_shard": _halo_smoke_model(W),
            "bucketed_state": float(bucketed_state_bytes(
                b.n, W, b.table_entries)),
            "streamed_chunk": float(plan_device_bytes(plan, W)),
            "streamed_shard": float(shard_plan_device_bytes(
                _smoke_shard_plan(W=W)[1], W))}


def _measure(dev, W: int = 8, steps: int = 8) -> dict:
    """Each program's own peak on the card at its smoke shape."""
    import torch

    from graphdyn_torch.obs.roofline import entropy_smoke
    from graphdyn_torch.ops.bucketed import bucketed_rollout
    from graphdyn_torch.ops.packed import packed_rollout
    from graphdyn_torch.ops.streamed import streamed_rollout

    out = {}
    g, words = _smoke_packed(W=W)
    with _Peak(dev) as p:
        nbr = torch.as_tensor(g.nbr, device=dev)
        deg = torch.as_tensor(g.deg, device=dev)
        sp = torch.as_tensor(words, device=dev)
        packed_rollout(nbr, deg, sp, steps)
        del nbr, deg, sp
    out["packed_state"] = p.bytes
    with _Peak(dev) as p:
        entropy_smoke(device=dev, chunks=1)
    out["bdcm_stack"] = out["entropy_cell_chunk"] = p.bytes
    out["halo_shard"] = _measure_halo_shard(dev, W, steps)
    g, b = _smoke_powerlaw()
    with _Peak(dev) as p:
        bucketed_rollout(b, torch.zeros((g.n, W), dtype=torch.int32,
                                        device=dev), steps)
    out["bucketed_state"] = p.bytes
    g, plan = _smoke_plan(W=W)
    with _Peak(dev) as p:
        streamed_rollout(g, np.zeros((g.n, W), np.uint32), steps, plan=plan,
                         device=dev)
    out["streamed_chunk"] = p.bytes
    out["streamed_shard"] = _measure_stream_shard(dev, W, steps)
    return out


def _measure_stream_shard(dev, W: int, steps: int) -> int:
    """One rank's peak on the sharded stream: ``steps`` walks of the widest
    smoke shard's chunks, prefetched and stepped by KB as a rank walks
    them, from its host halo-layout state."""
    import torch

    from graphdyn_torch.ops.streamed import _ChunkStepper
    from graphdyn_torch.pipeline.prefetch import HostPrefetcher

    _, plan = _smoke_shard_plan(W=W)
    p = _widest_stream_shard(plan, W)
    chunks = [c for c in plan.shard_chunks[p] if c.C]
    loc = torch.zeros((plan.tables.n_rows, W), dtype=torch.int32)
    with _Peak(dev) as pk:
        stepper = _ChunkStepper(dev, "majority", "stay")
        for _ in range(steps):
            with HostPrefetcher(lambda c: stepper.build(loc, c, chunks[c]),
                                range(len(chunks)), depth=2) as pf:
                for c in range(len(chunks)):
                    stepper.step(pf.get(c))
        del stepper
    return pk.bytes


def _measure_halo_shard(dev, W: int, steps: int) -> int:
    """One rank's peak on the shard layout: the widest smoke shard's state
    and spare buffer, its tables, ``steps`` K1/K2′ launches on the layout
    and, after each, the slab gathers and ghost-row scatters of the
    exchange (taken from the shard itself: one card has no partner rank,
    and the buffers are the same size)."""
    import torch

    from graphdyn_torch.parallel.halo import ShardStep

    _, _, t = _halo_smoke_tables()
    p = _widest_shard(t)
    with _Peak(dev) as pk:
        step = ShardStep(torch.as_tensor(t.nbr_loc[p], device=dev),
                         torch.as_tensor(t.deg_loc[p], device=dev),
                         n_update=int(t.counts[p]), rule="majority",
                         tie="stay")
        sends = [torch.as_tensor(x[p], dtype=torch.int64, device=dev)
                 for (_, x, _) in t.schedule]
        recvs = [torch.as_tensor(x[p], dtype=torch.int64, device=dev)
                 for (_, _, x) in t.schedule]
        src = torch.zeros((t.n_rows, W), dtype=torch.int32, device=dev)
        spare = src.clone()
        for _ in range(steps):
            dst = step(src, spare)
            for si, ri in zip(sends, recvs):
                dst.index_copy_(0, ri, dst.index_select(0, si))
            src, spare = dst, src
        del step, sends, recvs, src, spare, dst
    return pk.bytes


def run_memcheck(*, diag=None, device=None) -> list[MemRow]:
    """Every modelled program's peak against its band on ``device``
    (default the card; raises ``RuntimeError`` with none). With
    ``device="cpu"`` the structural rows (models evaluated, measured null
    plus the reason). Each row names its device. Emits one ``obs.memband.<program>`` gauge
    per row when recording."""
    import torch

    from graphdyn_torch import obs
    from graphdyn_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    models = _models()
    stats, reason = device_memory_stats(dev)
    measured = _measure(dev) if stats is not None else {}
    rows = [_row(p, measured.get(p), m, reason if stats is None else None)
            for p, m in models.items()]
    rows = [row._replace(device=name) for row in rows]
    for row in rows:
        obs.gauge(f"obs.memband.{row.program}", row.measured,
                  model=row.model, frac=row.frac, ok=row.ok, device_name=name,
                  **({"reason": row.reason} if row.reason else {}))
        if diag:
            if row.measured is None:
                diag(f"memcheck: {row.program}: model {row.model:.3e} B, "
                     f"measured null ({row.reason}) — structural pass")
            else:
                verdict = "ok" if row.ok else "OUT OF BAND"
                diag(f"memcheck: {row.program}: measured peak "
                     f"{row.measured:.3e} B, model {row.model:.3e} B -> "
                     f"frac {row.frac:.3f} (band [{row.lo:g}, {row.hi:g}]) "
                     f"{verdict}")
    return rows
