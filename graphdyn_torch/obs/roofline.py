"""The H100's roofline and the port's bound models, with the obscheck rows,
the port's counterpart of the JAX package's ``graphdyn/obs/roofline.py``.

Two halves:

- **Bound models** of the hand-written kernels: the least time a launch can
  take on the card, the larger of the bytes it must move (each input read
  once, each output written once) over the HBM rate and the operations it
  must do over the card's peak rate for their type. ``chip_smoke.py``
  prints its ``bound_ms`` from these functions: :func:`step_bound` (K1/K2′,
  with :func:`majority_ops`), :func:`class_step_bound` (K4′),
  :func:`contract_bound` (K3), :func:`sweep_bound` (K3′) and
  :func:`kb_bound` (KB). The rates are the H100 SXM's published peaks
  (:data:`H100`).
- **obscheck** (:func:`run_obscheck`, ``python -m graphdyn_torch.obs
  check``): three headline programs (the packed rollout, a BDCM sweep, the
  grouped entropy chunk) measured at smoke shapes against the JAX package's
  byte models (:func:`packed_bytes_per_update`,
  :func:`bdcm_bytes_per_edge_sweep`), as a fraction of the roof. On a card
  with a profile in :data:`CHIP_BANDS` the roof is its HBM rate and the
  bands are that card's. The check runs on the card unless the caller asks
  for the CPU (``device="cpu"``): then the roof is the host's copy
  bandwidth, measured at check time, with the host-proxy :data:`BANDS`.
  Each row names its device and its anchor (``chip:<kind>`` or
  ``host-proxy``). A card with no profile is refused (``LookupError``, an
  ``obs.roofline.uncalibrated`` gauge): no card borrows another part's
  roof.

Byte models (f32; K = 2**T, M = (d+1)**T), the JAX package's:

- **packed rollout** — per spin update, ``d·4W`` gathered and ``4W``
  written bytes across ``32·W`` replicas: ``(d+1)/8`` B per update.
- **BDCM sweep** — per directed edge per sweep, the DP lattice: d rounds
  reading ``[K, M]`` K times and writing it once (``4·d·(K+1)·K·M``), the
  contraction (``4·K²·M``) and the chi rows (``4·(d+2)·K²``). The port's
  sweep kernel keeps the lattice in registers or shared memory, so on the
  card the fraction may pass 1.
- **entropy cell chunk** — the BDCM model per lane.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
#: 32-bit non-tensor-core rate (the float32 figure; the packed step's work
#: is 32-bit integer logic, which the table lists no separate rate for)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
#: 32-bit integer ops: 132 SMs x 64 INT32 lanes x 1.98 GHz (the Hopper white
#: paper's per-SM units, at the boost clock that gives the data sheet's 67
#: TFLOP/s f32 = 132 x 128 lanes x 2 flops x 1.98 GHz)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: float64 outside the tensor cores (H100 SXM data sheet)
F64_FLOPS_PER_S = 34e12
#: one Threefry-2x32 block: 20 rounds of add, rotate, xor, 5 key injections
#: of 2 adds (the key word plus the injection index fold into one constant
#: per thread), 2 initial adds; one accurate expf counted as 10 f32 ops
THREEFRY_OPS, EXPF_OPS = 20 * 3 + 5 * 2 + 2, 10

#: measured/model bands of the host proxy (no card): (lo, hi). An idle
#: 8-core host measured 0.012 / 0.061 / 0.062 at the cpu smoke shapes; lo
#: sits some 25x under that, for a host shared by test workers
BANDS: dict[str, tuple[float, float]] = {
    "packed_rollout": (0.0005, 4.0),
    "bdcm_sweep": (0.002, 4.0),
    "entropy_cell_chunk": (0.002, 4.0),
}

#: the H100's rates and its obscheck bands. An H100 80GB HBM3 at 700 W
#: measured 0.0098 / 0.041 / 0.073 of the roof at the cuda smoke shapes
#: (the packed rollout is host-bound there: 8 steps a call); lo is a decade
#: under that, hi 10 (a smoke state small enough for L2 may pass the HBM
#: roof). PERF.md §6 has the run.
H100: dict = {
    "hbm_bytes_per_s": HBM_BYTES_PER_S,
    "alu_ops_per_s": ALU_OPS_PER_S,
    "int32_ops_per_s": INT32_OPS_PER_S,
    "f64_flops_per_s": F64_FLOPS_PER_S,
    "bands": {
        "packed_rollout": (0.001, 10.0),
        "bdcm_sweep": (0.004, 10.0),
        "entropy_cell_chunk": (0.007, 10.0),
    },
}

#: the obscheck smoke shapes: the card's, and smaller ones for the host
#: proxy, whose programs run the plain PyTorch versions
SMOKE: dict[str, dict] = {
    "cuda": {"packed": dict(n=32768, W=8, steps=8, iters=3),
             "bdcm": dict(n=2048, sweeps=20),
             "entropy": dict(n=1024, G=4, chunks=2)},
    "cpu": {"packed": dict(n=4096, W=2, steps=4, iters=1),
            "bdcm": dict(n=256, sweeps=4),
            "entropy": dict(n=256, G=2, chunks=1)},
}

#: chip profiles keyed by a lower-case substring of the CUDA device name
CHIP_BANDS: dict[str, dict] = {"h100": H100}


def chip_profile(name: str | None = None) -> tuple[str, float, dict] | None:
    """``(key, hbm_bytes_per_s, bands)`` of the card's :data:`CHIP_BANDS`
    entry, from its CUDA device name (``name``, default the current card's),
    or None with no card or no entry for it."""
    if name is None:
        import torch

        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0)
    for key, prof in CHIP_BANDS.items():
        if key in name.lower():
            return key, prof["hbm_bytes_per_s"], prof["bands"]
    return None


def _bound(bytes_: float, ops: float, rate: float) -> dict:
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}


# ---------------------------------------------------------------------------
# bound models of the kernels
# ---------------------------------------------------------------------------


def majority_ops(W: int, deg) -> int:
    """The 32-bit logic one packed step needs over rows of degrees ``deg``,
    ``W`` words a row: per word, one full adder per gathered neighbour word
    (two 3-input LOP3 instructions, the sum and the carry of a carry-save
    adder tree, whatever the degree), ~5 ops a plane to compare the count
    with deg/2 on bit_length(deg) planes, and ~4 to apply the rule and the
    tie."""
    from graphdyn_torch.graphs import _bit_length

    deg = np.asarray(deg, np.int64)
    planes = np.maximum(_bit_length(deg), 1)
    return int(W * (2 * deg + 5 * planes + 4).sum())


def step_bound(g, W: int, fast: bool) -> dict:
    """The least time one packed step (K1/K2′) can take: the larger of the
    bytes it must move over HBM bandwidth and its 32-bit logic
    (:func:`majority_ops`) over the INT32 rate. ``g`` has ``n`` and
    ``deg``. The bytes are each input read once and each output written
    once: the ``[n+1, W]`` state read and written, the ``Σdeg`` neighbour
    indices the kernel reads (it loops to each node's degree, not dmax), and
    the degrees on the general path. ``no_reuse_bytes`` is what a design
    with no reuse of gathered rows moves instead (every neighbour row and,
    on the general path, the own row fetched from HBM): a model of the
    kernel's traffic, not a bound."""
    n = g.n
    sum_deg = int(np.asarray(g.deg, np.int64).sum())
    n_own = 0 if fast else n
    state_bytes = 2 * 4 * W * (n + 1)                   # read once, written once
    table_bytes = 4 * sum_deg + (0 if fast else 4 * n)
    no_reuse_bytes = 4 * W * (sum_deg + n_own + n + 1) + table_bytes
    ops = majority_ops(W, g.deg)
    b = _bound(state_bytes + table_bytes, ops, INT32_OPS_PER_S)
    return {"bytes": state_bytes + table_bytes, "ops": ops,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "no_reuse_bytes": no_reuse_bytes,
            "no_reuse_ms": no_reuse_bytes / HBM_BYTES_PER_S * 1e3}


def class_step_counts(chrom) -> list[dict]:
    """Per χ class of a colouring (``chrom``, the ChromaticTables) the counts
    :func:`class_step_bound_counts` reads: the class rows C (``k``), the
    ball B = C ∪ N(C), the rows D = B ∪ N(B) that its two LUT evaluations
    read (``n_d``), and the degree sums ``deg_b`` = Σ_B deg, ``deg_b1`` =
    Σ_B (deg+1), ``deg_c1`` = Σ_C (deg+1), with ``nb_terms`` = Σ_B (2·deg·NP
    + (deg+1)·(NP+4)) (NP = bit_length(dmax))."""
    n, dmax = chrom.n, chrom.dmax
    nbr = chrom.nbr_ext[:n].astype(np.int64)       # ghost index n pads
    deg = chrom.deg_ext[:n].astype(np.int64)
    NP = max(dmax.bit_length(), 1)

    def grow(rows):                     # rows ∪ N(rows), as a node mask
        out = rows.copy()
        idx = nbr[rows].ravel()
        out[idx[idx < n]] = True
        return out

    per = []
    for c in range(chrom.chi):
        in_c = chrom.colors == c
        in_b = grow(in_c)
        in_d = grow(in_b)
        deg_b, deg_c = deg[in_b], deg[in_c]
        per.append({
            "k": int(in_c.sum()), "n_d": int(in_d.sum()),
            "deg_b": int(deg_b.sum()), "deg_b1": int((deg_b + 1).sum()),
            "deg_c1": int((deg_c + 1).sum()),
            "nb_terms": int((2 * deg_b * NP + (deg_b + 1) * (NP + 4)).sum()),
        })
    return per


def class_step_bound_counts(per: list[dict], W: int, dmax: int) -> dict:
    """:func:`class_step_bound` from the per-class counts of
    :func:`class_step_counts`: for each class the larger of

    - bytes over HBM bandwidth: the state rows of D read once (4·|D|·W), the
      class rows written once (4·|C|·W), the table entries read once
      (neighbours of B 4·Σ_B deg, balls of C 4·Σ_C (deg+1), LUT masks of B
      8·Σ_B (deg+1), the class mask over D 4·|D|) and the six per-replica
      vectors (24·Rp);
    - 32-bit integer ops over the INT32 rate: |C|·Rp/2 Threefry blocks of
      THREEFRY_OPS, the two LUT evaluations' carry-save and select logic per
      word of B (2·(2·deg·NP + (deg+1)·(NP+4))), the ball popcounts per class
      word ((deg+1)·(2+4·NB)), and the per-replica bit extraction (4·NB+6
      per class site and replica);
    - f32 ops over the f32 rate: ΔE, the uniform and expf per class site and
      replica (EXPF_OPS + 6);

    averaged over the classes. NB = bit_length(dmax+1), Rp = 32·W."""
    Rp = 32 * W
    NB = (dmax + 1).bit_length()
    rows = []
    for c in per:
        k, n_d = c["k"], c["n_d"]
        nbytes = 4 * n_d * W + 4 * k * W + 4 * c["deg_b"] \
            + 4 * c["deg_c1"] + 8 * c["deg_b1"] + 4 * n_d + 24 * Rp
        int_ops = k * Rp / 2 * THREEFRY_OPS + W * 2 * c["nb_terms"] \
            + W * c["deg_c1"] * (2 + 4 * NB) + k * Rp * (4 * NB + 6)
        f32_ops = k * Rp * (EXPF_OPS + 6)
        rows.append((nbytes / HBM_BYTES_PER_S * 1e3,
                     int_ops / INT32_OPS_PER_S * 1e3,
                     f32_ops / ALU_OPS_PER_S * 1e3, nbytes, int_ops, f32_ops))
    mean = [sum(r[i] for r in rows) / len(rows) for i in range(6)]
    bytes_ms, int_ms, f32_ms = mean[:3]
    return {"bound_ms": max(bytes_ms, int_ms, f32_ms),
            "bound_by": "bytes" if bytes_ms >= max(int_ms, f32_ms)
            else "operations",
            "bytes": mean[3], "int_ops": mean[4], "f32_ops": mean[5],
            "bytes_ms": bytes_ms, "int_ms": int_ms, "f32_ms": f32_ms}


def class_step_bound(chrom, W: int) -> dict:
    """The least time one fused class step (K4′) can take on the card,
    averaged over the χ classes of a sweep of this graph's colouring
    ``chrom``: only the ball of the class rows enters a decision, so the
    count is over it (:func:`class_step_bound_counts`)."""
    return class_step_bound_counts(class_step_counts(chrom), W, chrom.dmax)


def _dp_fmas(d: int, T: int) -> int:
    """FMAs of one edge's flat-shift DP and contraction: d·K·Σ_k (M − off_k)
    and K²·M, off_k the flat shift of trajectory k (the loops do not depend
    on the data)."""
    from graphdyn_torch.ops.bdcm import _flat_offsets

    K, M = 2**T, (d + 1) ** T
    return d * K * int((M - _flat_offsets(d, T)).sum()) + K * K * M


def contract_bound(G: int, Ed: int, d: int, T: int, dtype,
                   per_group: bool = False) -> dict:
    """The least time one BDCM class-update launch (K3) can take: the
    larger of

    - bytes over HBM bandwidth: chi_in (G·Ed·d·K²), chi_old and out
      (G·Ed·K² each) and the factor (K²·M, G times per group), each once;
    - FMAs (2 flops each) over the card's non-tensor rate for the dtype:
      the flat-shift DP, d·K·Σ_k (M − off_k) per edge, and the contraction,
      K²·M per edge.

    K = 2^T, M = (d+1)^T; f32 at 67 TFLOP/s, f64 at 34 TFLOP/s."""
    import torch

    K, M = 2**T, (d + 1) ** T
    size = 8 if dtype == torch.float64 else 4
    nbytes = size * (G * Ed * (d + 2) * K * K
                     + (G if per_group else 1) * K * K * M)
    flops = 2 * _dp_fmas(d, T) * G * Ed
    rate = F64_FLOPS_PER_S if dtype == torch.float64 else ALU_OPS_PER_S
    return {**_bound(nbytes, flops, rate), "bytes": nbytes, "flops": flops}


def sweep_counts(plan, a_tilted, bias) -> dict:
    """The counts :func:`sweep_bound_counts` reads, from a sweep's
    ``SweepPlan``, its tilted factors and its bias: ``G``, ``rows``, ``T``,
    the element size, the bytes of the class ids, the rows in no class, the
    bias values and the node bias's source table, and per class ``(d,
    table entries, live members, factor elements)`` (padding members compute
    nothing)."""
    import torch

    from graphdyn_torch.ops.bdcm import NodeBias

    esize = 8 if plan.dtype == torch.float64 else 4
    bias_elems = src = 0
    if isinstance(bias, NodeBias):
        bias_elems, src = bias.values.numel(), plan.src.numel()
    elif bias is not None:
        bias_elems = bias.numel()
    cid = plan.cid.long()
    classes = [(d, plan.idx[c].numel(), int((cid[idx.long()] == c).sum()),
                a.numel())
               for c, (d, idx, a) in enumerate(zip(plan.class_ds, plan.idx,
                                                   a_tilted))]
    return {"G": plan.G, "rows": plan.rows, "T": plan.T, "esize": esize,
            "cid_bytes": plan.cid.numel() * plan.cid.element_size(),
            "pass_rows": plan.pass_rows.numel(), "bias_elems": bias_elems,
            "src": src, "classes": classes}


def sweep_bound_counts(c: dict) -> dict:
    """:func:`sweep_bound` from :func:`sweep_counts`' numbers."""
    esize, T = c["esize"], c["T"]
    K = 2**T
    nbytes = 2 * c["G"] * c["rows"] * K * K * esize + c["cid_bytes"] \
        + 4 * c["pass_rows"] + c["bias_elems"] * esize + 4 * c["src"]
    flops = 0
    for d, entries, live, a_elems in c["classes"]:
        flops += 2 * live * _dp_fmas(d, T)
        nbytes += 4 * entries * (1 + d) + a_elems * esize
    rate = F64_FLOPS_PER_S if esize == 8 else ALU_OPS_PER_S
    b = _bound(nbytes, flops, rate)
    return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "bytes": nbytes, "flops": flops,
            "live_members": [cl[2] for cl in c["classes"]]}


def sweep_bound(plan, a_tilted, bias) -> dict:
    """The least time one BDCM sweep (K3′) can take: the larger of

    - bytes over HBM bandwidth: chi read once and written once, the int32
      tables (every member's output row and in-edges), the int16 class ids,
      the rows in no class, the bias (and the node form's source table) and
      the factors, each once;
    - FMAs (2 flops each) of the members that compute (padding members
      compute nothing) over the dtype's non-tensor rate: per member the
      flat-shift DP and the contraction (:func:`contract_bound`'s count).
    """
    return sweep_bound_counts(sweep_counts(plan, a_tilted, bias))


def kb_bound(n: int, W: int, deg) -> dict:
    """KB's least time for one step over rows of degrees ``deg`` in an
    ``n``-row state: the larger of the bytes (each input read once and each
    output written once: the rows' own words in and out, their ``Σdeg``
    neighbour indices and their degrees; the neighbour rows are served from
    L2, where the state at the bench shape, 12.8 MB, sits) over HBM's rate,
    and the logic the step needs (:func:`majority_ops`, for this run's
    degrees) over the INT32 rate."""
    deg = np.asarray(deg, np.int64)
    rows, sum_deg = deg.size, int(deg.sum())
    bytes_ = 2 * 4 * W * rows + 4 * sum_deg + 4 * rows
    ops = majority_ops(W, deg)
    b = _bound(bytes_, ops, INT32_OPS_PER_S)
    return {"bytes": bytes_, "ops": ops, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"]}


# ---------------------------------------------------------------------------
# obscheck
# ---------------------------------------------------------------------------


def packed_bytes_per_update(d: int) -> float:
    """Streaming bytes per spin update of the packed step (the word width
    cancels: ``(d·4W + 4W) / 32W``)."""
    return (d + 1) / 8.0


def bdcm_bytes_per_edge_sweep(d: int, T: int) -> float:
    """Traffic per directed edge per sweep of the BDCM sweep (the module
    docstring's DP-lattice model)."""
    K = 2 ** T
    M = (d + 1) ** T
    return 4.0 * (d * (K + 1) * K * M + K * K * M + (d + 2) * K * K)


def host_stream_bandwidth(nbytes: int = 1 << 26, iters: int = 3) -> float:
    """Measured host copy bandwidth (read+write B/s, best of ``iters``): the
    roof of the host proxy."""
    src = np.ones(nbytes // 8, np.float64)
    dst = np.empty_like(src)
    best = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        dt = time.perf_counter() - t0
        best = max(best, 2 * nbytes / max(dt, 1e-9))
    return best


class RooflineRow(NamedTuple):
    program: str
    measured: float         # updates/s (packed) or edge-sweeps/s (BDCM)
    model: float            # roof / bytes per unit
    frac: float             # measured / model
    lo: float
    hi: float
    unit: str
    anchor: str = ""        # "chip:<kind>" or "host-proxy"
    device: str = ""        # the CUDA device name, or "cpu"

    @property
    def ok(self) -> bool:
        return self.lo <= self.frac <= self.hi


def _row(program: str, measured: float, model: float, unit: str,
         bands: dict | None = None) -> RooflineRow:
    lo, hi = (bands or BANDS)[program]
    return RooflineRow(program, measured, model,
                       measured / model if model else 0.0, lo, hi, unit)


def _drain(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_packed(bw: float, *, device, n: int = 32768, d: int = 3,
                   W: int = 8, steps: int = 8, iters: int = 3,
                   bands: dict | None = None) -> RooflineRow:
    """The packed rollout (K1/K2′ on the card) at a smoke shape."""
    import torch

    from graphdyn_torch import obs
    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.ops.packed import packed_rollout

    g = random_regular_graph(n, d, seed=0)
    nbr = torch.as_tensor(g.nbr, device=device)
    deg = torch.as_tensor(g.deg, device=device)
    rng = np.random.default_rng(0)
    sp = torch.as_tensor(rng.integers(0, 2 ** 32, (n, W), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32), device=device)
    sp = packed_rollout(nbr, deg, sp, steps)
    _drain(device)
    with obs.timed("obs.roofline.packed_rollout", n=n, d=d, W=W) as sw:
        for _ in range(iters):
            sp = packed_rollout(nbr, deg, sp, steps)
        _drain(device)
    rate = n * W * 32 * steps * iters / sw.wall_s
    return _row("packed_rollout", rate, bw / packed_bytes_per_update(d),
                "spin-updates/s", bands)


def bdcm_instance(n: int, c: float, seed: int):
    """``(BDCMData, n, n_iso)`` of the isolate-free ER(n, c/(n-1)) instance
    at p = c = 1 (the obscheck and memcheck smoke cells)."""
    from graphdyn_torch.graphs import erdos_renyi_graph, remove_isolates
    from graphdyn_torch.ops.bdcm import BDCMData

    g = erdos_renyi_graph(n, c / (n - 1), seed=seed)
    sub, n_iso = remove_isolates(g)
    return BDCMData(sub, p=1, c=1), n, n_iso


def _bdcm_model_rate(data, bw: float) -> float:
    """Model edge-sweeps/s: the roof over the class-population-weighted
    per-edge bytes."""
    total = sum(len(ec.idx) * bdcm_bytes_per_edge_sweep(ec.d, data.T)
                for ec in data.edge_classes)
    return bw / (total / max(data.num_directed, 1))


def measure_bdcm(bw: float, *, device, n: int = 2048, c: float = 3.0,
                 sweeps: int = 20, bands: dict | None = None) -> RooflineRow:
    """The serial BDCM sweep (K3′ on the card) on a smoke ER instance."""
    from graphdyn_torch import obs
    from graphdyn_torch.ops.bdcm import make_sweep

    data, _, _ = bdcm_instance(n, c, seed=1)
    sweep = make_sweep(data, damp=0.1, device=device)
    chi = data.init_messages(0).to(device)
    chi = sweep(chi, 0.3)
    _drain(device)
    with obs.timed("obs.roofline.bdcm_sweep", twoE=data.num_directed) as sw:
        for _ in range(sweeps):
            chi = sweep(chi, 0.3)
        _drain(device)
    rate = data.num_directed * sweeps / sw.wall_s
    return _row("bdcm_sweep", rate, _bdcm_model_rate(data, bw),
                "edge-sweeps/s", bands)


def entropy_smoke(*, device, n: int = 1024, c: float = 3.0, G: int = 4,
                  chunks: int = 2):
    """Run the grouped entropy smoke program (``EntropyCellExec`` at G
    cells, λ = 0.3 on every lane) for ``chunks`` chunks after one warm
    chunk; returns ``(ex, cells, work, seconds)``: the edge-sweeps the timed
    chunks did (each cell's real edges times its sweeps) and their wall
    time. The memcheck rows measure the same program."""
    import torch

    from graphdyn_torch import obs
    from graphdyn_torch.config import DynamicsConfig, EntropyConfig
    from graphdyn_torch.pipeline.entropy_group import EntropyCellExec

    cfg = EntropyConfig(dynamics=DynamicsConfig(p=1, c=1), eps=0.0,
                        max_sweeps=10 ** 9, damp=0.1)
    cells = [bdcm_instance(n, c, seed=10 + k) for k in range(G)]
    ex = EntropyCellExec(cells, cfg, group_size=G, device=device)
    chi = ex.stack_chi([cell[0].init_messages(k)
                        for k, cell in enumerate(cells)])
    a_t = ex.factors([0.3] * G)
    active = torch.ones(G, dtype=torch.bool, device=device)

    def fresh():
        return (torch.full((G,), torch.inf, dtype=ex.dtype, device=device),
                torch.zeros(G, dtype=torch.int32, device=device))

    delta, t = fresh()
    chi, delta, t = ex.fixed_point_chunk(chi, a_t, active, delta, t)  # warm
    _drain(device)
    delta, t = fresh()
    with obs.timed("obs.roofline.entropy_cell_chunk", G=G,
                   twoE_max=int(chi.shape[1])) as sw:
        for _ in range(chunks):
            chi, delta, t = ex.fixed_point_chunk(chi, a_t, active, delta, t)
        t_h = t.cpu().numpy()
    # pad rows past a cell's own 2E are inert and do not count as work
    work = float(np.sum(np.asarray(ex.stk.twoE)[:G] * t_h))
    return ex, cells, work, sw.wall_s


def measure_entropy_chunk(bw: float, *, device, n: int = 1024,
                          c: float = 3.0, G: int = 4, chunks: int = 2,
                          bands: dict | None = None) -> RooflineRow:
    """The grouped entropy cell chunk at a smoke cell group: the program
    the grouped ``entropy_grid`` runs."""
    _, cells, work, wall = entropy_smoke(device=device, n=n, c=c, G=G,
                                         chunks=chunks)
    return _row("entropy_cell_chunk", work / wall,
                _bdcm_model_rate(cells[0][0], bw), "edge-sweeps/s", bands)


def run_obscheck(*, diag=None, device=None) -> list[RooflineRow]:
    """Measure every headline program against its band on ``device``
    (default the card; the host proxy only for ``device="cpu"``); one
    ``obs.roofline.<program>`` gauge per row when recording. Returns the
    rows, each naming its device and anchor; callers gate on ``row.ok``.
    Raises ``RuntimeError`` with no card (unless ``device="cpu"``) and
    ``LookupError`` on a card with no profile in :data:`CHIP_BANDS`."""
    import torch

    from graphdyn_torch import obs
    from graphdyn_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        chip = chip_profile(name)
        if chip is None:
            obs.gauge("obs.roofline.uncalibrated", 1, device_name=name)
            raise LookupError(
                f"obscheck: card {name!r} has no committed profile "
                "(CHIP_BANDS); seed bands for this part from a measured run")
        kind, bw, bands = chip
        anchor = f"chip:{kind}"
        if diag:
            diag(f"obscheck: chip roofline {kind} ({name}): HBM "
                 f"{bw / 1e9:.0f} GB/s (committed anchor)")
    else:
        name, bands, anchor = "cpu", None, "host-proxy"
        bw = host_stream_bandwidth()
        if diag:
            diag(f"obscheck: host proxy (device cpu): host stream bandwidth "
                 f"{bw / 1e9:.2f} GB/s")
    shapes = SMOKE[dev.type]
    rows = [measure_packed(bw, device=dev, bands=bands, **shapes["packed"]),
            measure_bdcm(bw, device=dev, bands=bands, **shapes["bdcm"]),
            measure_entropy_chunk(bw, device=dev, bands=bands,
                                  **shapes["entropy"])]
    rows = [row._replace(anchor=anchor, device=name) for row in rows]
    for row in rows:
        obs.gauge(f"obs.roofline.{row.program}", row.measured,
                  model=row.model, frac=row.frac, unit=row.unit,
                  ok=row.ok, anchor=anchor, device_name=name)
        if diag:
            verdict = "ok" if row.ok else "OUT OF BAND"
            diag(f"obscheck: {row.program}: measured {row.measured:.3e} "
                 f"{row.unit}, model {row.model:.3e} → frac {row.frac:.3f} "
                 f"(band [{row.lo:g}, {row.hi:g}]) {verdict}")
    return rows
