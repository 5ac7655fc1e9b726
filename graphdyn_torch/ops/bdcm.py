"""BDCM message passing: the sweep half of ``graphdyn/ops/bdcm.py`` and the
plain half of ``graphdyn/ops/pallas_bdcm.py``.

- chi lives as ``[2E, K, K]`` (``chi[e, x_src, x_dst]``, K = 2^T) in the
  message dtype (float32 or float64).
- The neighbor DP is a product of shift-convolutions on the ρ-lattice
  (:func:`_neighbor_dp`, the roll form of the JAX package's XLA path, and
  the flat mixed-radix shift of its Pallas kernel, :func:`_flat_offsets`).
- One edge-degree class of G instances is updated by
  :func:`dp_contract_grouped`: the DP, the contraction against the tilted
  factor ``A_tilted = A·exp(−λ·x_i(0))``, the ε-clamp, the normalisation by
  ``1/max(z, tiny)`` and the damping. On a CUDA tensor it launches the
  hand-written kernel (:mod:`graphdyn_torch.ops.bdcm_cuda`,
  ``csrc/bdcm_contract.cu``); on a CPU tensor it runs the plain PyTorch
  version :func:`dp_contract_grouped_plain`, the twin of the Pallas kernel
  ``_dp_contract_kernel``. ``class_update`` is the twin of the JAX package's
  XLA class update (a division by z after the contraction), kept for tests.
- The sweep (:func:`make_sweep`, :func:`_sweep_core`) updates the classes
  Gauss-Seidel style in class order, over a leading group axis, so the
  grouped HPr executor and the single sweep run the same code. On a CUDA
  tensor a whole sweep is one launch of the sweep kernel
  (:mod:`graphdyn_torch.ops.bdcm_sweep`, ``csrc/bdcm_sweep.cu``: every
  class, its gathers, bias and mask inside the kernel); on a CPU tensor it
  runs the plain route, one gather, :func:`dp_contract_grouped_plain` and
  one ``index_copy_`` per class. :func:`dp_contract_grouped` with the
  per-class kernel stays as the counterpart of the JAX package's public
  function and is off the main paths.

Kernel selection (``kernel=``): ``'auto'`` takes the CUDA kernels for CUDA
tensors and the plain versions for CPU tensors; ``'cuda'`` requires the
kernel (CPU tensors raise); ``'plain'`` runs the plain version anywhere (a
test mode). On CUDA tensors every class with 1 ≤ T ≤ 6 runs on a kernel
path at any degree (register, block, or the global-lattice path for
lattices beyond a block's shared memory), where the JAX package places the
classes outside its Pallas regime (T ≤ 4, d ≤ 8) on XLA; a class the
kernel's admission gate (:func:`graphdyn_torch.ops.bdcm_cuda.
bdcm_kernel_supported`) refuses — T ≥ 7, or a factor too large for the
card — raises under ``'auto'`` as under ``'cuda'``, and a failed build or
launch raises: the JAX package's runtime fallback
(``pallas_fallback_spec``/``resilient_exec``) has no counterpart.

The entropy half: the closed-form leaf messages (:func:`make_leaf_setter`),
the edge and node partition functions, the free entropy φ and the m_init
observables (:func:`make_free_entropy`, :func:`make_mean_m_init`), the
chunked fixed point (:func:`fixed_point_sweeps`, :func:`make_fixed_point`:
masked sweeps with the delta on the device and one host read per chunk),
the congruent ensemble (:class:`EnsembleBDCM` and its makers, the ensemble
as the kernel's group axis) and the ragged cell stack
(:class:`StackedBDCM`). The tilt ``exp(−λ·x_i(0))`` and the leaf message
are computed on the host at a fixed size per λ (:func:`tilt_vector`), so a
cell's factor has the same bits in any group and on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.attractors import (
    attr_mask,
    edge_factor_tensor,
    leaf_factor_tensor,
    node_factor_tensor,
    trajectories01,
    x0_pm,
)
from graphdyn_torch.graphs import (
    EdgeTables,
    Graph,
    _rep_ids_device,
    build_edge_tables,
    degree_classes,
    replicate_disjoint_device,
    replicate_edge_tables_device,
)
from graphdyn_torch.ops import bdcm_sweep
from graphdyn_torch.ops.bdcm_sweep import NodeBias
from graphdyn_torch.ops.packed import _row_chunk
from graphdyn_torch.utils.platform import resolve_device

KERNELS = ("auto", "cuda", "plain")
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def as_dtype(dtype) -> torch.dtype:
    """``'float32'``/``'float64'`` or a torch float dtype -> the torch
    dtype; anything else raises."""
    dt = _DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"BDCM dtype must be float32 or float64, got {dtype!r}")
    return dt


class _EdgeClass(NamedTuple):
    d: int
    idx: np.ndarray        # [Ed] directed edge ids
    in_edges: np.ndarray   # [Ed, d] incoming directed edge ids
    A: np.ndarray          # [K, K, (d+1)^T] λ=0 factor


class _NodeClass(NamedTuple):
    d: int
    idx: np.ndarray        # [Nd] node ids
    in_edges: np.ndarray   # [Nd, d]
    Ai: np.ndarray         # [K, (d+1)^T]


def _pad_class(idx: np.ndarray, in_edges: np.ndarray, bucket: int, ghost_idx: int, ghost_in: int):
    """Pad a degree class to the next multiple of ``bucket``: padded members
    scatter to the ghost slot ``ghost_idx`` and gather from the ghost message
    row ``ghost_in`` (both sliced away by the sweep)."""
    pad = (-idx.shape[0]) % bucket
    if pad == 0:
        return idx, in_edges
    idx = np.concatenate([idx, np.full(pad, ghost_idx, idx.dtype)])
    in_edges = np.concatenate(
        [in_edges, np.full((pad, in_edges.shape[1]), ghost_in, in_edges.dtype)]
    )
    return idx, in_edges


class BDCMData:
    """Per-graph static data for the BDCM sweep (host-built numpy tables;
    the device union of :func:`replicate_bdcm_device` holds torch tensors).

    ``class_bucket``: round every degree-class size up to a multiple of this
    (padding with ghost edges/nodes), as in the JAX package. ``dtype``:
    ``'float32'`` or ``'float64'`` (the reference's precision), the dtype of
    the messages and of the factor tensors once on a device.
    """

    def __init__(
        self,
        graph: Graph,
        tables: EdgeTables | None = None,
        *,
        p: int = 1,
        c: int = 1,
        attr_value: int = 1,
        rule: str = "majority",
        tie: str = "stay",
        class_bucket: int | None = None,
        dtype="float32",
    ):
        self.dtype = as_dtype(dtype)
        tables = tables or build_edge_tables(graph)
        self.graph = graph
        self.tables = tables
        self.p, self.c = p, c
        self.T = p + c
        self.K = 2**self.T
        self.attr_value = attr_value
        self.rule, self.tie = rule, tie
        self.padded = class_bucket is not None

        self.valid = attr_mask(self.T, attr_value)          # bool[K]
        self.x0 = x0_pm(self.T)                             # ±1[K]
        self.leaf01 = leaf_factor_tensor(p, c, attr_value, rule, tie)  # [K,K]

        ghost_edge = tables.num_directed                    # row 2E of chi_ext

        eclasses = degree_classes(tables.edge_deg)
        self.leaf_idx = eclasses.get(0, np.empty(0, np.int32))
        self.edge_classes: list[_EdgeClass] = []
        for d, idx in sorted(eclasses.items()):
            if d == 0:
                continue
            in_edges = tables.in_edges[idx, :d]
            if self.padded:
                idx, in_edges = _pad_class(
                    idx, in_edges, class_bucket, ghost_edge, ghost_edge
                )
            self.edge_classes.append(
                _EdgeClass(
                    d=int(d),
                    idx=idx,
                    in_edges=in_edges,
                    A=edge_factor_tensor(d, p, c, attr_value, rule, tie),
                )
            )

        nclasses = degree_classes(graph.deg)
        self.node_classes: list[_NodeClass] = []
        for d, idx in sorted(nclasses.items()):
            if d == 0:
                continue
            in_edges = tables.node_in_edges[idx, :d]
            if self.padded:
                idx, in_edges = _pad_class(
                    idx, in_edges, class_bucket, graph.n, ghost_edge
                )
            self.node_classes.append(
                _NodeClass(
                    d=int(d),
                    idx=idx,
                    in_edges=in_edges,
                    Ai=node_factor_tensor(d, p, c, attr_value, rule, tie),
                )
            )

        self.num_directed = tables.num_directed
        self.num_edges = tables.num_edges
        self.n = graph.n

    @property
    def np_dtype(self):
        return np.float32 if self.dtype == torch.float32 else np.float64

    def init_messages(self, seed=0) -> torch.Tensor:
        """Random row-normalized chi (`ipynb:509-511`, `HPR:101-103`), the
        JAX package's numpy draw bit for bit, as a CPU tensor of the
        message dtype. ``seed`` may be an int or a ``np.random.Generator``
        (shared stream)."""
        rng = np.random.default_rng(seed)
        chi = rng.random((self.num_directed, self.K, self.K))
        chi /= chi.sum(axis=(1, 2), keepdims=True)
        return torch.from_numpy(chi.astype(self.np_dtype))


def replicate_bdcm_device(base: BDCMData, R: int, device) -> BDCMData:
    """R-replica disjoint-union ``BDCMData`` in the replica-major layout
    (:func:`graphdyn_torch.graphs.replicate_edge_tables`), with every
    union-sized table built on ``device`` by offset-tiling the base graph's
    host tables (:func:`graphdyn_torch.graphs._rep_ids_device`): only the
    base tables cross the host link. The degree-class structure of a
    disjoint union of R copies is the base structure tiled."""
    import copy

    g, t = base.graph, base.tables
    n, twoE = g.n, t.num_directed
    ghost, ghost_u = twoE, R * twoE

    def rep(ids, period, gh, gh_u):
        return _rep_ids_device(ids, R, period, gh, gh_u, device)

    u = copy.copy(base)
    u.graph = replicate_disjoint_device(g, R, device)
    u.tables = replicate_edge_tables_device(t, R, n, device)
    u.leaf_idx = rep(base.leaf_idx, twoE, ghost, ghost_u)
    u.edge_classes = [
        _EdgeClass(d=cls.d, idx=rep(cls.idx, twoE, ghost, ghost_u),
                   in_edges=rep(cls.in_edges, twoE, ghost, ghost_u), A=cls.A)
        for cls in base.edge_classes
    ]
    u.node_classes = [
        _NodeClass(d=cls.d, idx=rep(cls.idx, n, g.n, R * g.n),
                   in_edges=rep(cls.in_edges, twoE, ghost, ghost_u),
                   Ai=cls.Ai)
        for cls in base.node_classes
    ]
    u.num_directed = R * twoE
    u.num_edges = R * t.num_edges
    u.n = R * n
    return u


# ---------------------------------------------------------------------------
# the class update: XLA twin (class_update) and kernel twin (plain DP)
# ---------------------------------------------------------------------------


def _neighbor_dp(chi_in: torch.Tensor, d: int, T: int, K: int) -> torch.Tensor:
    """ρ-lattice DP: LL[e, x_i, ρ] = Σ over assignments of the d incoming
    source trajectories of Π_D chi_in[e, D, x_k(D), x_i] with ρ = Σ x_k.

    ``chi_in``: [E, d, K, K] indexed [edge, slot, x_src, x_dst].
    Returns [E, K, (d+1)^T] (flattened lattice, mixed-radix row-major).
    The shifts are rolls over the T lattice axes; they never wrap nonzero
    mass (after D steps every coordinate is ≤ D < d+1)."""
    X01 = trajectories01(T)
    Ed = chi_in.shape[0]
    lat_axes = tuple(range(2, 2 + T))
    LL = torch.zeros((Ed, K) + (d + 1,) * T, dtype=chi_in.dtype,
                     device=chi_in.device)
    LL[(slice(None), slice(None)) + (0,) * T] = 1.0
    for D in range(d):
        acc = torch.zeros_like(LL)
        for k_idx in range(K):
            shift = tuple(int(b) for b in X01[k_idx])
            shifted = torch.roll(LL, shift, lat_axes) if any(shift) else LL
            w = chi_in[:, D, k_idx, :]
            acc = acc + shifted * w[(...,) + (None,) * T]
        LL = acc
    return LL.reshape(Ed, K, -1)


def _contract(a: torch.Tensor, LL: torch.Tensor) -> torch.Tensor:
    """chi2[..., xi, xj] = Σ_m a[..., xi, xj, m]·LL[..., xi, m], as an
    elementwise product and a sum over the fixed last axis (no BLAS call,
    whose blocking could depend on the batch extent)."""
    return (a * LL[..., :, None, :]).sum(dim=-1)


def class_update(chi_in, A, tilt, chi_old, *, d, T, K, damp, eps_clamp):
    """The twin of the JAX package's XLA per-degree-class update: neighbor
    DP, factor contraction, λ-tilt, ε-clamp, normalisation by division,
    damping. ``chi_in``: [Ed, d, K, K]; ``A``: [K, K, M]; ``tilt``: [K]."""
    LL = _neighbor_dp(chi_in, d, T, K)                  # [Ed, K, M]
    chi2 = _contract(A[None], LL) * tilt[None, :, None]
    chi2 = torch.clamp_min(chi2, eps_clamp)
    # safe denominator: an empty attractor set yields all-zero messages
    z = chi2.sum(dim=(1, 2), keepdim=True)
    chi2 = chi2 / torch.clamp_min(z, torch.finfo(chi2.dtype).tiny)
    return damp * chi2 + (1.0 - damp) * chi_old


def _flat_offsets(d: int, T: int) -> np.ndarray:
    """off_k for every trajectory k: mixed-radix flat shift on the (d+1)^T
    lattice."""
    X01 = trajectories01(T)                       # [K, T]
    radix = (d + 1) ** np.arange(T - 1, -1, -1)   # [T]
    return (X01 * radix).sum(axis=1).astype(np.int64)


def dp_contract_grouped_plain(chi_in: torch.Tensor, a_tilted: torch.Tensor,
                              chi_old: torch.Tensor, *, d: int, T: int,
                              damp: float, eps_clamp: float = 0.0
                              ) -> torch.Tensor:
    """The plain PyTorch twin of the Pallas kernel ``_dp_contract_kernel``
    (``graphdyn/ops/pallas_bdcm.py:130``) on any device: the flat
    mixed-radix shift DP with ping-pong buffers over the d incoming slots,
    the contraction against ``a_tilted`` (rank 3 ``[K, K, M]`` shared by
    every group, or rank 4 ``[G, K, K, M]`` per group), the ε-clamp, the
    normalisation by ``1/max(z, tiny)`` and the damping.

    ``chi_in``: [G, Ed, d, K, K]; ``chi_old``: [G, Ed, K, K]; returns
    [G, Ed, K, K] in ``chi_in``'s dtype. Rows are processed in chunks whose
    temporaries stay within 256 MB; every op is elementwise or a reduction
    over a fixed trailing axis, so a row's result does not depend on G, Ed
    or the chunk."""
    G, Ed = chi_in.shape[0], chi_in.shape[1]
    K, M = 2**T, (d + 1) ** T
    dtype = chi_in.dtype
    offs = [int(o) for o in _flat_offsets(d, T)]
    a = a_tilted.to(dtype)
    a = a[:, None] if a.ndim == 4 else a[None, None]    # [G|1, 1, K, K, M]
    tiny = torch.finfo(dtype).tiny
    out = torch.empty((G, Ed, K, K), dtype=dtype, device=chi_in.device)
    rows = _row_chunk(G * chi_in.element_size() * (2 * K * M + 2 * K * K * M))
    for e0 in range(0, Ed, rows):
        ci = chi_in[:, e0:e0 + rows]
        LL = torch.zeros(ci.shape[:2] + (K, M), dtype=dtype, device=ci.device)
        LL[..., 0] = 1.0
        for D in range(d):
            acc = torch.zeros_like(LL)
            for k in range(K):
                off = offs[k]
                w = ci[:, :, D, k, :, None]                  # [G, r, K, 1]
                if off == 0:
                    acc += LL * w
                else:
                    acc[..., off:] += LL[..., :M - off] * w
            LL = acc
        chi2 = torch.clamp_min(_contract(a, LL), eps_clamp)   # [G, r, K, K]
        z = chi2.sum(dim=(2, 3), keepdim=True)
        inv = 1.0 / torch.clamp_min(z, tiny)
        out[:, e0:e0 + rows] = (damp * chi2 * inv
                                + (1.0 - damp) * chi_old[:, e0:e0 + rows])
    return out


def class_mode(d: int, T: int, dtype, kernel: str, device) -> str:
    """The sweep core of one edge class: ``'cuda'`` (the kernel) or
    ``'plain'``, from ``kernel`` and the device type of the tensors.
    Raises for ``'cuda'`` on a non-CUDA device, and on a CUDA device for a
    class the kernel's gate refuses, under ``'auto'`` as under ``'cuda'``."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    dev = torch.device(device).type
    if kernel == "plain" or (kernel == "auto" and dev == "cpu"):
        return "plain"
    if dev != "cuda":
        raise ValueError(
            f"kernel={kernel!r} launches the CUDA BDCM kernel; the tensors "
            f"are on {device}"
        )
    from graphdyn_torch.ops import bdcm_cuda

    if not bdcm_cuda.bdcm_kernel_supported(d, T, dtype):
        raise ValueError(
            f"the CUDA BDCM kernel refuses the class d={d}, T={T}, "
            f"dtype={dtype} ({bdcm_cuda.refusal_reason(d, T, dtype)})"
        )
    return "cuda"


def dp_contract_grouped(chi_in: torch.Tensor, a_tilted: torch.Tensor,
                        chi_old: torch.Tensor, *, d: int, T: int,
                        damp: float, eps_clamp: float = 0.0,
                        kernel: str = "auto") -> torch.Tensor:
    """DP + contraction + normalise + damp for one edge-degree class of G
    instances, the counterpart of ``graphdyn.ops.pallas_bdcm.
    dp_contract_grouped`` (the group axis is the kernel grid's second
    dimension). ``a_tilted``'s rank selects the shared (3) or per-group (4)
    variant. See the module docstring for ``kernel``. Returns
    [G, Ed, K, K]."""
    mode = class_mode(d, T, chi_in.dtype, kernel, chi_in.device)
    if mode == "plain":
        return dp_contract_grouped_plain(chi_in, a_tilted, chi_old, d=d, T=T,
                                         damp=damp, eps_clamp=eps_clamp)
    from graphdyn_torch.ops import bdcm_cuda

    return bdcm_cuda.dp_contract_cuda(chi_in, a_tilted, chi_old, d=d, T=T,
                                      damp=damp, eps_clamp=eps_clamp)


def dp_contract(chi_in, a_tilted, chi_old, *, d: int, T: int, damp: float,
                eps_clamp: float = 0.0, kernel: str = "auto") -> torch.Tensor:
    """One class of one instance: the G=1 instance of
    :func:`dp_contract_grouped` (shared ``a_tilted``). ``chi_in``:
    [Ed, d, K, K]; returns [Ed, K, K]."""
    return dp_contract_grouped(chi_in[None], a_tilted, chi_old[None], d=d,
                               T=T, damp=damp, eps_clamp=eps_clamp,
                               kernel=kernel)[0]


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


class _SweepSpec(NamedTuple):
    """Static configuration of one sweep: the JAX package's ``_SweepSpec``
    with a per-class mode tuple (``'cuda'`` or ``'plain'``) in place of its
    Pallas modes."""

    T: int
    K: int
    damp: float
    eps_clamp: float
    mask_invalid_src: bool
    with_bias: bool
    padded: bool
    class_ds: tuple          # per-class neighbor count d
    modes: tuple             # per-class 'cuda' | 'plain'


def resolve_modes(class_ds, *, T: int, dtype, kernel: str, device) -> tuple:
    """Per-class modes of a sweep (:func:`class_mode` for each class)."""
    return tuple(class_mode(int(d), T, dtype, kernel, device)
                 for d in class_ds)


def _long(t, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(t) if isinstance(t, np.ndarray) else t,
                           device=device).to(torch.int64)


def _flat_ids(tabs, rows: int, device) -> torch.Tensor:
    """Stack G per-member id tables into one int64 tensor of ids into the
    ``[G·rows]`` flattening of a ``[G, rows, ...]`` tensor (member g's ids
    offset by ``g·rows``)."""
    t = torch.stack([_long(x, device) for x in tabs])
    off = torch.arange(t.shape[0], dtype=torch.int64, device=device) * rows
    return t + off.reshape((-1,) + (1,) * (t.ndim - 1))


class SweepTables(NamedTuple):
    """The plain route's tables: per class ``(idx [G, Ed], in_edges [G, Ed,
    d])`` int64 ids into the ``[G·rows]`` rows, and for a node-level bias
    (:class:`~graphdyn_torch.ops.bdcm_sweep.NodeBias`) each row's source
    node (int64 [G·rows], ids into the [G·n] nodes) and which source
    trajectories start at +1 (bool [K]); None without one."""

    classes: list
    src: torch.Tensor | None
    sel_plus: torch.Tensor | None


def sweep_tables(tables, spec: _SweepSpec, *, G: int, rows: int, valid,
                 src=None):
    """The tables a sweep's route reads, built once where a sweep is made
    from its int64 class tables (on their device): the kernel's
    :class:`~graphdyn_torch.ops.bdcm_sweep.SweepPlan` when the classes run
    on CUDA (int32 copies, class ids, the rows in no class), else
    :class:`SweepTables`. ``src``: int64 [G·rows] source node of each row,
    for a node-level bias."""
    if "cuda" in spec.modes:
        return bdcm_sweep.build_plan(
            tables, G=G, rows=rows, T=spec.T, dtype=valid.dtype,
            padded=spec.padded, masked=spec.mask_invalid_src, valid=valid,
            src=src)
    sel = None if src is None else torch.as_tensor(x0_pm(spec.T) == 1,
                                                   device=src.device)
    return SweepTables(list(tables), src, sel)


def _sweep_core(chi: torch.Tensor, a_tilted, bias, valid, tables,
                spec: _SweepSpec) -> torch.Tensor:
    """One Gauss-Seidel sweep over a group of G instances.

    ``chi``: [G, rows, K, K] (with the ghost row already appended when the
    classes are padded); ``a_tilted``: per class ``[K, K, M]`` or ``[G, K,
    K, M]``; ``bias``: None, per-row weights [G, rows, K], or a
    :class:`~graphdyn_torch.ops.bdcm_sweep.NodeBias` read through the
    tables' source-node table; ``valid``: [K] (used with
    ``mask_invalid_src``); ``tables``: :func:`sweep_tables`. Classes on CUDA
    run as one launch of the sweep kernel; otherwise the plain route runs.
    Returns a new [G, rows, K, K] tensor; ``chi`` is not written."""
    if "cuda" in spec.modes:
        return bdcm_sweep.sweep_cuda(chi, a_tilted, bias, tables,
                                     damp=spec.damp, eps_clamp=spec.eps_clamp)
    G, rows, K = chi.shape[0], chi.shape[1], spec.K
    new = chi.reshape(G * rows, K, K).clone()
    if isinstance(bias, NodeBias):
        b = bias.values
        bias = torch.where(tables.sel_plus, b[tables.src, 0, None],
                           b[tables.src, 1, None])
    elif bias is not None:
        bias = bias.reshape(G * rows, K)
    for (d, mode), a, (idx, in_edges) in zip(
        zip(spec.class_ds, spec.modes), a_tilted, tables.classes
    ):
        chi_in = new[in_edges]                             # [G, Ed, d, K, K]
        if bias is not None:
            chi_in *= bias[in_edges][..., None]
        if spec.mask_invalid_src:
            chi_in *= valid[:, None]
        upd = dp_contract_grouped(chi_in, a, new[idx], d=d, T=spec.T,
                                  damp=spec.damp, eps_clamp=spec.eps_clamp,
                                  kernel=mode)
        del chi_in
        new.index_copy_(0, idx.reshape(-1), upd.reshape(-1, K, K))
    return new.reshape(G, rows, K, K)


def tilted_factors(As, x0: torch.Tensor, lmbd) -> list:
    """``A·exp(−λ·x_i(0))`` per class (the tilt folded into the factor, as
    the JAX package's kernel path does), in ``x0``'s dtype and device."""
    tilt = torch.exp(-lmbd * x0)
    return [A * tilt[:, None, None] for A in As]


def make_sweep(
    data: BDCMData,
    *,
    damp: float,
    eps_clamp: float = 0.0,
    mask_invalid_src: bool = True,
    with_bias: bool = False,
    kernel: str = "auto",
    device=None,
):
    """Build the BDCM sweep ``(chi, lmbd[, bias_edge]) -> chi'`` for chi
    ``[2E, K, K]`` on ``device`` (default CUDA; raises on a CUDA-less host
    unless given ``device='cpu'``).

    ``bias_edge``: [2E, K] multiplicative weight on each message when
    consumed (the HPr reinforcement bias ``b_k(x_k(0))`` gathered to edge
    shape, `HPR_pytorch_RRG.py:128-133,188`); or, by keyword, ``biases``:
    the node biases [n, 2] themselves, read through each edge's source node
    (no [2E, K] tensor is built on CUDA). ``mask_invalid_src`` zeroes
    invalid-endpoint source trajectories (the entropy variant; HPr leaves
    them to decay). The modes of the classes are resolved here (see the
    module docstring) and kept in ``sweep.spec``; the route's tables
    (:func:`sweep_tables`), the λ=0 factors and the validity mask in
    ``sweep.args``."""
    dev = resolve_device(device)
    dt = data.dtype
    K = data.K
    rows = data.num_directed + (1 if data.padded else 0)
    spec = _SweepSpec(
        T=data.T, K=K, damp=float(damp), eps_clamp=float(eps_clamp),
        mask_invalid_src=bool(mask_invalid_src), with_bias=bool(with_bias),
        padded=data.padded,
        class_ds=tuple(cls.d for cls in data.edge_classes),
        modes=resolve_modes([cls.d for cls in data.edge_classes], T=data.T,
                            dtype=dt, kernel=kernel, device=dev),
    )
    valid = torch.as_tensor(data.valid, dtype=dt, device=dev)
    src = None
    if with_bias:
        # each row's source node; the ghost row's (never read by a real
        # member) is node 0
        src = _long(data.tables.src, dev)
        if data.padded:
            src = torch.cat([src, src.new_zeros(1)])
    tables = sweep_tables(
        [(_flat_ids([cls.idx], rows, dev), _flat_ids([cls.in_edges], rows, dev))
         for cls in data.edge_classes], spec, G=1, rows=rows, valid=valid,
        src=src)
    As = [torch.as_tensor(cls.A, dtype=dt, device=dev)
          for cls in data.edge_classes]
    x0 = torch.as_tensor(data.x0, dtype=dt, device=dev)

    def sweep(chi, lmbd, bias_edge=None, *, biases=None):
        if with_bias and (bias_edge is None) == (biases is None):
            raise ValueError("this sweep was built with_bias=True: pass "
                             "bias_edge or biases")
        n_real = chi.shape[0]
        if spec.padded:
            # ghost row 2E: gathered by padded class members only; their
            # updates scatter back to it and are sliced off
            chi = torch.cat([chi, torch.full((1, K, K), 1.0 / (K * K),
                                             dtype=chi.dtype,
                                             device=chi.device)])
            if bias_edge is not None:
                bias_edge = torch.cat([bias_edge, bias_edge.new_ones(1, K)])
        if not with_bias:
            bias = None
        elif biases is not None:
            bias = NodeBias(biases)
        else:
            bias = bias_edge[None]
        out = _sweep_core(chi[None], tilted_factors(As, x0, lmbd), bias, valid,
                          tables, spec)[0]
        return out[:n_real]

    sweep.spec = spec
    sweep.args = (tables, As, valid)
    return sweep


def marginals_group(chi: torch.Tensor, rev: torch.Tensor,
                    out_edges: torch.Tensor, sel_plus: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Node marginals of G instances (the HPr marginal computation,
    `HPR_pytorch_RRG.py:147-167`): per directed edge, the pair sums split
    by the source trajectory's initial value, ε-clamped and normalised, then
    multiplied over each node's outgoing edges; ghost slots multiply by 1.

    ``chi``: [G, 2E, K, K]; ``rev``: int64 [G, 2E] ids into the [G·2E]
    flattening; ``out_edges``: int64 [G, n, dmax] ids into the
    [G·(2E+1)] flattening of the ghost-extended pair sums; ``sel_plus``:
    [K] in chi's dtype. Returns [G, n, 2]. The per-edge sums are computed
    in row chunks (temporaries within 256 MB)."""
    G, twoE, K = chi.shape[0], chi.shape[1], chi.shape[2]
    flat = chi.reshape(G * twoE, K, K)
    rev = rev.reshape(-1)
    sel = sel_plus[None, :, None]
    Zp = torch.empty(G * twoE, dtype=chi.dtype, device=chi.device)
    Zm = torch.empty_like(Zp)
    rows = _row_chunk(4 * K * K * chi.element_size())
    for e0 in range(0, G * twoE, rows):
        c = flat[e0:e0 + rows]
        P = c * flat[rev[e0:e0 + rows]].transpose(1, 2)
        Zp[e0:e0 + rows] = (P * sel).sum(dim=(1, 2))
        Zm[e0:e0 + rows] = (P * (1.0 - sel)).sum(dim=(1, 2))
    Zp = torch.clamp_min(Zp, eps)
    Zm = torch.clamp_min(Zm, eps)
    tot = Zp + Zm
    Zp, Zm = Zp / tot, Zm / tot
    ones = Zp.new_ones(G, 1)
    Zp_ext = torch.cat([Zp.reshape(G, twoE), ones], dim=1).reshape(-1)
    Zm_ext = torch.cat([Zm.reshape(G, twoE), ones], dim=1).reshape(-1)
    mp = torch.prod(Zp_ext[out_edges], dim=-1)
    mm = torch.prod(Zm_ext[out_edges], dim=-1)
    marg = torch.stack([mp, mm], dim=-1)
    return marg / marg.sum(dim=-1, keepdim=True)


def marginal_tables(datas, device):
    """``(rev, out_edges, sel_plus)`` of :func:`marginals_group` for the
    instances ``datas`` (one per group member)."""
    twoE = datas[0].num_directed
    rev = _flat_ids([d.tables.rev_map if d.tables.rev_map is not None
                     else d.tables.rev(np.arange(twoE)) for d in datas],
                    twoE, device)
    out = _flat_ids([d.tables.node_out_edges for d in datas], twoE + 1, device)
    sel = torch.as_tensor(datas[0].x0 == 1, dtype=datas[0].dtype,
                          device=device)
    return rev, out, sel


def make_marginals(data: BDCMData, eps: float = 1e-15, device=None):
    """Build ``chi -> marg[n, 2]``: per-node probabilities of x_i(0)=+1
    (col 0) / −1 (col 1), the HPr marginal computation
    (`HPR_pytorch_RRG.py:147-167`), on ``device`` (default CUDA). No
    endpoint-validity mask (faithful to the reference)."""
    dev = resolve_device(device)
    rev, out_edges, sel = marginal_tables([data], dev)

    def marginals(chi):
        return marginals_group(chi[None], rev, out_edges, sel, eps)[0]

    return marginals


# ---------------------------------------------------------------------------
# the entropy half: leaves, partition functions, φ and m_init
# ---------------------------------------------------------------------------


def tilt_vector(lmbd: float, x0: np.ndarray, dtype) -> torch.Tensor:
    """``exp(−λ·x_i(0))`` per trajectory, ``[K]`` in ``dtype`` on the CPU.
    x0 is ±1, so the vector holds ``exp(−λ)`` and ``exp(λ)``: both come from
    one fixed-size exp, so a cell's tilt is the same bits whatever group it
    runs in and on whatever device the sweep runs (a vectorised exp over a
    longer tensor may round a lane differently from the scalar one)."""
    dt = as_dtype(dtype)
    e = torch.exp(torch.tensor([-float(lmbd), float(lmbd)], dtype=dt))
    plus = torch.as_tensor(np.asarray(x0) == 1)
    return torch.where(plus, e[0], e[1])


def leaf_message(lmbd: float, leaf01: np.ndarray, x0: np.ndarray,
                 dtype) -> torch.Tensor:
    """The closed-form message of a leaf edge (d = 0): the λ-tilted bare
    factor, normalised (`ipynb:403-417`), ``[K, K]`` in ``dtype`` on the
    CPU (one fixed-size computation per λ, as :func:`tilt_vector`)."""
    dt = as_dtype(dtype)
    t = torch.as_tensor(leaf01, dtype=dt) * tilt_vector(lmbd, x0, dt)[:, None]
    return t / t.sum()


def make_leaf_setter(data: BDCMData, device=None):
    """``(chi, lmbd) -> chi`` writing the closed-form leaf messages (d = 0
    edges) into a copy of ``chi`` (`ipynb:403-417`); the identity when the
    graph has no leaf edges. ``lmbd`` is a host float."""
    dev = resolve_device(device)
    leaf_idx = _long(data.leaf_idx, dev)

    def set_leaves(chi, lmbd):
        if leaf_idx.numel() == 0:
            return chi
        t = leaf_message(lmbd, data.leaf01, data.x0, data.dtype).to(dev)
        out = chi.clone()
        out[leaf_idx] = t
        return out

    return set_leaves


def _require_halved_layout(data, what: str) -> None:
    """The Z_ij/φ/m_init observables pair forward and reverse messages by
    slicing chi into halves (``chi[:E]``/``chi[E:]``); a permuted edge layout
    (``EdgeTables.rev_map`` set, e.g. the replica-major union tables) breaks
    that pairing."""
    if getattr(data.tables, "rev_map", None) is not None:
        raise ValueError(
            f"{what} requires the canonical [forward | reverse] directed-edge "
            "layout; got permuted tables (rev_map set). Build BDCMData from "
            "build_edge_tables(...) for partition-function observables."
        )


def _mask2(valid: np.ndarray, dtype, device) -> torch.Tensor:
    v = torch.as_tensor(valid, dtype=dtype, device=device)
    return v[:, None] * v[None, :]


def _pair_products(chi: torch.Tensor, mask2: torch.Tensor) -> torch.Tensor:
    """P[..., e, x_u, x_v] = chi[e] · chi[e+E]ᵀ restricted to endpoint-valid
    trajectories, for chi ``[..., 2E, K, K]`` in the halved layout."""
    E = chi.shape[-3] // 2
    return chi[..., :E, :, :] * chi[..., E:, :, :].transpose(-1, -2) * mask2


def edge_partition(chi, mask2, eps_clamp: float) -> torch.Tensor:
    """Z_ij per undirected edge, ``[..., E]`` (`ipynb:146-155`)."""
    return torch.clamp_min(_pair_products(chi, mask2).sum(dim=(-1, -2)),
                           eps_clamp)


def make_edge_partition(data: BDCMData, eps_clamp: float = 0.0, device=None):
    """``chi -> Z_ij[E]``: per-undirected-edge partition function over
    endpoint-valid trajectories only (`ipynb:146-155`)."""
    _require_halved_layout(data, "make_edge_partition")
    mask2 = _mask2(data.valid, data.dtype, resolve_device(device))
    return lambda chi: edge_partition(chi, mask2, float(eps_clamp))


def _node_z(chi_ext, tilt, valid, ntables, T: int, K: int, n_out: int):
    """Z_i before the clamp, ``[n_out]``: per node class, the all-neighbor
    DP of the valid-masked incoming messages against ``Ai``, tilted by x_i's
    initial value. ``ntables``: per class ``(d, idx, in_edges, Ai)`` on the
    device; ``chi_ext`` carries the ghost row when classes are padded."""
    out = chi_ext.new_zeros(n_out)
    for d, idx, in_edges, Ai in ntables:
        chi_in = chi_ext[in_edges] * valid[:, None]
        LL = _neighbor_dp(chi_in, d, T, K)                 # [Nd, K, M]
        z = ((Ai[None] * LL).sum(dim=-1) * tilt).sum(dim=-1)
        out[idx] = z
    return out


def _node_tables(data: BDCMData, device):
    return [(cls.d, _long(cls.idx, device), _long(cls.in_edges, device),
             torch.as_tensor(cls.Ai, dtype=data.dtype, device=device))
            for cls in data.node_classes]


def make_node_partition(data: BDCMData, eps_clamp: float = 0.0, device=None):
    """``(chi, lmbd) -> Z_i[n]``: per-node partition function via the
    all-neighbor DP against ``Ai`` (`ipynb:157-222`), clamped at
    ``eps_clamp``. Nodes of degree 0 get ``eps_clamp``: the entropy
    pipeline removes isolates first (`ipynb:283-291`)."""
    dev = resolve_device(device)
    ntables = _node_tables(data, dev)
    valid = torch.as_tensor(data.valid, dtype=data.dtype, device=dev)
    K, n = data.K, data.n

    def zi(chi, lmbd):
        tilt = tilt_vector(lmbd, data.x0, data.dtype).to(dev)
        if data.padded:
            chi = torch.cat([chi, chi.new_full((1, K, K), 1.0 / (K * K))])
        z = _node_z(chi, tilt, valid, ntables, data.T, K,
                    n + 1 if data.padded else n)
        return torch.clamp_min(z[:n], float(eps_clamp))

    return zi


def make_free_entropy(data: BDCMData, *, n_total: int, n_iso: int,
                      eps_clamp: float = 0.0, device=None):
    """``(chi, lmbd) -> φ``: the Bethe free entropy density ``(Σ ln Z_i −
    Σ ln Z_ij − λ·n_iso)/n_total`` (`ipynb:318-322`) with the analytic
    isolated-node term, as a 0-d tensor; ``−inf`` when some Z_i sits at the
    clamp floor (an empty attractor set), never the NaN that ``(−inf) −
    (−inf)`` would give."""
    _require_halved_layout(data, "make_free_entropy")
    dev = resolve_device(device)
    zi_fn = make_node_partition(data, eps_clamp, device=dev)
    mask2 = _mask2(data.valid, data.dtype, dev)
    n_iso_t = torch.tensor(n_iso, dtype=data.dtype, device=dev)
    n_total_t = torch.tensor(n_total, dtype=data.dtype, device=dev)

    def phi(chi, lmbd):
        zi = zi_fn(chi, lmbd)
        zij = edge_partition(chi, mask2, float(eps_clamp))
        lm = torch.tensor(lmbd, dtype=data.dtype, device=dev)
        val = (torch.log(zi).sum() - torch.log(zij).sum()
               - lm * n_iso_t) / n_total_t
        return torch.where((zi <= eps_clamp).any(), -torch.inf, val)

    return phi


def m_init_terms(chi, mask2, x0, deg_u, deg_v, eps_clamp: float):
    """Each undirected edge's share of the BP mean initial magnetization
    (the summand of `ipynb:325-338`), ``[..., E]``; 0 where Z_ij vanished
    (sits at the clamp floor), not 0/0."""
    P = _pair_products(chi, mask2)
    Zij = torch.clamp_min(P.sum(dim=(-1, -2)), eps_clamp)
    wu = x0[:, None] / deg_u[..., None, None]
    wv = x0[None, :] / deg_v[..., None, None]
    s = ((wu + wv) * P).sum(dim=(-1, -2))
    tiny = torch.finfo(chi.dtype).tiny
    return torch.where(Zij > eps_clamp, s / torch.clamp_min(Zij, tiny),
                       torch.zeros_like(s))


def make_m_init_edge_terms(data: BDCMData, eps_clamp: float = 0.0,
                           device=None):
    """``chi -> s[E]``: each undirected edge's contribution to the BP mean
    initial magnetization, before the edge sum (the union ensemble sums it
    per member)."""
    _require_halved_layout(data, "make_m_init_edge_terms")
    dev = resolve_device(device)
    mask2 = _mask2(data.valid, data.dtype, dev)
    x0 = torch.as_tensor(data.x0, dtype=data.dtype, device=dev)
    edges = data.graph.edges.astype(np.int64)
    deg = torch.as_tensor(data.graph.deg, dtype=data.dtype, device=dev)
    deg_u = deg[_long(edges[:, 0], dev)]
    deg_v = deg[_long(edges[:, 1], dev)]
    return lambda chi: m_init_terms(chi, mask2, x0, deg_u, deg_v,
                                    float(eps_clamp))


def make_mean_m_init(data: BDCMData, *, n_total: int, n_iso: int,
                     eps_clamp: float = 0.0, device=None):
    """``chi -> m_init``: the BP mean initial magnetization (`ipynb:325-338`)
    as a 0-d tensor; each isolated node contributes +1 (it must sit at the
    attractor value)."""
    dev = resolve_device(device)
    terms = make_m_init_edge_terms(data, eps_clamp, device=dev)
    n_iso_t = torch.tensor(n_iso, dtype=data.dtype, device=dev)
    n_total_t = torch.tensor(n_total, dtype=data.dtype, device=dev)
    return lambda chi: (terms(chi).sum() + n_iso_t) / n_total_t


# ---------------------------------------------------------------------------
# fixed points: a chunk of masked sweeps with no host read
# ---------------------------------------------------------------------------

CHUNK_SWEEPS = 16     # sweeps per chunk between two host reads


def lane_delta(new: torch.Tensor, old: torch.Tensor, lanes: int) -> torch.Tensor:
    """``max|new − old|`` per lane (the leading ``lanes`` blocks of the
    flattened tensors), ``[lanes]``; ``−inf`` for lanes without entries (the
    max of nothing, as XLA reduces it)."""
    diff = (new - old).abs().reshape(lanes, -1)
    if diff.shape[1] == 0:
        return diff.new_full((lanes,), -torch.inf)
    return diff.amax(dim=1)


def fixed_point_sweeps(sweep, chi, delta, t, active, *, eps: float,
                       t_max: int, sweeps: int):
    """Up to ``sweeps`` more sweeps of every live lane, as device ops with no
    host read: a lane is live while ``active & (delta > eps) & (t < t_max)``
    (the JAX package's per-lane while-loop condition; a NaN delta reads as
    stopped), and a lane that stops keeps its chi, delta and t bit for bit
    while the others go on. ``delta``, ``t`` and ``active`` are ``[L]``; chi's
    leading dimension is L (one lane per group member) or 1 with L = 1 (one
    joint fixed point over all of chi). Returns ``(chi, delta, t)``."""
    L = delta.shape[0]
    bcast = (L,) + (1,) * (chi.ndim - 1)
    for _ in range(sweeps):
        live = active & (delta > eps) & (t < t_max)
        new = sweep(chi)
        d_new = lane_delta(new, chi, L)
        chi = torch.where(live.view(bcast), new, chi)
        delta = torch.where(live, d_new, delta)
        t = t + live.to(t.dtype)
    return chi, delta, t


def run_fixed_point(sweep, chi, *, eps: float, t_max: int,
                    chunk_sweeps: int):
    """One joint fixed point from ``chi``: sweep until ``max|Δchi| ≤ eps``
    or ``t_max`` sweeps (`ipynb:420-432`), in chunks of ``chunk_sweeps``
    sweeps with one host read of ``(delta, t)`` per chunk. Returns ``(chi*,
    sweeps, delta)`` with host scalars."""
    dev = chi.device
    delta = torch.full((1,), torch.inf, dtype=chi.dtype, device=dev)
    t = torch.zeros(1, dtype=torch.int32, device=dev)
    active = torch.ones(1, dtype=torch.bool, device=dev)
    while True:
        chi, delta, t = fixed_point_sweeps(sweep, chi, delta, t, active,
                                           eps=eps, t_max=t_max,
                                           sweeps=chunk_sweeps)
        d, tt = float(delta[0]), int(t[0])
        if not d > eps or tt >= t_max:
            return chi, tt, d


def make_fixed_point(data: BDCMData, config, *, kernel: str = "auto",
                     device=None):
    """``(chi, lmbd) -> (chi*, sweeps, delta)``: iterate the entropy sweep
    (invalid sources masked, one λ shared by every edge: the shared-factor
    variant of the kernel) until ``max|Δchi| ≤ eps`` or ``max_sweeps``
    (`ipynb:420-432`), with the tilted factors built once per λ. ``config``
    is an :class:`~graphdyn_torch.config.EntropyConfig`."""
    dev = resolve_device(device)
    sweep = make_sweep(data, damp=config.damp, eps_clamp=config.eps_clamp,
                       mask_invalid_src=True, kernel=kernel, device=dev)
    spec = sweep.spec
    tables, As, valid = sweep.args
    K = data.K

    def fixed_point(chi, lmbd):
        a_t = [A * tilt_vector(lmbd, data.x0, data.dtype).to(dev)[:, None, None]
               for A in As]

        def one(c):
            if spec.padded:
                c = torch.cat([c, c.new_full((1, K, K), 1.0 / (K * K))])
            return _sweep_core(c[None], a_t, None, valid, tables,
                               spec)[0][:chi.shape[0]]

        return run_fixed_point(one, chi, eps=float(config.eps),
                               t_max=int(config.max_sweeps),
                               chunk_sweeps=CHUNK_SWEEPS)

    fixed_point.spec = spec
    return fixed_point


# ---------------------------------------------------------------------------
# ensembles: congruent graphs (EnsembleBDCM) and ragged cells (StackedBDCM)
# ---------------------------------------------------------------------------


def _same_dynamics(datas, what: str, *, dtype: bool = False) -> None:
    d0 = datas[0]
    for dd in datas[1:]:
        if ((dd.p, dd.c, dd.attr_value, dd.rule, dd.tie)
                != (d0.p, d0.c, d0.attr_value, d0.rule, d0.tie)
                or (dtype and dd.dtype != d0.dtype)):
            raise ValueError(
                f"{what} must share dynamics parameters (p, c, attr_value, "
                f"rule, tie{', dtype' if dtype else ''}) — factor tensors are "
                "shared"
            )


class EnsembleBDCM:
    """Stacked BDCM data for an ensemble of structurally congruent graphs
    (same n, same degree-class signature: RRG(n, d) instances, where every
    directed edge is one class). The ensemble axis is the kernel's group
    axis: per-class index tables stack to ``[G, Ed, ...]`` and one launch per
    sweep covers every instance, with one λ (the shared factor)."""

    def __init__(self, datas: list[BDCMData]):
        if not datas:
            raise ValueError("empty ensemble")
        for dd in datas:
            _require_halved_layout(dd, "EnsembleBDCM")   # chi[:E]/chi[E:]
        _same_dynamics(datas, "ensemble members")
        d0 = datas[0]
        sig = [(c.d, c.idx.shape[0]) for c in d0.edge_classes]
        nsig = [(c.d, c.idx.shape[0]) for c in d0.node_classes]
        for dd in datas[1:]:
            if (
                dd.n != d0.n
                or dd.T != d0.T
                or [(c.d, c.idx.shape[0]) for c in dd.edge_classes] != sig
                or [(c.d, c.idx.shape[0]) for c in dd.node_classes] != nsig
                or dd.leaf_idx.size != d0.leaf_idx.size
            ):
                raise ValueError(
                    "ensemble graphs must be structurally congruent "
                    "(same n and degree-class signature)"
                )
        self.datas = datas
        self.G = len(datas)
        self.T, self.K = d0.T, d0.K
        self.n = d0.n
        self.num_edges = d0.num_edges
        self.num_directed = d0.num_directed
        self.valid = d0.valid
        self.x0 = d0.x0
        # stacked per-class tables: (d, idx[G, Ed], in_edges[G, Ed, d], A)
        self.edge_classes = [
            (cls.d, np.stack([dd.edge_classes[k].idx for dd in datas]),
             np.stack([dd.edge_classes[k].in_edges for dd in datas]), cls.A)
            for k, cls in enumerate(d0.edge_classes)
        ]
        self.node_classes = [
            (cls.d, np.stack([dd.node_classes[k].idx for dd in datas]),
             np.stack([dd.node_classes[k].in_edges for dd in datas]), cls.Ai)
            for k, cls in enumerate(d0.node_classes)
        ]
        self.edges = np.stack([dd.graph.edges.astype(np.int64) for dd in datas])
        self.deg = np.stack([dd.graph.deg for dd in datas])
        self.leaf_idx = np.stack([dd.leaf_idx for dd in datas])   # [G, L]
        self.leaf01 = d0.leaf01
        self.dtype = d0.dtype

    @property
    def np_dtype(self):
        return np.float32 if self.dtype == torch.float32 else np.float64

    def init_messages(self, seed=0) -> torch.Tensor:
        """[G, 2E, K, K] random row-normalized chi from one numpy stream,
        the JAX package's draw bit for bit, as a CPU tensor."""
        rng = np.random.default_rng(seed)
        chi = rng.random((self.G, self.num_directed, self.K, self.K))
        chi /= chi.sum(axis=(2, 3), keepdims=True)
        return torch.from_numpy(chi.astype(self.np_dtype))


class StackedBDCM:
    """Stacked per-cell BDCM edge tables for a ragged ensemble: graphs that
    need not be congruent (the entropy grid's ER cells). The union of the
    cells' degree classes is taken and every class table is padded to the
    class's largest population ``Ed_max`` across cells: padded members gather
    from the ghost row ``2E_max`` and scatter into it. chi stacks to ``[G,
    2E_max, K, K]``; rows past a cell's own ``2E`` hold the uniform message
    and are never indexed, so they add 0 to the cell's delta. Only the sweep
    tables are stacked: φ and m_init run per cell on its own ``chi[:2E]``."""

    def __init__(self, datas: list[BDCMData]):
        if not datas:
            raise ValueError("empty cell stack")
        _same_dynamics(datas, "stacked cells", dtype=True)
        d0 = datas[0]
        self.datas = datas
        self.G = len(datas)
        self.T, self.K = d0.T, d0.K
        self.dtype = d0.dtype
        self.valid = d0.valid
        self.x0 = d0.x0
        self.leaf01 = d0.leaf01
        self.twoE = np.asarray([dd.num_directed for dd in datas])
        self.num_edges = np.asarray([dd.num_edges for dd in datas])
        self.twoE_max = int(self.twoE.max())
        ghost = self.twoE_max                 # row 2E_max of the extended chi

        def remap(arr, dd):
            # per-cell ghost references (class_bucket padding points at the
            # cell's own ghost row 2E_g) move to the stacked ghost row
            out = np.asarray(arr, np.int64)
            return np.where(out == dd.num_directed, ghost, out)

        ds = sorted({cls.d for dd in datas for cls in dd.edge_classes})
        self.edge_classes = []
        for d in ds:
            percell = [next((c for c in dd.edge_classes if c.d == d), None)
                       for dd in datas]
            Ed = max(c.idx.shape[0] for c in percell if c is not None)
            idx = np.full((self.G, Ed), ghost, np.int64)
            in_edges = np.full((self.G, Ed, d), ghost, np.int64)
            A = next(c for c in percell if c is not None).A
            for g, (dd, c) in enumerate(zip(datas, percell)):
                if c is None:
                    continue
                m = c.idx.shape[0]
                idx[g, :m] = remap(c.idx, dd)
                in_edges[g, :m] = remap(c.in_edges, dd)
            self.edge_classes.append((d, idx, in_edges, A))

        L = max(dd.leaf_idx.size for dd in datas)
        self.leaf_idx = np.full((self.G, L), ghost, np.int64)
        for g, dd in enumerate(datas):
            self.leaf_idx[g, :dd.leaf_idx.size] = remap(dd.leaf_idx, dd)

    def stack_chi(self, chi_list) -> torch.Tensor:
        """Stack per-cell chi ``[2E_g, K, K]`` to a CPU tensor ``[G,
        2E_max, K, K]``; pad rows hold the uniform message."""
        if len(chi_list) != self.G:
            raise ValueError(f"need {self.G} chi arrays, got {len(chi_list)}")
        K = self.K
        out = torch.full((self.G, self.twoE_max, K, K), 1.0 / (K * K),
                         dtype=self.dtype)
        for g, (chi, e2) in enumerate(zip(chi_list, self.twoE)):
            chi = (chi.cpu() if isinstance(chi, torch.Tensor)
                   else torch.from_numpy(np.array(chi))).to(self.dtype)
            if tuple(chi.shape) != (int(e2), K, K):
                raise ValueError(
                    f"cell {g}: chi shape {tuple(chi.shape)} != "
                    f"{(int(e2), K, K)}")
            out[g, :e2] = chi
        return out


def stack_bdcm(data_list: list[BDCMData]) -> StackedBDCM:
    """Stack ragged per-cell BDCM tables into the ``[G, Ed_max, …]`` layout
    of :class:`StackedBDCM`."""
    return StackedBDCM(data_list)


def make_ensemble_sweep(ens: EnsembleBDCM, *, damp: float,
                        eps_clamp: float = 0.0, mask_invalid_src: bool = True,
                        kernel: str = "auto", device=None):
    """``(chi[G, 2E, K, K], lmbd) -> chi'``: the BDCM sweep over the
    ensemble, one kernel launch per sweep with the ensemble as the group
    axis and one λ for all (the shared factor)."""
    dev = resolve_device(device)
    ds = [d for d, _, _, _ in ens.edge_classes]
    spec = _SweepSpec(
        T=ens.T, K=ens.K, damp=float(damp), eps_clamp=float(eps_clamp),
        mask_invalid_src=bool(mask_invalid_src), with_bias=False,
        padded=False, class_ds=tuple(ds),
        modes=resolve_modes(ds, T=ens.T, dtype=ens.dtype, kernel=kernel,
                            device=dev),
    )
    rows = ens.num_directed
    valid = torch.as_tensor(ens.valid, dtype=ens.dtype, device=dev)
    tables = sweep_tables(
        [(_flat_ids(list(idx), rows, dev), _flat_ids(list(ie), rows, dev))
         for _, idx, ie, _ in ens.edge_classes], spec, G=ens.G, rows=rows,
        valid=valid)
    As = [torch.as_tensor(A, dtype=ens.dtype, device=dev)
          for _, _, _, A in ens.edge_classes]

    def sweep(chi, lmbd):
        tilt = tilt_vector(lmbd, ens.x0, ens.dtype).to(dev)
        return _sweep_core(chi, [A * tilt[:, None, None] for A in As], None,
                           valid, tables, spec)

    sweep.spec = spec
    sweep.args = (tables, As, valid)
    return sweep


def make_ensemble_free_entropy(ens: EnsembleBDCM, *, n_total: int | None = None,
                               eps_clamp: float = 0.0, device=None):
    """``(chi, lmbd) -> φ[G]`` for a congruent isolate-free ensemble."""
    dev = resolve_device(device)
    G, T, K, n = ens.G, ens.T, ens.K, ens.n
    n_total_t = torch.tensor(n_total or n, dtype=ens.dtype, device=dev)
    valid = torch.as_tensor(ens.valid, dtype=ens.dtype, device=dev)
    mask2 = _mask2(ens.valid, ens.dtype, dev)
    rows = ens.num_directed
    ntables = [(d, _flat_ids(list(idx), n, dev), _flat_ids(list(ie), rows, dev),
                torch.as_tensor(Ai, dtype=ens.dtype, device=dev))
               for d, idx, ie, Ai in ens.node_classes]

    def phi(chi, lmbd):
        tilt = tilt_vector(lmbd, ens.x0, ens.dtype).to(dev)
        zi = _node_z(chi.reshape(G * rows, K, K), tilt, valid,
                     [(d, idx.reshape(-1), ie.reshape(-1, d), Ai)
                      for d, idx, ie, Ai in ntables], T, K, G * n)
        zi = torch.clamp_min(zi.reshape(G, n), float(eps_clamp))
        zij = edge_partition(chi, mask2, float(eps_clamp))
        val = (torch.log(zi).sum(dim=1) - torch.log(zij).sum(dim=1)) / n_total_t
        return torch.where((zi <= eps_clamp).any(dim=1), -torch.inf, val)

    return phi


def make_ensemble_m_init(ens: EnsembleBDCM, *, n_total: int | None = None,
                         eps_clamp: float = 0.0, device=None):
    """``chi -> m_init[G]`` for a congruent isolate-free ensemble."""
    dev = resolve_device(device)
    n_total_t = torch.tensor(n_total or ens.n, dtype=ens.dtype, device=dev)
    mask2 = _mask2(ens.valid, ens.dtype, dev)
    x0 = torch.as_tensor(ens.x0, dtype=ens.dtype, device=dev)
    deg = torch.as_tensor(ens.deg, dtype=ens.dtype, device=dev)   # [G, n]
    edges = torch.as_tensor(ens.edges, device=dev)                 # [G, E, 2]
    deg_u = torch.gather(deg, 1, edges[..., 0])
    deg_v = torch.gather(deg, 1, edges[..., 1])

    def m_init(chi):
        s = m_init_terms(chi, mask2, x0, deg_u, deg_v, float(eps_clamp))
        return s.sum(dim=1) / n_total_t

    return m_init


def make_ensemble_leaf_setter(ens: EnsembleBDCM, device=None):
    """``(chi[G, ...], lmbd) -> chi``: the closed-form leaf messages of every
    graph written into a copy (the identity without degree-0 edges)."""
    dev = resolve_device(device)
    rows = ens.num_directed
    leaf_idx = _flat_ids(list(ens.leaf_idx), rows, dev).reshape(-1)

    def set_leaves(chi, lmbd):
        if leaf_idx.numel() == 0:
            return chi
        t = leaf_message(lmbd, ens.leaf01, ens.x0, ens.dtype).to(dev)
        out = chi.clone()
        out.view(-1, ens.K, ens.K)[leaf_idx] = t
        return out

    return set_leaves
