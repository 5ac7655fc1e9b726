"""One-kernel annealing: the fused LUT-popcount SA chain (the port of
``graphdyn/ops/pallas_anneal.py``).

One class step (class ``c = steps mod χ``) on the ghost-extended packed
state:

- two LUT one-step evaluations, ``end(s)`` and ``end(s ⊕ class)``
  (:func:`graphdyn_torch.ops.lut.lut_one_step`), needed only at the balls
  ``{i} ∪ N(i)`` of the class rows and evaluated only there;
- the exact per-site ``ΔΣs_end`` from disjoint-ball popcounts, the f32
  ``ΔE``, and a Metropolis accept against Threefry-2x32 counter uniforms
  keyed by ``(seed, FUSED_STREAM_TAG + replica pair)`` with counter
  ``(step, node)``;
- accepted flips XORed into the words, the additive per-replica
  ``Σs_end``, the per-replica anneal (cap checked before the multiply), and
  the first-passage record that freezes a replica.

A chunk runs up to ``chunk_steps`` class steps while any replica is active
(and, with ``stop_on_first``, until a first passage). It has two
implementations that give the same state bit for bit:

- the hand-written CUDA kernel (:mod:`graphdyn_torch.ops.fused_cuda`): one
  cooperative launch per chunk, the whole loop inside it, one pass over the
  class rows per class step;
- the plain PyTorch version here (:func:`fused_chunk_plain`): a host loop
  of class steps, which :func:`fused_chunk` runs for CPU tensors and which
  the chip smoke test holds the kernel against on the card. It keeps the
  kernel's decomposition: the class rows in chunks, each chunk evaluating
  its balls' end states on the state as it stands and flipping its rows in
  place (:func:`_class_chunk`).

The one pass is exact because a class's balls are disjoint: two rows of a
class lie at distance ≥ 3 (a distance-2 colouring), so no row that one class
row's decision reads is a row another decision writes.
:func:`fused_device_tables` refuses class masks without that property.

Words are ``torch.int32`` with the reference's uint32 bit patterns; the
Threefry arithmetic runs in int64 masked to 32 bits (torch's CPU build has
no uint32 right shift). The JAX package's VMEM admission gate
(``fused_vmem_bytes``/``fused_kernel_supported``) has no counterpart: the
cooperative grid takes any n. Its runtime fallback from the kernel to the
XLA twin is not ported either: a failed build or launch raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.config import SAConfig
from graphdyn_torch.ops.chromatic import (
    ChromaticTables,
    _ball_counts,
    _delta_e,
    _pack_bool,
    _unpack_pm1,
    build_chromatic_tables,
)
from graphdyn_torch.ops.lut import _count_eq_masks, lut_node_masks, update_lut
from graphdyn_torch.ops.packed import _csa_add_one, _row_chunk

# key word 1 of the fused proposal stream (key word 0 is the run seed)
FUSED_STREAM_TAG = 0x464C5554  # b"FLUT"

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KERNELS = ("auto", "cuda", "plain")


# ---------------------------------------------------------------------------
# counter-based RNG (Threefry-2x32)
# ---------------------------------------------------------------------------


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds, the jax.random stream cipher) on int64
    values in ``[0, 2³²)``: torch tensors, numpy arrays or Python ints,
    broadcastable. Every sum is masked to 32 bits and every shifted value
    stays below 2⁶³, so the arithmetic is the uint32 cipher's exactly.
    Returns the two output words, int64 in ``[0, 2³²)``."""
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, ks2)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for d in range(5):
        for r in _ROTATIONS[d % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & _M32
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & _M32
    return x0, x1


def _bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """int64 uint32 bits -> f32 uniforms in [0, 1): the top 24 bits scaled
    by 2⁻²⁴, exact in f32."""
    # graftlint: disable-next-line=GD018  bits is int64 holding a uint32 value (non-negative): the shift is logical
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _check_seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed must be a uint32 (0 <= seed < 2**32), got {seed}")
    return seed


def counter_uniforms(seed, step, n: int, Rp: int, *,
                     nodes=None) -> torch.Tensor:
    """The fused proposal stream: f32 uniforms ``[n, Rp]`` for class step
    ``step``, deterministic per ``(seed, site, step)``. Key ``(seed,
    FUSED_STREAM_TAG + pair)``, counter ``(step, node)``; each Threefry block
    yields replicas ``2j, 2j+1`` of its node. ``nodes`` (an int tensor)
    gives the rows of those nodes only, ``[len(nodes), Rp]``, on their
    device; without it the stream of every node is made on the CPU."""
    seed = _check_seed(seed)
    step = int(step) & _M32
    if nodes is None:
        nodes = torch.arange(n, dtype=torch.int64)
    node = nodes.to(torch.int64)[:, None]
    pair = torch.arange(Rp // 2, dtype=torch.int64, device=node.device)[None, :]
    y0, y1 = threefry2x32(seed, FUSED_STREAM_TAG + pair,
                          torch.full_like(node, step), node)
    u = torch.stack(torch.broadcast_tensors(y0, y1), dim=2)
    return _bits_to_uniform(u.reshape(node.shape[0], Rp))


def counter_uniforms_np(seed, step, n: int, Rp: int) -> np.ndarray:
    """The numpy mirror of :func:`counter_uniforms` (same cipher body, same
    key/counter layout, bit-identical floats)."""
    pairs = Rp // 2
    node = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], (n, pairs))
    k1 = FUSED_STREAM_TAG + np.arange(pairs, dtype=np.int64)[None, :]
    c0 = np.full((n, pairs), int(step) & _M32, np.int64)
    y0, y1 = threefry2x32(np.int64(int(seed)), k1, c0, node)
    u = np.stack([y0, y1], axis=2).reshape(n, Rp)
    # graftlint: disable-next-line=GD018  numpy uint32: the shift is logical
    return (u >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24))


# ---------------------------------------------------------------------------
# tables and state
# ---------------------------------------------------------------------------


class FusedTables(NamedTuple):
    """Host-side setup of the fused annealer (numpy arrays): the chromatic
    distance-2 tables plus the LUT word masks and the per-class anneal
    factors ``par**|class|``."""

    chrom: ChromaticTables
    masks_ext: np.ndarray   # uint32[χ, n+1], ghost column 0
    lut_masks: np.ndarray   # uint32[dmax+1, 2, n+1]
    fac_a: np.ndarray       # f32[χ]
    fac_b: np.ndarray       # f32[χ]

    @property
    def chi(self) -> int:
        return self.chrom.chi

    @property
    def n(self) -> int:
        return self.chrom.n

    @property
    def dmax(self) -> int:
        return self.chrom.dmax


def build_fused_tables(graph, config: SAConfig | None = None, *,
                       seed: int = 0, coloring=None) -> FusedTables:
    """Distance-2 coloring + LUT masks + anneal factors for ``graph``
    (deterministic per ``seed``; ``coloring`` as in
    :func:`build_chromatic_tables`)."""
    config = config or SAConfig()
    dyn = config.dynamics
    chrom = build_chromatic_tables(graph, seed=seed, coloring=coloring)
    masks_ext = np.concatenate(
        [chrom.masks, np.zeros((chrom.chi, 1), np.uint32)], axis=1
    )
    lut = update_lut(chrom.dmax, dyn.rule, dyn.tie)
    lm = lut_node_masks(chrom.deg_ext, lut)
    sizes = chrom.class_sizes.astype(np.float64)
    fac_a = (config.par_a ** sizes).astype(np.float32)
    fac_b = (config.par_b ** sizes).astype(np.float32)
    return FusedTables(chrom=chrom, masks_ext=masks_ext, lut_masks=lm,
                       fac_a=fac_a, fac_b=fac_b)


class FusedDeviceTables(NamedTuple):
    """The chunk's device tables: the JAX package's seven table arguments
    (``fused_chunk_xla``'s positional order) plus each class's rows,
    derived once from ``masks_ext``. Words and masks are ``torch.int32``."""

    masks_ext: torch.Tensor   # int32[χ, n+1]
    facs: torch.Tensor        # f32[χ, 2]
    nbr_ext: torch.Tensor     # int32[n+1, dmax]
    nbr_self: torch.Tensor    # int32[n+1, dmax+1]
    lut_masks: torch.Tensor   # int32[dmax+1, 2, n+1]
    a_caps: torch.Tensor      # f32[Rp]
    b_caps: torch.Tensor      # f32[Rp]
    class_ptr: torch.Tensor   # int32[χ+1]: class c's rows are
    class_rows: torch.Tensor  # class_rows[class_ptr[c]:class_ptr[c+1]]
    max_class: int            # the largest class's row count


def _ball_owners(nbr_self, rows, n: int):
    """The balls ``{i} ∪ N(i)`` of ``rows`` (int64 ``[k, dmax+1]``), each
    row's repeated slots and ghost slots set to the ghost index ``n``, and
    how many of the balls hold each node (int64 ``[n+1]``)."""
    ball, _ = nbr_self.index_select(0, rows.long()).long().clamp(0, n).sort(1)
    ball[:, 1:][ball[:, 1:] == ball[:, :-1]] = n
    return ball, torch.bincount(ball.reshape(-1), minlength=n + 1)


def _overlap_reason(nbr_self, rows, c: int, n: int) -> str:
    """Which two rows of class ``c`` have overlapping balls, and how."""
    ball, hold = _ball_owners(nbr_self, rows, n)
    node = int(torch.nonzero(hold[:n] > 1)[0])
    i, j = rows[torch.nonzero((ball == node).any(1)).flatten()[:2]].tolist()
    how = ("adjacent" if node in (i, j)
           else f"both neighbours of row {node}")
    return (f"rows {i} and {j} of class {c} are {how}: their balls "
            f"{{i}} ∪ N(i) overlap")


def fused_device_tables(masks_ext, facs, nbr_ext, nbr_self, lut_masks,
                        a_caps, b_caps) -> FusedDeviceTables:
    """Assemble :class:`FusedDeviceTables` from the seven tensors (all on
    one device; words as int32), deriving the class row lists: the rows
    where ``masks_ext[c, :n]`` is set, in ascending order. With one host
    read, here, so that no chunk launch needs one, refuses

    - gather tables with indices outside ``[0, n]`` (n is the ghost row),
      which the CUDA kernel would read out of bounds with;
    - class masks with two rows at distance ≤ 2 (adjacent, or sharing a
      neighbour), whose balls ``{i} ∪ N(i)`` overlap: the kernel decides a
      class's rows in one pass, in place and in no set order, which is
      exact only when no row one decision reads is a row another writes.
      :func:`graphdyn_torch.ops.chromatic.build_chromatic_tables`'s
      distance-2 colourings have disjoint balls;
    - a ghost slot before a neighbour in a row of ``nbr_ext``, or a class
      mask set in the ghost column: the kernel's loops stop at a row's
      first ghost slot, which is exact only when the ghosts are each row's
      suffix and add nothing (as :class:`~graphdyn_torch.graphs.Graph`
      rows are)."""
    n = masks_ext.shape[1] - 1
    rows = [torch.nonzero(masks_ext[c, :n] != 0).flatten().to(torch.int32)
            for c in range(masks_ext.shape[0])]
    held = [_ball_owners(nbr_self, r, n)[1][:n].max() if r.numel()
            else nbr_self.new_zeros((), dtype=torch.int64) for r in rows]
    ghost = nbr_ext == n
    gaps = (ghost[:, :-1] & ~ghost[:, 1:]).any() | (masks_ext[:, n] != 0).any()
    vals = torch.stack([nbr_ext.min(), nbr_ext.max(), nbr_self.min(),
                        nbr_self.max(), gaps.to(nbr_ext.dtype)]
                       + [h.to(nbr_ext.dtype) for h in held]).tolist()
    bounds, gaps, held = vals[:4], vals[4], vals[5:]
    if min(bounds) < 0 or max(bounds) > n:
        raise ValueError(
            f"fused gather tables out of range: indices in [{min(bounds)}, "
            f"{max(bounds)}], must be within [0, {n}]"
        )
    if gaps:
        raise ValueError(
            "fused gather tables: a row of nbr_ext has a ghost slot before a "
            "neighbour, or a class mask is set in the ghost column (the "
            "kernel stops at a row's first ghost slot)")
    for c, h in enumerate(held):
        if h > 1:
            raise ValueError(
                "fused class masks are not a distance-2 colouring: "
                + _overlap_reason(nbr_self, rows[c], c, n)
                + " (the one-pass class step needs disjoint balls; "
                "build_chromatic_tables makes such masks)")
    counts = torch.tensor([0] + [r.numel() for r in rows], dtype=torch.int64)
    class_ptr = torch.cumsum(counts, 0).to(torch.int32).to(masks_ext.device)
    class_rows = (torch.cat(rows) if rows else
                  masks_ext.new_zeros(0, dtype=torch.int32))
    return FusedDeviceTables(masks_ext, facs, nbr_ext, nbr_self, lut_masks,
                             a_caps, b_caps, class_ptr, class_rows,
                             int(counts.max()))


class FusedState(NamedTuple):
    """Device carry of the fused annealer: the packed state ghost-extended
    (``[n+1, W]``, ghost word 0), the replica axis padded to ``Rp = 32·W``
    with pad lanes frozen by ``active``."""

    sp_ext: torch.Tensor     # int32[n+1, W]
    sum_end: torch.Tensor    # int32[Rp]
    a: torch.Tensor          # f32[Rp]
    b: torch.Tensor          # f32[Rp]
    t_target: torch.Tensor   # int32[Rp], first-passage class step or −1
    active: torch.Tensor     # bool[Rp]
    steps: torch.Tensor      # int32[], global class-step index (the RNG
    #                          counter, so chunk splits cannot change the chain)
    accepted: torch.Tensor   # int32[], wraps like the reference's int32 sum


# ---------------------------------------------------------------------------
# the plain class step and chunk loop
# ---------------------------------------------------------------------------


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (the reference's
    int32 accumulation)."""
    return (((x + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)


def _class_rows(tables: FusedDeviceTables, c: int) -> torch.Tensor:
    lo, hi = tables.class_ptr[c:c + 2].tolist()
    return tables.class_rows[lo:hi].to(torch.int64)


def class_decisions(st: FusedState, seed, tables: FusedDeviceTables,
                    rows: torch.Tensor, end, end_all, *, n: int):
    """The accept terms of class step ``st.steps`` for the class rows
    ``rows``: ``(dsend int32[k, Rp], u f32[k, Rp], delta_e f32[k, Rp],
    acc bool[k, Rp])``. One row chunk; :func:`_fused_class_step` cuts the
    class into chunks of this."""
    Rp = st.a.shape[0]
    up = end_all & ~end
    dn = end & ~end_all
    ns = tables.nbr_self.index_select(0, rows)
    dsend = 2 * (_ball_counts(up, ns) - _ball_counts(dn, ns))
    delta_e = _delta_e(st.a[None, :], st.b[None, :],
                       _unpack_pm1(st.sp_ext.index_select(0, rows)), dsend, n)
    u = counter_uniforms(seed, int(st.steps), n, Rp, nodes=rows)
    acc = (u < torch.exp(-delta_e)) & st.active[None, :]
    return dsend, u, delta_e, acc


def ball_end_states(sp_ext: torch.Tensor, tables: FusedDeviceTables,
                    rows: torch.Tensor, c: int, *, n: int, dmax: int):
    """``end(s)`` and ``end(s ⊕ class c)`` at ``rows`` only: int32
    ``[len(rows), W]`` each, the rows of :func:`graphdyn_torch.ops.lut.
    lut_one_step`
    applied to ``sp_ext`` and to ``sp_ext`` with class ``c``'s mask XORed
    in, evaluated row by row as the kernel does (one gather of a row's
    neighbours and one read of its LUT masks serve both). The ghost row's
    words are 0."""
    rows = rows.long()
    mask = tables.masks_ext[c]
    nb = tables.nbr_ext.index_select(0, rows).long()
    n_planes = max(int(dmax).bit_length(), 1)
    shape = (rows.numel(), sp_ext.shape[1])
    pl0 = [sp_ext.new_zeros(shape) for _ in range(n_planes)]
    pl1 = [sp_ext.new_zeros(shape) for _ in range(n_planes)]
    for j in range(dmax):
        x = sp_ext.index_select(0, nb[:, j])
        _csa_add_one(pl0, x)
        _csa_add_one(pl1, x ^ mask.index_select(0, nb[:, j])[:, None])
    own = sp_ext.index_select(0, rows)
    own_all = own ^ mask.index_select(0, rows)[:, None]
    e, ea = sp_ext.new_zeros(shape), sp_ext.new_zeros(shape)
    for cnt, (eq0, eq1) in enumerate(zip(_count_eq_masks(pl0, dmax),
                                         _count_eq_masks(pl1, dmax))):
        m0 = tables.lut_masks[cnt, 0].index_select(0, rows)[:, None]
        m1 = tables.lut_masks[cnt, 1].index_select(0, rows)[:, None]
        e = e | (eq0 & ((own & m1) | (~own & m0)))
        ea = ea | (eq1 & ((own_all & m1) | (~own_all & m0)))
    ghost = (rows == n)[:, None]
    return e.masked_fill(ghost, 0), ea.masked_fill(ghost, 0)


def _class_chunk(st: FusedState, seed, tables: FusedDeviceTables,
                 rows: torch.Tensor, c: int, end, end_all, *, n: int,
                 dmax: int, invert=None):
    """Decide the class rows ``rows`` of class ``c`` and flip them in place
    in ``st.sp_ext``, as one stretch of the kernel's pass: each row's ball
    end states are evaluated on the state as it stands (into ``end`` and
    ``end_all``, ``[n+1, W]`` buffers, at the ball rows), then
    :func:`class_decisions`. Exact for any order of a class's rows and any
    cut into chunks: the balls are disjoint (:func:`fused_device_tables`),
    so no row one decision reads is written by another. ``invert`` (bool
    ``[len(rows), Rp]``) flips chosen decisions. Returns ``(dsend int32[k,
    Rp], acc bool[k, Rp])``."""
    ball = tables.nbr_self.index_select(0, rows).reshape(-1).long()
    e, ea = ball_end_states(st.sp_ext, tables, ball, c, n=n, dmax=dmax)
    end[ball] = e
    end_all[ball] = ea
    dsend, _, _, acc = class_decisions(st, seed, tables, rows, end, end_all,
                                       n=n)
    if invert is not None:
        acc = acc ^ invert
    st.sp_ext[rows] = st.sp_ext[rows] ^ _pack_bool(acc, st.sp_ext.shape[1])
    return dsend, acc


def _fused_class_step(st: FusedState, seed, tables: FusedDeviceTables, *,
                      n: int, dmax: int, chi: int, target_sum: int,
                      invert=None) -> FusedState:
    """One fused class step, the counterpart of the reference's
    ``_fused_class_step`` with its uniforms (``_fused_cond_body``'s
    body): LUT end-state evaluations at the class rows' balls, per-site
    accepts of the class rows (in row chunks, each flipped in place before
    the next is evaluated, :func:`_class_chunk`), additive ``Σs_end``,
    anneal with the cap checked before the multiply, first passage and
    freeze. ``st`` is not written. ``invert`` (bool ``[|class|, Rp]``, the
    near-tie replay) flips chosen decisions."""
    step = int(st.steps)
    c = step % chi
    rows = _class_rows(tables, c)
    Rp = st.a.shape[0]
    cur = st._replace(sp_ext=st.sp_ext.clone())
    end, end_all = torch.zeros_like(cur.sp_ext), torch.zeros_like(cur.sp_ext)
    dsend_tot = torch.zeros(Rp, dtype=torch.int64, device=cur.sp_ext.device)
    n_acc = torch.zeros((), dtype=torch.int64, device=cur.sp_ext.device)
    # ~16 f32/int32/int64 [rows, Rp] temporaries live at once
    chunk = _row_chunk(16 * 8 * Rp)
    for i0 in range(0, rows.numel(), chunk):
        dsend, acc = _class_chunk(
            cur, seed, tables, rows[i0:i0 + chunk], c, end, end_all, n=n,
            dmax=dmax, invert=None if invert is None
            else invert[i0:i0 + chunk])
        dsend_tot += (dsend * acc).sum(dim=0)
        n_acc += acc.sum()
    fa, fb = tables.facs[c, 0], tables.facs[c, 1]
    act = st.active
    sum_end = st.sum_end + dsend_tot.to(torch.int32)
    a_new = torch.where(act & (st.a < tables.a_caps), st.a * fa, st.a)
    b_new = torch.where(act & (st.b < tables.b_caps), st.b * fb, st.b)
    steps = st.steps + 1
    hit = act & (sum_end >= target_sum)
    t_target = torch.where(hit, steps, st.t_target)
    return FusedState(cur.sp_ext, sum_end, a_new, b_new, t_target, act & ~hit,
                      steps, _wrap_i32(st.accepted.to(torch.int64) + n_acc))


def _go(st: FusedState, steps0: int, chunk_steps: int,
        stop_on_first: bool) -> bool:
    """The chunk loop's condition (the reference's ``cond``), read on the
    host."""
    go = bool(st.active.any()) and int(st.steps) - steps0 < chunk_steps
    if stop_on_first:
        go = go and not bool((st.t_target >= 0).any())
    return go


def fused_chunk_plain(state: FusedState, seed, tables: FusedDeviceTables, *,
                      n: int, dmax: int, chi: int, target_sum: int,
                      chunk_steps: int, stop_on_first: bool = False
                      ) -> FusedState:
    """The plain PyTorch chunk on any device: a host loop of class steps
    while any replica is active, fewer than ``chunk_steps`` steps have run
    in this chunk and (with ``stop_on_first``) no replica has reached the
    target. Reads the loop condition back once per class step. ``state``
    is not written."""
    steps0 = int(state.steps)
    st = state
    while _go(st, steps0, chunk_steps, stop_on_first):
        st = _fused_class_step(st, seed, tables, n=n, dmax=dmax, chi=chi,
                               target_sum=target_sum)
    return st


def fused_chunk(state: FusedState, seed, tables: FusedDeviceTables, *,
                kernel: str = "auto", **kwargs) -> FusedState:
    """Dispatch one fused chunk. ``kernel``: ``'auto'`` launches the CUDA
    kernel for CUDA tensors and runs the plain version for CPU tensors;
    ``'cuda'`` launches the kernel and raises on CPU tensors; ``'plain'``
    runs the plain version on any device (a test mode). ``kwargs``: ``n``,
    ``dmax``, ``chi``, ``target_sum``, ``chunk_steps``, ``stop_on_first``.

    The kernel updates ``state``'s tensors in place and returns them (the
    reference's donation contract); the plain version returns new
    tensors."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    dev = state.sp_ext.device.type
    if kernel == "plain" or (kernel == "auto" and dev == "cpu"):
        return fused_chunk_plain(state, seed, tables, **kwargs)
    if dev != "cuda":
        raise ValueError(
            f"fused_chunk(kernel={kernel!r}) launches the CUDA kernel; the "
            f"state is on {state.sp_ext.device}"
        )
    from graphdyn_torch.ops import fused_cuda

    return fused_cuda.fused_chunk_cuda(state, seed, tables, **kwargs)
