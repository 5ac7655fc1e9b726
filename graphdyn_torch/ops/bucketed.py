"""Degree-bucketed packed dynamics, the power-law fast path (the port of
``graphdyn/ops/bucketed.py``).

The padded step charges every node ``dmax`` table slots, so on a power-law
graph one hub of degree 10⁴ inflates the table of all ``n`` nodes. Here the
graph is laid out bucket-major (:func:`graphdyn_torch.graphs.degree_buckets`:
nodes permuted into ``O(log dmax)`` power-of-two degree buckets, each with
a tight ``nbr[n_b, 2^b]`` block), and each synchronous step updates every
bucket from the old state: ``Σ_b n_b·2^b ≤ 4E + n`` table slots a step.

Exactness: every bucket applies the carry-save bit-plane popcount and the
bitwise comparator of the padded step, and a node's popcount is the same
over its bucket's slots as over ``dmax`` padded ones, so the rollout equals
:func:`graphdyn_torch.ops.packed.packed_rollout` on the same graph, modulo
the bucket permutation, bit for bit. Wide (hub) buckets (width above
:data:`UNROLL_MAX`) add integer counts, which is exact and order-free.

Two implementations give the same words (``route='comparator'``, the
default):

- the CUDA kernel KB (:mod:`graphdyn_torch.ops.bucketed_cuda`), one launch
  per synchronous step over every bucket, which :func:`bucketed_rollout`
  launches for CUDA tensors; it raises rather than fall back;
- the plain PyTorch version (:class:`PlainBucketStep`, built from
  :func:`_csa_bucket` and :func:`_wide_bucket_counts` as the JAX package's
  XLA program is), which runs for CPU tensors and which the chip smoke test
  holds KB against.

``route='lut'`` is the JAX package's second XLA route (the
:mod:`graphdyn_torch.ops.lut` popcount tables per bucket): no Pallas kernel
stands behind it, so it is plain PyTorch on either device, chosen by the
caller, not a fallback. Words are ``torch.int32`` carrying uint32 bit
patterns, as in :mod:`graphdyn_torch.ops.packed`.

The byte models of the bucketed and streamed layouts (the port's copies of
``graphdyn/obs/memband.py``'s) live here and in
:mod:`graphdyn_torch.ops.streamed`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from graphdyn_torch.graphs import DegreeBuckets, degree_buckets, degree_cv
from graphdyn_torch.ops import bucketed_cuda
from graphdyn_torch.ops.dynamics import Rule, TieBreak
from graphdyn_torch.ops.packed import (
    _FULL,
    WORD,
    _compare_planes,
    _fold_u32,
    _row_chunk,
    _rule_tie_combine,
)

#: degree-CV above which the drivers route to the bucketed layout: an RRG
#: sits at 0, ER(c) at 1/sqrt(c) (< 0.71 for every c >= 2), a power-law
#: tail diverges with n
BUCKETED_CV_THRESHOLD = 1.0

#: widest bucket folded slot by slot into bit planes; wider (hub) buckets
#: split into UNROLL_MAX-slot segments whose integer counts add
UNROLL_MAX = 32

ROUTES = ("comparator", "lut")


def auto_layout(deg, *, threshold: float = BUCKETED_CV_THRESHOLD) -> str:
    """``'bucketed'`` when the degree CV crosses ``threshold``, else
    ``'padded'``: the one routing predicate of the solvers."""
    return "bucketed" if degree_cv(deg) >= threshold else "padded"


# ---------------------------------------------------------------------------
# byte models (the port's copies of graphdyn/obs/memband.py's)
# ---------------------------------------------------------------------------


def bucketed_state_bytes(n: int, W: int, table_entries: int) -> int:
    """Resident device bytes of the bucketed rollout: the ``[n, W]`` words,
    the bucket blocks (``table_entries`` int32 slots,
    :attr:`DegreeBuckets.table_entries`) and the degree vectors (``n``
    int32)."""
    # graftlint: disable-next-line=GD016  the bucketed resident model that obs/memband and serve admission price with; graftcost holds it to the card's allocator peak
    return 4 * n * W + 4 * table_entries + 4 * n


def bucketed_job_bytes(n: int, W: int, n_edges: int) -> int:
    """Device bytes a served bucketed job holds at its peak, from its
    declared edge count alone (the serve admission price): the job's
    ``[n, W]`` words and their bucketed permutation, the rollout's two
    ``[n+1, W]`` ping-pong states, the two int64 permutations, the bucket
    tables at :func:`bucketed_table_entries_bound` with the degree vector,
    and KB's count workspace at its bound. The workspace holds ``W·32``
    counts and ``G`` tickets (int32) for each row wider than a wide
    chunk (:func:`bucketed_cuda.wide_geometry`, 16-byte-aligned states);
    such a row's degree exceeds the chunk, so there are at most
    ``2E // (chunk + 1)`` of them."""
    geo = bucketed_cuda.wide_geometry(W, bucketed_cuda.words_per_thread(W))
    ws_rows = min(n, 2 * n_edges // (geo["chunk"] + 1))
    # graftlint: disable-next-line=GD016  the served bucketed job's resident model (serve admission's price); graftcost holds it to the card's allocator peak
    return (4 * W * (2 * n + 2 * (n + 1)) + 2 * 8 * n
            + 4 * bucketed_table_entries_bound(n, n_edges) + 4 * n
            + 4 * ws_rows * (W * bucketed_cuda.WARP + geo["G"]))


def bucketed_table_entries_bound(n: int, n_edges: int) -> int:
    """Upper bound on :attr:`DegreeBuckets.table_entries` from the edge
    count alone: each row rounds its degree up to a power of two, at most
    doubling it, and a degree-0/1 row costs one slot: ``≤ 4·E + n``."""
    return 4 * n_edges + n


# ---------------------------------------------------------------------------
# the plain arithmetic, on int32 words (the JAX package's helpers)
# ---------------------------------------------------------------------------


def _csa_add(planes, carry):
    """One carry-save addition: fold a packed neighbor word into the bit
    planes (the carry out of the top plane is dropped)."""
    nxt = []
    for k in range(len(planes)):
        nxt.append(planes[k] ^ carry)
        carry = planes[k] & carry
    return tuple(nxt)


def _csa_bucket(sp_ext, nbr_b, n_planes: int):
    """Carry-save popcount planes of one narrow bucket (width ≤
    :data:`UNROLL_MAX`): the bucket's neighbor rows, gathered from the
    ghost-extended state one slot at a time, folded into ``n_planes``
    bit planes ``[n_b, W]``."""
    zero = sp_ext.new_zeros((nbr_b.shape[0], sp_ext.shape[1]))
    planes = (zero,) * n_planes
    idx = nbr_b.long()
    for j in range(nbr_b.shape[1]):
        planes = _csa_add(planes, sp_ext.index_select(0, idx[:, j]))
    return list(planes)


def _planes_to_counts(planes):
    """Integer neighbor counts from the bit planes: ``int32[rows, W, 32]``
    (lane k of word w is replica ``32·w + k``)."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=planes[0].device)
    cnt = None
    for k, pl in enumerate(planes):
        bit = ((pl[..., None] >> shifts) & 1) << k
        cnt = bit if cnt is None else cnt + bit
    return cnt


def _wide_bucket_counts(sp_ext, nbr_b):
    """Integer neighbor counts ``int32[n_b, W, 32]`` of one wide (hub)
    bucket: the slab is cut into :data:`UNROLL_MAX`-slot segments (wide
    widths are powers of two ≥ 64), each segment runs the narrow carry-save
    fold, and the per-segment counts add. Ghost slots gather the zero row
    and add 0."""
    n_b, d_b = nbr_b.shape
    k = d_b // UNROLL_MAX
    seg = nbr_b.reshape(n_b * k, UNROLL_MAX)
    planes = _csa_bucket(sp_ext, seg, UNROLL_MAX.bit_length())
    cnt = _planes_to_counts(planes)                  # (n_b·k, W, 32)
    return cnt.reshape(n_b, k, cnt.shape[1], WORD).sum(
        dim=1, dtype=torch.int32)


def _pack_lanes(bits):
    """Boolean replica lanes ``[rows, W, 32]`` -> packed int32 words
    ``[rows, W]`` (lane k of word w is replica ``32·w + k``)."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits.device)
    return _fold_u32((bits.to(torch.int64) << shifts).sum(dim=-1))


def _lut_bucket_out(planes, masks_b, prev, n_planes: int, d_b: int):
    """LUT-route combine of one narrow bucket: each count's eq-mask selects
    its table entry, ``out = Σ_c eq_c & (prev ? m[c,1] : m[c,0])``."""
    out = torch.zeros_like(prev)
    for c in range(d_b + 1):
        eq = torch.full_like(prev, _FULL)
        for k, pl in enumerate(planes):
            eq = eq & ~(pl ^ (_FULL if (c >> k) & 1 else 0))
        m0 = masks_b[c, 0][:, None]
        m1 = masks_b[c, 1][:, None]
        out = out | (eq & ((prev & m1) | (~prev & m0)))
    return out


def _lut_bucket_out_counts(cnt, rows_b, prev):
    """LUT-route combine of one wide bucket from its integer counts: every
    (node, replica) lane reads ``rows[i, cnt, prev_bit]``."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=prev.device)
    prev_bits = ((prev[..., None] >> shifts) & 1).long()
    idx = torch.arange(rows_b.shape[0], dtype=torch.int64,
                       device=prev.device)[:, None, None]
    return _pack_lanes(rows_b[idx, cnt.long(), prev_bits].bool())


def _bucket_lut_masks(buckets: DegreeBuckets, rule, tie) -> tuple:
    """Per-bucket LUT tables from :func:`update_lut_rows` (rows of the
    bucket's own degrees only): narrow buckets get word masks
    ``int32[d_b+1, 2, n_b]`` (all ones or all zeros), wide buckets the raw
    rows ``uint8[n_b, d_b+1, 2]``."""
    from graphdyn_torch.ops.lut import update_lut_rows

    out = []
    for b, deg_b in enumerate(buckets.deg):
        rows = update_lut_rows(deg_b, buckets.widths[b], rule, tie)
        if buckets.widths[b] > UNROLL_MAX:
            out.append(np.ascontiguousarray(rows))
            continue
        out.append(np.where(rows.transpose(1, 2, 0).astype(bool),
                            np.int32(-1), np.int32(0)))
    return tuple(out)


def _word_mask(cond: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, _FULL, 0).to(torch.int32)[:, None]


class PlainBucketStep:
    """The plain PyTorch version of one bucket (or streamed chunk) update:
    the rows ``nbr: int32[rows, width]`` (slots past each row's degree are
    the ghost row) with degrees ``deg``, read from ``src`` (ghost-extended,
    ghost row zero) and combined with the rows' own words ``prev``. The
    comparator constants are built once."""

    def __init__(self, nbr, deg, rule, tie, route: str = "comparator",
                 lut=None):
        if route not in ROUTES:
            raise ValueError(
                f"route must be 'comparator' or 'lut', got {route!r}")
        self.nbr, self.deg = nbr, deg
        self.rule, self.tie, self.route = Rule(rule), TieBreak(tie), route
        self.width = nbr.shape[1]
        self.wide = self.width > UNROLL_MAX
        self.lut = lut
        if self.wide:
            self.deg_col = deg.to(torch.int32)[:, None, None]
            return
        self.n_planes = max(self.width.bit_length(), 1)
        thr = deg // 2
        self.thr_bits = [_word_mask((thr >> k) & 1 == 1)
                         for k in range(self.n_planes)]
        self.even = _word_mask(deg % 2 == 0)

    def _wide(self, src, nbr, deg_col, prev, lut):
        cnt = _wide_bucket_counts(src, nbr)
        if self.route == "lut":
            return _lut_bucket_out_counts(cnt, lut, prev)
        two = 2 * cnt
        # 2·cnt > deg ⇔ cnt > ⌊deg/2⌋; 2·cnt == deg is the even tie
        return _rule_tie_combine(
            _pack_lanes(two > deg_col), _pack_lanes(two == deg_col), prev,
            self.rule, self.tie)

    def __call__(self, src, prev):
        if self.wide:
            # the [rows·width/32, W, 32] count temporaries, cut into row
            # chunks of at most _TEMP_BYTES each
            # graftlint: disable-next-line=GD016  row-chunk budget of a temporary (_row_chunk), not a byte model of the card
            rows = _row_chunk(8 * self.width * src.shape[1] * WORD)
            outs = [self._wide(src, self.nbr[r:r + rows],
                               self.deg_col[r:r + rows], prev[r:r + rows],
                               None if self.lut is None
                               else self.lut[r:r + rows])
                    for r in range(0, self.nbr.shape[0], rows)]
            return torch.cat(outs) if len(outs) != 1 else outs[0]
        planes = _csa_bucket(src, self.nbr, self.n_planes)
        if self.route == "lut":
            return _lut_bucket_out(planes, self.lut, prev, self.n_planes,
                                   self.width)
        gt, eq = _compare_planes(planes, self.thr_bits)
        return _rule_tie_combine(gt, eq & self.even, prev, self.rule,
                                 self.tie)


def device_buckets(buckets: DegreeBuckets, device) -> list:
    """Each bucket's ``(nbr, deg, row0)`` as int32 tensors on ``device``
    (``row0`` is its first row in the bucketed order)."""
    return [(torch.as_tensor(np.asarray(nb, np.int32), device=device),
             torch.as_tensor(np.asarray(dg, np.int32), device=device),
             int(buckets.offsets[b]))
            for b, (nb, dg) in enumerate(zip(buckets.nbr, buckets.deg))]


class PlainBucketedStep:
    """One synchronous step over every bucket, plain PyTorch: each bucket
    reads the old state, and the ghost row is written zero."""

    def __init__(self, tabs, rule, tie, route="comparator", luts=None):
        self.parts = [
            (row0, row0 + nb.shape[0],
             PlainBucketStep(nb, dg, rule, tie, route,
                             None if luts is None else luts[b]))
            for b, (nb, dg, row0) in enumerate(tabs)]

    def __call__(self, ext):
        outs = [step(ext, ext[a:z]) for a, z, step in self.parts]
        outs.append(ext.new_zeros((1, ext.shape[1])))
        return torch.cat(outs)


def check_buckets(buckets: DegreeBuckets) -> None:
    """The host check of the tables KB reads (the launches skip their
    device check): every neighbor id within ``[0, n]`` (n is the ghost row)
    and every degree within its bucket's width."""
    for nb, dg in zip(buckets.nbr, buckets.deg):
        if nb.size and (nb.min() < 0 or nb.max() > buckets.n
                        or dg.min() < 0 or dg.max() > nb.shape[1]):
            raise ValueError("degree-bucket tables out of range")


def _check_words(sp, n: int):
    if not isinstance(sp, torch.Tensor) or sp.dtype != torch.int32 \
            or sp.ndim != 2 or sp.shape[0] != n:
        raise ValueError(
            f"sp must be torch.int32[n={n}, W] packed words, got "
            f"{getattr(sp, 'dtype', type(sp))} "
            f"{tuple(getattr(sp, 'shape', ()))}")


#: the device tables of the layouts rolled last, ``(device, id(layout))``
#: -> ``(layout, tabs, launches)``; a rollout is called once per chunk of
#: steps, and would otherwise upload and check its tables on every call
_DEVICE_LAYOUTS: OrderedDict = OrderedDict()
_DEVICE_LAYOUTS_MAX = 4
_layouts_lock = threading.Lock()


def _device_layout(buckets: DegreeBuckets, device) -> tuple:
    """``(tabs, launches)`` of ``buckets`` on ``device``: the tables of
    :func:`device_buckets` (host-checked on the card, :func:`check_buckets`)
    and the dict of KB launches made over them, built at the layout's first
    rollout on that device and kept for the last
    :data:`_DEVICE_LAYOUTS_MAX` layouts. A layout is not to be edited in
    place once rolled."""
    key = (torch.device(device), id(buckets))
    with _layouts_lock:
        hit = _DEVICE_LAYOUTS.get(key)
        if hit is not None and hit[0] is buckets:
            _DEVICE_LAYOUTS.move_to_end(key)
            return hit[1], hit[2]
    if key[0].type == "cuda":
        check_buckets(buckets)
    entry = (buckets, device_buckets(buckets, key[0]), {})
    with _layouts_lock:
        _DEVICE_LAYOUTS[key] = entry
        _DEVICE_LAYOUTS.move_to_end(key)
        while len(_DEVICE_LAYOUTS) > _DEVICE_LAYOUTS_MAX:
            _DEVICE_LAYOUTS.popitem(last=False)
    return entry[1], entry[2]


def _stepper(buckets: DegreeBuckets, device, rule, tie, route, plain):
    """The step for ``device``: KB on CUDA under the comparator route
    (unless ``plain``), the plain version on the CPU or under
    ``route='lut'``. Any other device raises."""
    if route not in ROUTES:
        raise ValueError(
            f"route must be 'comparator' or 'lut', got {route!r}")
    Rule(rule), TieBreak(tie)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"bucketed rollout runs on cuda or cpu, not {device}")
    tabs, launches = _device_layout(buckets, device)
    if route == "lut":
        luts = [torch.as_tensor(m, device=device)
                for m in _bucket_lut_masks(buckets, rule, tie)]
        return PlainBucketedStep(tabs, rule, tie, "lut", luts)
    if plain or device.type == "cpu":
        return PlainBucketedStep(tabs, rule, tie)
    return bucketed_cuda.KernelBucketedStep(
        tabs, n=buckets.n, rule=rule, tie=tie, check_tables=False,
        launches=launches)


def _rollout(buckets, sp, steps, rule, tie, route, plain):
    _check_words(sp, buckets.n)
    step = _stepper(buckets, sp.device, rule, tie, route, plain)
    if steps <= 0:
        return sp
    ext = torch.cat([sp, sp.new_zeros(1, sp.shape[1])])
    for _ in range(steps):
        ext = step(ext)
    return ext[: buckets.n]


def bucketed_rollout(buckets: DegreeBuckets, sp, steps: int,
                     rule: str = "majority", tie: str = "stay",
                     route: str = "comparator"):
    """Roll packed words ``sp: int32[n, W]`` (bucketed node order: old node
    ``buckets.order[k]`` in row ``k``) for ``steps`` synchronous updates.
    Equal to :func:`graphdyn_torch.ops.packed.packed_rollout` on the same
    graph modulo the permutation. On CUDA tensors the comparator route is
    one KB launch per step (two ``[n+1, W]`` buffers ping-ponged; the
    layout's tables go to the card at its first rollout there and stay,
    :func:`_device_layout`); on CPU tensors, and under ``route='lut'``, the
    plain version runs. ``sp`` is not written."""
    return _rollout(buckets, sp, steps, rule, tie, route, plain=False)


def bucketed_rollout_plain(buckets: DegreeBuckets, sp, steps: int,
                           rule: str = "majority", tie: str = "stay",
                           route: str = "comparator"):
    """The plain PyTorch version of :func:`bucketed_rollout` on any device:
    KB's yardstick on the card."""
    return _rollout(buckets, sp, steps, rule, tie, route, plain=True)


def bucketed_rollout_global(graph, sp, steps: int, rule: str = "majority",
                            tie: str = "stay", route: str = "comparator",
                            buckets: DegreeBuckets | None = None):
    """Global node order in and out: permute ``sp: int32[n, W]`` into the
    bucketed layout, roll (:func:`bucketed_rollout`), permute back. Pass
    ``buckets`` to reuse a layout."""
    b = buckets if buckets is not None else degree_buckets(graph)
    _check_words(sp, graph.n)
    order = torch.as_tensor(b.order, device=sp.device)
    inv = torch.as_tensor(b.inv, device=sp.device)
    out = bucketed_rollout(b, sp.index_select(0, order), steps, rule, tie,
                           route)
    return out.index_select(0, inv)
