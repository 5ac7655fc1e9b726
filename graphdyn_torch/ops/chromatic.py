"""Chromatic block Metropolis: a whole independent set per device step (the
port of ``graphdyn/ops/chromatic.py``).

A distance-2 coloring (``greedy_coloring(power_graph(g, 2))``) puts
same-colour sites at distance ≥ 3, so their radius-1 update balls are
disjoint: the per-site ΔE of a single flip stays exact when the whole class
flips together, and ``ΔΣs_end`` of site ``i`` is read off two one-step
evaluations, ``end(s)`` and ``end(s ⊕ class)``, by popcounts over the ball
``{i} ∪ N(i)``.

Words are ``torch.int32`` with the reference's uint32 bit patterns. The host
tables (:class:`ChromaticTables`) keep the reference's numpy dtypes, so a
field-by-field comparison with the JAX package is direct.

The chromatic chain (:class:`ChromState`, :func:`chromatic_chunk`, driven by
``search/chromatic.py``) draws its uniforms from the port's counter stream:
Threefry-2x32 keyed ``(seed, CHROM_STREAM_TAG + pair)``, counter ``(class
step, node)``, each block giving replicas ``2j, 2j+1`` of its node (the
fused stream's layout under another tag), so a sweep's draws depend only on
the seed and the class-step index. The reference draws them from
``jax.random``; injected uniforms (``uniforms=``) are the parity lever.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.ops.dynamics import Rule, TieBreak
from graphdyn_torch.ops.packed import (
    WORD,
    _FULL,
    _bit_counts,
    _compare_planes,
    _csa_add_one,
    _fold_u32,
    _inv_n,
    _rule_tie_combine,
    _stepper,
)


class ChromaticTables(NamedTuple):
    """Host-side setup of the chromatic class step (numpy arrays).

    Attributes:
      colors:      int32[n] distance-2 colour per node (proper on ``G²``).
      masks:       uint32[χ, n] word masks, all-ones where ``colors == c``.
      class_sizes: int64[χ] proposals per class step (the anneal exponents).
      nbr_self:    int32[n+1, dmax+1] ghost-extended ``{i} ∪ N(i)`` gather
                   table (slot 0 = self), ghost row all-ghost.
      nbr_ext:     int32[n+1, dmax] ghost-extended neighbor table.
      deg_ext:     int32[n+1] degrees with the 0-degree ghost row.
    """

    colors: np.ndarray
    masks: np.ndarray
    class_sizes: np.ndarray
    nbr_self: np.ndarray
    nbr_ext: np.ndarray
    deg_ext: np.ndarray

    @property
    def chi(self) -> int:
        return self.masks.shape[0]

    @property
    def n(self) -> int:
        return self.masks.shape[1]

    @property
    def dmax(self) -> int:
        return self.nbr_ext.shape[1]


def build_chromatic_tables(graph, *, seed: int = 0,
                           coloring=None) -> ChromaticTables:
    """Distance-2 coloring + gather tables for ``graph`` (deterministic per
    ``seed``). ``coloring`` is an optional precomputed ``(power_graph(graph,
    2), colors)`` pair, used in place of computing it here. Refuses an
    invalid coloring: a monochromatic ``G²`` edge would make the whole-class
    update silently wrong."""
    from graphdyn_torch.graphs import (
        greedy_coloring, power_graph, validate_coloring,
    )

    n = graph.n
    if coloring is None:
        g2 = power_graph(graph, 2)
        colors = greedy_coloring(g2, seed=seed)
    else:
        g2, colors = coloring
    problems = validate_coloring(g2, colors)
    if problems:
        raise ValueError(
            f"distance-2 coloring invalid for the chromatic kernel: "
            f"{problems} (greedy_coloring(power_graph(g, 2)) is the "
            f"supported construction)"
        )
    chi = int(colors.max(initial=-1)) + 1
    masks = np.zeros((chi, n), np.uint32)
    for c in range(chi):
        masks[c, colors == c] = np.uint32(0xFFFFFFFF)
    class_sizes = np.bincount(colors, minlength=chi).astype(np.int64)
    nbr_ext = np.concatenate(
        [graph.nbr.astype(np.int64),
         np.full((1, graph.dmax), n, np.int64)], axis=0,
    )
    self_col = np.concatenate([np.arange(n, dtype=np.int64), [n]])[:, None]
    nbr_self = np.concatenate([self_col, nbr_ext], axis=1)
    deg_ext = np.concatenate([graph.deg.astype(np.int64), [0]])
    return ChromaticTables(
        colors=colors.astype(np.int32),
        masks=masks,
        class_sizes=class_sizes,
        nbr_self=nbr_self.astype(np.int32),
        nbr_ext=nbr_ext.astype(np.int32),
        deg_ext=deg_ext.astype(np.int32),
    )


def _threshold_words(deg_ext: torch.Tensor, n_planes: int):
    """Per-node comparator constants of the packed update: threshold
    bit-plane masks ``[n+1, 1]`` and the even-degree tie mask."""

    def mask(cond):
        return torch.where(cond, _FULL, 0).to(torch.int32)[:, None]

    thr = deg_ext // 2
    thr_bits = [mask((thr >> k) & 1 == 1) for k in range(n_planes)]
    return thr_bits, mask(deg_ext % 2 == 0)


def _one_step(sp_ext, nbr_ext, thr_bits, even_mask, n: int, dmax: int,
              rule: Rule, tie: TieBreak):
    """One synchronous packed update on the ghost-extended state, from the
    shared carry-save + comparator helpers; the ghost word is forced back
    to zero. The same step as the CUDA packed-step kernel computes."""
    planes = [torch.zeros_like(sp_ext) for _ in thr_bits]
    idx = nbr_ext.long()
    for j in range(dmax):
        _csa_add_one(planes, sp_ext.index_select(0, idx[:, j]))
    gt, eq = _compare_planes(planes, thr_bits)
    out = _rule_tie_combine(gt, eq & even_mask, sp_ext, Rule(rule),
                            TieBreak(tie))
    out[n] = 0
    return out


def _expand_bits(words: torch.Tensor) -> torch.Tensor:
    """int32[rows, W] -> int32[rows, W·32] bits (replica r = bit r%32 of
    word r//32); the arithmetic shift is masked to one bit."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> shifts) & 1).reshape(words.shape[0], -1)


def _ball_counts(bits_ext: torch.Tensor, nbr_self: torch.Tensor):
    """Per-(row, replica) popcount of ``bits`` over ``{i} ∪ N(i)``: carry-save
    planes over the self+neighbor gather, expanded to int32 ``[rows, W·32]``
    counts (≤ dmax+1). ``rows`` is ``nbr_self``'s row count, so a row subset
    of the table gives the counts of those rows only."""
    slots = nbr_self.shape[1]
    n_planes = max(int(slots).bit_length(), 1)
    planes = [bits_ext.new_zeros((nbr_self.shape[0], bits_ext.shape[1]))
              for _ in range(n_planes)]
    idx = nbr_self.long()
    for j in range(slots):
        _csa_add_one(planes, bits_ext.index_select(0, idx[:, j]))
    tot = _expand_bits(planes[0])
    for k in range(1, n_planes):
        tot = tot + (_expand_bits(planes[k]) << k)
    return tot


def _unpack_pm1(sp: torch.Tensor) -> torch.Tensor:
    """int32[n, W] words -> int32[n, W·32] spins (±1) per replica column."""
    return 2 * _expand_bits(sp) - 1


def _pack_bool(acc: torch.Tensor, W: int) -> torch.Tensor:
    """bool[n, W·32] -> int32[n, W] words (bit r%32 of word r//32)."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=acc.device)
    b = acc.reshape(acc.shape[0], W, WORD).to(torch.int64) << shifts
    return _fold_u32(b.sum(dim=2))


def _delta_e(a, b, s_pm, dsend, n: int) -> torch.Tensor:
    """f32 ΔE of a single flip, ``(−2·a·s − b·dsend)/n``, in the order of
    operations the JAX package's compiled chain uses: ``−2·a·s`` (exact),
    ``b·dsend`` rounded, the difference rounded, then a multiplication by
    the f32 reciprocal of n (XLA rewrites the division by the constant n
    that way). Each op is one rounding: no multiply-add is contracted."""
    t = (-2.0 * a) * s_pm.to(torch.float32)
    return (t - b * dsend.to(torch.float32)) * _inv_n(n, t.device)


def accept_apply(sp_ext, end, end_all, u, class_mask, a, b, active,
                 nbr_self, *, n: int):
    """The exact-single-flip accept-and-apply core: ΔΣ of every class site
    read off the two one-step evaluations by disjoint-ball popcounts,
    per-(site, replica) Metropolis accepts against the caller's uniforms
    ``u: f32[n, Rp]``, accepted flips XORed into the words, and the additive
    per-replica ΔΣ total. ``class_mask`` is the unextended ``int32[n]``
    class word mask. Returns ``(sp_ext_new, acc, dsend_tot)``; ``sp_ext`` is
    not written."""
    up = end_all & ~end                    # j: end −1 → +1 under the flip
    dn = end & ~end_all
    dsend = 2 * (_ball_counts(up, nbr_self)[:n]
                 - _ball_counts(dn, nbr_self)[:n])      # int32 [n, Rp]
    delta_e = _delta_e(a[None, :], b[None, :], _unpack_pm1(sp_ext[:n]),
                       dsend, n)
    in_class = (class_mask != 0)[:, None]
    acc = (u < torch.exp(-delta_e)) & in_class & active[None, :]
    flips = _pack_bool(acc, sp_ext.shape[1])
    sp_new = sp_ext.clone()
    sp_new[:n] ^= flips
    dsend_tot = (dsend * acc.to(torch.int32)).sum(dim=0).to(torch.int32)
    return sp_new, acc, dsend_tot


@functools.lru_cache(maxsize=1)
def _libm_powf():
    """The C library's f32 ``powf``: the function XLA's CPU backend calls for
    an f32 ``power`` (its LLVM IR lowers ``llvm.pow.f32`` to a ``powf``
    call), so the same bits as the JAX package's ``par ** k``."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    return fn


@functools.lru_cache(maxsize=64)
def _factor_table(par: float, n: int, device: str) -> torch.Tensor:
    """f32 ``par ** k`` for k = 0..n as the JAX package's XLA f32 ``pow``
    computes it on the CPU (:func:`_libm_powf`; the correctly rounded power
    differs from it in the last bit on some exponents): a host table built
    once per (par, n, device), as the fused path's factor tables are."""
    powf = _libm_powf()
    base = float(np.float32(par))
    vals = np.array([powf(base, float(k)) for k in range(n + 1)], np.float32)
    return torch.from_numpy(vals).to(device)


def _anneal_factor(par: float, pow_: torch.Tensor, n: int) -> torch.Tensor:
    """``par ** pow_`` for integer exponents in ``[0, n]``, read from
    :func:`_factor_table` on ``pow_``'s device (no host read)."""
    table = _factor_table(float(par), int(n), str(pow_.device))
    return table[pow_.to(torch.int64)]


def class_update(sp_ext, u, mask_row, anneal_pow, a, b, active,
                 nbr_ext, nbr_self, thr_bits, even_mask, *,
                 n: int, dmax: int, rule: Rule, tie: TieBreak,
                 par_a: float, par_b: float, a_cap: float, b_cap: float):
    """One chromatic class step: propose flipping every site of the class,
    accept per site with the exact single-flip ΔE, then anneal by the
    class's proposal count (cap checked before the multiply).

    Returns ``(sp_ext_new, dsend_tot, a_new, b_new, n_accepted)``."""
    end = _one_step(sp_ext, nbr_ext, thr_bits, even_mask, n, dmax, rule, tie)
    flip_all = torch.cat([mask_row, mask_row.new_zeros(1)])
    end_all = _one_step(sp_ext ^ flip_all[:, None], nbr_ext, thr_bits,
                        even_mask, n, dmax, rule, tie)
    sp_new, acc, dsend_tot = accept_apply(
        sp_ext, end, end_all, u, mask_row, a, b, active, nbr_self, n=n,
    )
    fac_a = _anneal_factor(par_a, anneal_pow, n)
    fac_b = _anneal_factor(par_b, anneal_pow, n)
    # made on the device (a host tensor copied there would wait for it)
    a_cap = torch.full((), a_cap, dtype=torch.float32, device=a.device)
    b_cap = torch.full((), b_cap, dtype=torch.float32, device=b.device)
    a_new = torch.where(active & (a < a_cap), a * fac_a, a)
    b_new = torch.where(active & (b < b_cap), b * fac_b, b)
    n_acc = acc.sum().to(torch.int32)
    return sp_new, dsend_tot, a_new, b_new, n_acc


def replica_end_sums(sp, nbr_ext, deg_ext, n: int, dmax: int,
                     rule: str, tie: str) -> torch.Tensor:
    """int32 per-replica ``Σ s_end`` of the packed state ``int32[n, W]``
    (one synchronous step, then a column popcount): the ``sum_end``
    initializer. On a CUDA tensor the step is one launch of the packed-step
    kernel (:mod:`graphdyn_torch.ops.packed_cuda`); on the CPU it is
    :func:`_one_step`, which computes the same words."""
    nbr_ext = torch.as_tensor(nbr_ext, device=sp.device)
    deg_ext = torch.as_tensor(deg_ext, device=sp.device)
    sp_ext = torch.cat([sp, sp.new_zeros(1, sp.shape[1])])
    if sp.device.type == "cuda":
        step = _stepper(nbr_ext[:n].to(torch.int32).contiguous(),
                        deg_ext[:n].to(torch.int32).contiguous(), rule, tie)
        end = step(sp_ext)[:n]
    else:
        n_planes = max(int(dmax).bit_length(), 1)
        thr_bits, even_mask = _threshold_words(deg_ext, n_planes)
        end = _one_step(sp_ext, nbr_ext, thr_bits, even_mask, n, dmax,
                        Rule(rule), TieBreak(tie))[:n]
    return (2 * _bit_counts(end) - n).to(torch.int32)


#: key word 1 of the chromatic proposal stream is this tag plus the replica
#: pair (key word 0 is the run seed); the reference folds b"CROM" into its key
CHROM_STREAM_TAG = 0x43524F4D  # b"CROM"
_M32 = 0xFFFFFFFF


class ChromState(NamedTuple):
    """Carry of the chromatic annealer (replica axis padded to ``W·32``; pad
    replicas are frozen by ``active``)."""

    sp: torch.Tensor         # int32[n, W] words
    sum_end: torch.Tensor    # int32[Rp] — Σ s_end per replica (additive)
    a: torch.Tensor          # f32[Rp]
    b: torch.Tensor          # f32[Rp]
    steps: torch.Tensor      # int32[] — class steps taken
    sweeps: torch.Tensor     # int32[] — full sweeps taken
    t_target: torch.Tensor   # int32[Rp] — first-passage class step, −1
    active: torch.Tensor     # bool[Rp]
    accepted: torch.Tensor   # int32[] — cumulative accepted flips
    chunk_s: torch.Tensor    # int32[] — sweeps advanced this chunk


def sweep_uniforms(seed: int, steps0: torch.Tensor, colors: torch.Tensor,
                   Rp: int) -> torch.Tensor:
    """f32 ``[n, Rp]`` uniforms of one sweep that starts at class step
    ``steps0`` (a device scalar): node i's row is its draw at the class step
    of its own colour, ``steps0 + colors[i]``, so the rows a class step
    reads are that step's counter-stream uniforms."""
    from graphdyn_torch.ops.fused import _bits_to_uniform, threefry2x32

    n = colors.shape[0]
    node = torch.arange(n, dtype=torch.int64, device=colors.device)[:, None]
    pair = torch.arange(Rp // 2, dtype=torch.int64,
                        device=colors.device)[None, :]
    step = (steps0.to(torch.int64) + colors.to(torch.int64)[:, None]) & _M32
    y0, y1 = threefry2x32(int(seed) & _M32, CHROM_STREAM_TAG + pair, step,
                          node)
    u = torch.stack(torch.broadcast_tensors(y0, y1), dim=2)
    return _bits_to_uniform(u.reshape(n, Rp))


def chromatic_chunk(state: ChromState, seed: int, masks, class_sizes,
                    nbr_ext, nbr_self, deg_ext, *, n: int, dmax: int,
                    rule: str, tie: str, par_a: float, par_b: float,
                    a_cap: float, b_cap: float, target_sum: int,
                    chunk_sweeps: int, stop_on_first: bool = False,
                    uniforms=None) -> ChromState:
    """Advance ``chunk_sweeps`` full sweeps (each one class step per colour,
    in colour order) with no host read. A replica whose ``Σs_end`` reaches
    ``target_sum`` records its first-passage class step and freezes. A
    sweep starts only while a replica is active (and, with
    ``stop_on_first``, none has reached the target), as the reference's
    while loop tests per sweep; a sweep that does not start is a no-op
    here, so the chunk gives the reference's state. The caller sets
    ``chunk_s`` to 0 before the call, as the reference's driver does.

    ``masks`` int32[χ, n] word masks, ``class_sizes`` int[χ]; the tables are
    the :class:`ChromaticTables` fields as tensors on the state's device.
    ``uniforms``: ``None`` draws the counter stream
    (:func:`sweep_uniforms`); else an f32 ``[S, n, Rp]`` tensor whose row
    ``k`` is class step ``k``'s uniforms (injected, for parity tests)."""
    rule_e, tie_e = Rule(rule), TieBreak(tie)
    n_planes = max(int(dmax).bit_length(), 1)
    thr_bits, even_mask = _threshold_words(deg_ext, n_planes)
    chi = masks.shape[0]
    colors = (masks != 0).to(torch.int32).argmax(dim=0)
    Rp = state.a.shape[0]
    sp, sum_end, a, b = state.sp, state.sum_end, state.a, state.b
    steps, sweeps, t_tgt = state.steps, state.sweeps, state.t_target
    active, accepted, chunk_s = state.active, state.accepted, state.chunk_s
    zero_row = sp.new_zeros(1, sp.shape[1])
    for _ in range(chunk_sweeps):
        go = active.any()
        if stop_on_first:
            go = go & ~(t_tgt >= 0).any()
        if uniforms is None:
            u_sweep = sweep_uniforms(seed, steps, colors, Rp)
        for c in range(chi):
            if uniforms is None:
                u = u_sweep
            else:
                k = steps.clamp(max=uniforms.shape[0] - 1).reshape(1)
                u = uniforms.index_select(0, k.to(torch.int64))[0]
            live = active & go
            sp_ext, dsend_tot, a, b, n_acc = class_update(
                torch.cat([sp, zero_row]), u, masks[c], class_sizes[c], a, b,
                live, nbr_ext, nbr_self, thr_bits, even_mask, n=n, dmax=dmax,
                rule=rule_e, tie=tie_e, par_a=par_a, par_b=par_b,
                a_cap=a_cap, b_cap=b_cap)
            sp = sp_ext[:n]
            sum_end = sum_end + dsend_tot
            steps = steps + go.to(torch.int32)
            hit = live & (sum_end >= target_sum)
            t_tgt = torch.where(hit, steps, t_tgt)
            active = active & ~hit
            accepted = accepted + n_acc
        sweeps = sweeps + go.to(torch.int32)
        chunk_s = chunk_s + go.to(torch.int32)
    return ChromState(sp, sum_end, a, b, steps, sweeps, t_tgt, active,
                      accepted, chunk_s)
