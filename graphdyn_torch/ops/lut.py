"""Per-degree update LUTs: the rule axis compiled to popcount tables (the
port of ``graphdyn/ops/lut.py``).

- :func:`update_lut` compiles one (rule, tie) pair into a
  ``uint8[dmax+1, dmax+1, 2]`` table: the next spin bit for every (degree,
  +1-neighbor count, current bit) triple.
- :func:`lut_node_masks` broadcasts a table against a graph's degree
  sequence into per-count word masks, and :func:`lut_one_step` applies them
  to the packed state: the carry-save counter produces the popcount, a
  per-count equality mask selects the count's table entry, and the entry is
  the next bit.

The table builders are host numpy, copied as they are, and return the
reference's dtypes (``uint8`` tables, ``uint32`` masks). On the device the
masks are ``torch.int32`` words with the same bit patterns
(:func:`graphdyn_torch.interop.words_from_numpy`), as the packed state is.
"""

from __future__ import annotations

import numpy as np
import torch

from graphdyn_torch.ops.dynamics import Rule, TieBreak, rule_coefficients
from graphdyn_torch.ops.packed import _FULL, _csa_add_one


def update_lut_rows(degs, max_cnt: int,
                    rule: Rule | str = Rule.MAJORITY,
                    tie: TieBreak | str = TieBreak.STAY) -> np.ndarray:
    """``uint8[len(degs), max_cnt+1, 2]``: the :func:`update_lut` rows for
    an explicit degree list (:func:`update_lut` is this function over
    ``arange(dmax+1)``)."""
    degs = np.asarray(degs, np.int64).reshape(-1)
    R, C = rule_coefficients(rule, tie)
    deg = degs[:, None, None]
    cnt = np.arange(max_cnt + 1, dtype=np.int64)[None, :, None]
    b = np.arange(2, dtype=np.int64)[None, None, :]
    # R·sign(2Σ + C·s) with Σ = 2·cnt − deg, s = 2b − 1 (see update_lut)
    val = R * np.sign(2 * (2 * cnt - deg) + C * (2 * b - 1))
    return ((val == 1) & (cnt <= deg)).astype(np.uint8)


def update_lut(dmax: int, rule: Rule | str = Rule.MAJORITY,
               tie: TieBreak | str = TieBreak.STAY) -> np.ndarray:
    """``uint8[dmax+1, dmax+1, 2]``: next spin bit for (degree ``deg``,
    +1-neighbor count ``cnt``, current bit ``b``). Entries with
    ``cnt > deg`` are unreachable and filled with 0.

    With spin ``s = 2b − 1`` and neighbor sum ``Σ = 2·cnt − deg``, one
    synchronous step is ``R·sign(2Σ + C·s)``; ``sign`` never returns 0 here
    because ``2Σ`` is even and ``C·s = ±1``.
    """
    if dmax < 0:
        raise ValueError(f"dmax must be >= 0, got {dmax}")
    return update_lut_rows(np.arange(dmax + 1), dmax, rule, tie)


def lut_node_masks(deg_ext: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Broadcast a ``[dmax+1, dmax+1, 2]`` table against the ghost-extended
    degree sequence ``deg_ext: int[n+1]`` into word masks
    ``uint32[dmax+1, 2, n+1]``: entry ``[cnt, b, i]`` is all-ones when
    ``lut[deg_i, cnt, b]`` else all-zeros. The ghost row's masks are zero
    (its word is forced back to zero every step anyway)."""
    deg_ext = np.asarray(deg_ext)
    dmax = lut.shape[0] - 1
    if int(deg_ext[:-1].max(initial=0)) > dmax:
        raise ValueError(
            f"degree sequence exceeds the table's dmax={dmax} "
            f"(max degree {int(deg_ext.max())})"
        )
    n1 = deg_ext.shape[0]
    masks = np.zeros((dmax + 1, 2, n1), np.uint32)
    for cnt in range(dmax + 1):
        for b in (0, 1):
            on = lut[np.minimum(deg_ext, dmax), cnt, b].astype(bool)
            masks[cnt, b, on] = np.uint32(0xFFFFFFFF)
    masks[:, :, n1 - 1] = 0          # ghost row: forced to zero anyway
    return masks


def _count_eq_masks(planes, dmax: int):
    """Equality masks ``eq[c]`` (c = 0..dmax) of the bit-plane counter
    against each constant count: all-ones bits where the per-replica
    popcount equals ``c``."""
    out = []
    for c in range(dmax + 1):
        eq = torch.full_like(planes[0], _FULL)
        for k, pl in enumerate(planes):
            eq = eq & pl if (c >> k) & 1 else eq & ~pl   # ~(pl ^ bit_k(c))
        out.append(eq)
    return out


def lut_one_step(sp_ext: torch.Tensor, nbr_ext: torch.Tensor,
                 lut_masks: torch.Tensor, *, n: int, dmax: int) -> torch.Tensor:
    """One synchronous packed update of the ghost-extended state
    ``int32[n+1, W]`` through the LUT masks (``int32[dmax+1, 2, n+1]`` on
    the state's device): carry-save popcount over the neighbor gather, then
    ``out = OR_c eq_c & (prev ? m[c,1] : m[c,0])``. The ghost word is
    forced back to zero. ``nbr_ext``: ``int[n+1, dmax]`` ghost-extended."""
    n_planes = max(int(dmax).bit_length(), 1)
    planes = [torch.zeros_like(sp_ext) for _ in range(n_planes)]
    idx = nbr_ext.long()
    for j in range(dmax):
        _csa_add_one(planes, sp_ext.index_select(0, idx[:, j]))
    eqs = _count_eq_masks(planes, dmax)
    out = torch.zeros_like(sp_ext)
    for c in range(dmax + 1):
        m0 = lut_masks[c, 0][:, None]
        m1 = lut_masks[c, 1][:, None]
        out = out | (eqs[c] & ((sp_ext & m1) | (~sp_ext & m0)))
    out[n] = 0
    return out
