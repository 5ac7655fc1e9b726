"""Synchronous spin dynamics on graphs, int8 spins (the port of
``graphdyn/ops/dynamics.py``).

One step is closed-form for every (rule, tie) pair and every degree sequence:

    out = R * sign(2 * Σ_{j∈∂i} s_j + C * s_i)

with ``R = -1`` for minority dynamics (else ``+1``) and
``C = R * (+1 for tie→stay, -1 for tie→change)``; ghost-padded neighbor slots
gather a zero, so ragged degrees need no special case.

This path is plain PyTorch on whatever device the tensors live on: the JAX
package computes it in XLA, not in a Pallas kernel, so it has no hand kernel.
The 32-replicas-per-word packed path (:mod:`graphdyn_torch.ops.packed`) is
the one with the CUDA kernel.
"""

from __future__ import annotations

import enum

import torch

from graphdyn_torch.analysis.contracts import contract
from graphdyn_torch.utils.platform import resolve_device


class Rule(str, enum.Enum):
    MAJORITY = "majority"
    MINORITY = "minority"


class TieBreak(str, enum.Enum):
    STAY = "stay"
    CHANGE = "change"


def rule_coefficients(rule: Rule | str, tie: TieBreak | str) -> tuple[int, int]:
    """(R, C) such that one step is ``R * sign(2*sums + C*s)``."""
    rule = Rule(rule)
    tie = TieBreak(tie)
    R = -1 if rule == Rule.MINORITY else 1
    C = R * (1 if tie == TieBreak.STAY else -1)
    return R, C


def neighbor_sums(nbr: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Σ_{j∈∂i} s_j via the ghost-padded gather. ``s``: int8[n] (±1),
    ``nbr``: int32[n, dmax] padded with n. Returns int32[n]."""
    s_ext = torch.cat([s.to(torch.int32), s.new_zeros(1, dtype=torch.int32)])
    return s_ext[nbr.long()].sum(dim=1, dtype=torch.int32)


def step_spins(
    nbr: torch.Tensor,
    s: torch.Tensor,
    rule: Rule | str = Rule.MAJORITY,
    tie: TieBreak | str = TieBreak.STAY,
) -> torch.Tensor:
    """One synchronous update. Exact integer arithmetic, any degree."""
    R, C = rule_coefficients(rule, tie)
    t = 2 * neighbor_sums(nbr, s) + C * s.to(torch.int32)
    return (R * torch.sign(t)).to(s.dtype)


@contract(nbr="int32[n,d]", s="int8[r,n]", ret="int8[r,n]")
def batched_rollout(nbr: torch.Tensor, s: torch.Tensor, steps: int,
                    rule: str = "majority", tie: str = "stay",
                    gather: str = "fused") -> torch.Tensor:
    """Roll a batch ``s: int8[R, n]`` for ``steps`` synchronous updates.

    ``gather`` selects the memory schedule (identical results — integer
    sums are order-exact):

    - ``"fused"``: one gather producing ``[R, n+1, dmax]`` int32, then
      row-summed;
    - ``"per_slot"``: one int8 ``[R, n+1]`` gather per neighbor slot,
      accumulated straight into the int32 sum — no ``[R, n, dmax]`` buffer.

    The ghost column n rides in the carry: it is self-neighbored, so its sum
    and spin stay 0 under every (rule, tie).
    """
    if gather not in ("fused", "per_slot"):
        raise ValueError(f"gather must be 'fused' or 'per_slot', got {gather!r}")
    R_coef, C_coef = rule_coefficients(rule, tie)
    if steps <= 0:
        return s
    dmax = nbr.shape[-1]
    n = s.shape[-1]
    nbr_ext = torch.cat(
        [nbr.long(), nbr.new_full((1, dmax), n, dtype=torch.long)], dim=0
    )
    flat_nbr = nbr_ext.reshape(-1)

    def sums_of(sb_ext):
        if gather == "per_slot":
            sums = torch.zeros(sb_ext.shape, dtype=torch.int32, device=s.device)
            for j in range(dmax):
                sums += sb_ext.index_select(1, nbr_ext[:, j]).to(torch.int32)
            return sums
        g = sb_ext.to(torch.int32).index_select(1, flat_nbr)
        return g.reshape(sb_ext.shape[0], n + 1, dmax).sum(dim=2, dtype=torch.int32)

    sb_ext = torch.cat([s, s.new_zeros(s.shape[0], 1)], dim=1)
    for _ in range(steps):
        t = 2 * sums_of(sb_ext) + C_coef * sb_ext.to(torch.int32)
        sb_ext = (R_coef * torch.sign(t)).to(torch.int8)
    return sb_ext[:, :n]


def run_dynamics(
    graph,
    init_spins,
    steps: int,
    rule: Rule | str = Rule.MAJORITY,
    tie: TieBreak | str = TieBreak.STAY,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Roll ``steps`` synchronous updates of ``init_spins`` (int8[n], or
    int8[R, n] for a replica batch) on ``graph`` (a
    :class:`~graphdyn_torch.graphs.Graph` or a raw neighbor table).

    Runs on ``device`` (default CUDA; see
    :func:`~graphdyn_torch.utils.platform.resolve_device`) and returns a
    tensor there.
    """
    dev = resolve_device(device)
    rule, tie = Rule(rule).value, TieBreak(tie).value
    nbr = torch.as_tensor(graph.nbr if hasattr(graph, "nbr") else graph,
                          dtype=torch.int32, device=dev)
    s = torch.as_tensor(init_spins, device=dev)
    if s.ndim == 2:
        return batched_rollout(nbr, s, steps, rule, tie)
    return _run_single(nbr, s, steps, rule, tie)


@contract(nbr="int32[n,d]", s0="int8[n]", ret="int8[n]")
def _run_single(nbr: torch.Tensor, s0: torch.Tensor, steps: int, rule: str,
                tie: str) -> torch.Tensor:
    s = s0
    for _ in range(max(steps, 0)):
        s = step_spins(nbr, s, rule, tie)
    return s


def end_state(
    graph,
    s0,
    p: int,
    c: int,
    rule: Rule | str = Rule.MAJORITY,
    tie: TieBreak | str = TieBreak.STAY,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """``s_endstate``: p+c-1 synchronous steps (`SA_RRG.py:23-26`)."""
    return run_dynamics(graph, s0, p + c - 1, rule, tie, device)
