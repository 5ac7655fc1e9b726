"""Bit-packed multi-replica dynamics (the port of ``graphdyn/ops/packed.py``).

32 replicas pack into each 32-bit word (spin +1 ↔ bit 1; replica r is bit
r%32 of word r//32), so one neighbor-row gather serves 32 replicas. The
per-node count of +1 neighbors is accumulated bitwise with a carry-save adder
over bit planes, and the rule/tie decision is a bitwise comparator of the
packed count against deg//2: with ``cnt`` the +1 neighbors and ``deg`` the
true degree, the signed sum ``2·cnt − deg`` is positive iff cnt > deg//2 and
zero iff deg is even and cnt == deg//2.

Words are ``torch.int32`` tensors carrying the JAX package's uint32 bit
patterns (torch's CPU build has no right shift for ``uint32``). Extracting a
bit as ``(x >> k) & 1`` is exact under the arithmetic shift; words are built
in int64 and folded into the int32 range by value, never by a narrowing cast.

The step itself has two implementations that give the same words:

- the CUDA kernel (:mod:`graphdyn_torch.ops.packed_cuda`), which
  :func:`packed_rollout` launches for CUDA tensors — it raises rather than
  fall back when it cannot build or launch;
- the plain PyTorch version (:func:`packed_rollout_plain`: one
  ``index_select`` per neighbor slot folded into the carry-save planes, the
  form of the JAX package's per-slot XLA program), which
  :func:`packed_rollout` runs for CPU tensors and which the chip smoke test
  holds the kernel against on the card.

Both carry the ghost-extended state ``[n+1, W]``: ghost row n is zero, so
ghost-padded neighbor slots (index n) add nothing, and each step writes it
back to zero (under tie=change its degree-0 count ties and would flip).

Full-width temporaries are cut into row chunks of at most
``_TEMP_BYTES``: at n=10⁶ and W=512 the state alone is 2 GB, and an
``[n, W, 32]`` bit expansion would be 64 GB.
"""

from __future__ import annotations

import torch

from graphdyn_torch.ops import packed_cuda
from graphdyn_torch.ops.dynamics import Rule, TieBreak
from graphdyn_torch.utils.platform import resolve_device

WORD = 32
_FULL = -1                    # the all-ones word 0xFFFFFFFF as int32
_TEMP_BYTES = 256 << 20       # cap on one row-chunked temporary


def _row_chunk(bytes_per_row: int) -> int:
    """Rows per chunk so a temporary of ``bytes_per_row`` per row stays
    within ``_TEMP_BYTES``."""
    return max(1, _TEMP_BYTES // max(bytes_per_row, 1))


def _fold_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) -> int32 with the same 32-bit pattern, by
    value (x − 2³² for x ≥ 2³¹), so no cast ever narrows."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32)


def pack_spins(s) -> torch.Tensor:
    """int8[R, n] (±1) -> int32[n, W] words with W = ceil(R/32), on the
    input's device; replica r lives in word r//32, bit r%32; +1 ↔ 1. Pad
    replicas read as spin −1 and are sliced away by :func:`unpack_spins`."""
    s = torch.as_tensor(s)
    R, n = s.shape
    W = -(-R // WORD)
    out = torch.empty((n, W), dtype=torch.int32, device=s.device)
    shifts = torch.arange(WORD, dtype=torch.int64, device=s.device)
    rows = _row_chunk(2 * W * WORD * 8)
    for i0 in range(0, n, rows):
        bits = (s[:, i0:i0 + rows] == 1).T.to(torch.int64)      # [rc, R]
        rc = bits.shape[0]
        padded = torch.zeros((rc, W * WORD), dtype=torch.int64, device=s.device)
        padded[:, :R] = bits
        out[i0:i0 + rc] = _fold_u32(
            (padded.view(rc, W, WORD) << shifts).sum(dim=2)
        )
    return out


def unpack_spins(p: torch.Tensor, R: int) -> torch.Tensor:
    """int32[n, W] words -> int8[R, n] spins, on the input's device."""
    n, W = p.shape
    out = torch.empty((R, n), dtype=torch.int8, device=p.device)
    shifts = torch.arange(WORD, dtype=torch.int32, device=p.device)
    rows = _row_chunk(2 * W * WORD * 4)
    for i0 in range(0, n, rows):
        bits = (p[i0:i0 + rows, :, None] >> shifts) & 1        # [rc, W, 32]
        bits = bits.reshape(bits.shape[0], W * WORD)[:, :R]
        out[:, i0:i0 + bits.shape[0]] = (2 * bits - 1).to(torch.int8).T
    return out


def _csa_add_one(planes, carry):
    """Ripple one 1-bit addend (a packed word) into the bit-plane counter.
    Mutates ``planes``. The carry out of the top plane is dropped:
    ``n_planes = bit_length(dmax)`` makes overflow impossible."""
    for k in range(len(planes)):
        new_carry = planes[k] & carry
        planes[k] = planes[k] ^ carry
        carry = new_carry


def _compare_planes(planes, thr_bits):
    """Bitwise comparator: (gt, eq) of the packed counter vs a per-node
    threshold given as bit-plane masks (all-ones/all-zeros words)."""
    gt = torch.zeros_like(planes[0])
    eq = torch.full_like(planes[0], _FULL)
    for k in reversed(range(len(planes))):
        tk = thr_bits[k]
        gt = gt | (eq & planes[k] & ~tk)
        eq = eq & ~(planes[k] ^ tk)
    return gt, eq


def _rule_tie_combine(win, tie_mask, prev, rule: Rule, tie: TieBreak):
    """Combine the comparator outputs into next-step spin bits (``win`` =
    strictly positive sum, ``tie_mask`` = sum == 0, ``prev`` = current
    bits). The CUDA kernel's epilogue is this function, word for word."""
    tie_bit = prev if tie == TieBreak.STAY else ~prev
    out = win | (tie_mask & tie_bit)
    if rule == Rule.MINORITY:
        # minority: +1 iff sum<0, tie -> (stay: s, change: ~s)
        loss = ~(win | tie_mask)
        out = loss | (tie_mask & tie_bit)
    return out


def _check_tables(nbr: torch.Tensor, deg: torch.Tensor, sp: torch.Tensor):
    if nbr.dtype != torch.int32 or deg.dtype != torch.int32 \
            or sp.dtype != torch.int32:
        raise TypeError(
            "packed rollout takes int32 nbr, deg and words; got "
            f"{nbr.dtype}, {deg.dtype}, {sp.dtype}"
        )
    if not (nbr.device == deg.device == sp.device):
        raise ValueError(
            f"nbr, deg and sp must share a device; got {nbr.device}, "
            f"{deg.device}, {sp.device}"
        )
    if nbr.ndim != 2 or sp.ndim != 2 or sp.shape[0] != nbr.shape[0] \
            or tuple(deg.shape) != (nbr.shape[0],):
        raise ValueError(
            f"shapes must be nbr [n, dmax], deg [n], sp [n, W]; got "
            f"{tuple(nbr.shape)}, {tuple(deg.shape)}, {tuple(sp.shape)}"
        )


class _PlainStep:
    """The plain PyTorch step on the ghost-extended state: the per-slot
    gather + carry-save form of ``graphdyn/ops/packed.py:
    _packed_rollout_device``, with the tables extended once."""

    def __init__(self, nbr, deg, rule: Rule, tie: TieBreak):
        n, dmax = nbr.shape
        self.n, self.dmax, self.rule, self.tie = n, dmax, rule, tie
        self.nbr_ext = torch.cat(
            [nbr.long(), nbr.new_full((1, dmax), n, dtype=torch.long)]
        )
        deg_ext = torch.cat([deg, deg.new_zeros(1)])
        thr = deg_ext // 2

        def mask(cond):
            return torch.where(cond, _FULL, 0).to(torch.int32)[:, None]

        self.thr_bits = [mask((thr >> k) & 1 == 1)
                         for k in range(packed_cuda.n_planes(dmax))]
        self.even_mask = mask(deg_ext % 2 == 0)

    def __call__(self, ext):
        planes = [torch.zeros_like(ext) for _ in self.thr_bits]
        for j in range(self.dmax):
            _csa_add_one(planes, ext.index_select(0, self.nbr_ext[:, j]))
        gt, eq = _compare_planes(planes, self.thr_bits)
        out = _rule_tie_combine(gt, eq & self.even_mask, ext, self.rule,
                                self.tie)
        out[self.n] = 0                     # ghost word stays zero
        return out


class _KernelStep:
    """The CUDA kernel step: ping-pongs between the state it is given and
    one spare buffer of the same shape, allocated on first use. One launch
    per step on the current stream; nothing synchronises."""

    def __init__(self, nbr, deg, rule: Rule, tie: TieBreak):
        self.nbr, self.deg = nbr.contiguous(), deg.contiguous()
        packed_cuda.check_tables(self.nbr, self.deg)
        self.minority = rule == Rule.MINORITY
        self.change = tie == TieBreak.CHANGE
        self.d_uniform = packed_cuda.fast_path_degree(deg, rule.value)
        self.spare = None
        self.dims = None
        self.plan = None

    def __call__(self, ext):
        # the launch checks run when the spare is (re)allocated; after that
        # the buffers only swap, so each step is one unchecked launch
        if self.spare is None or self.spare.shape != ext.shape:
            self.spare = torch.empty_like(ext)
            self.dims = packed_cuda.check_launch(self.nbr, self.deg, ext,
                                                 self.spare)
            self.plan = packed_cuda.launch_plan(
                self.dims[2], aligned=packed_cuda.aligned16(ext, self.spare))
        packed_cuda._launch(self.nbr, self.deg, ext, self.spare, self.dims,
                            self.minority, self.change, self.d_uniform,
                            self.plan)
        out, self.spare = self.spare, ext
        return out


def _stepper(nbr, deg, rule, tie, plain: bool = False):
    """The step for the tables' device: the kernel on CUDA (unless
    ``plain``), the plain version on the CPU. Any other device raises."""
    rule, tie = Rule(rule), TieBreak(tie)
    if plain or nbr.device.type == "cpu":
        return _PlainStep(nbr, deg, rule, tie)
    if nbr.device.type == "cuda":
        return _KernelStep(nbr, deg, rule, tie)
    raise ValueError(f"packed rollout runs on cuda or cpu, not {nbr.device}")


def _rollout(nbr, deg, sp, steps, rule, tie, plain):
    _check_tables(nbr, deg, sp)
    step = _stepper(nbr, deg, rule, tie, plain)
    if steps <= 0:
        return sp
    ext = torch.cat([sp, sp.new_zeros(1, sp.shape[1])])
    for _ in range(steps):
        ext = step(ext)
    return ext[: sp.shape[0]]


def packed_rollout(nbr, deg, sp, steps: int, rule: str = "majority",
                   tie: str = "stay", partition=None, mesh=None):
    """Roll packed spins ``sp: int32[n, W]`` for ``steps`` synchronous
    updates. ``nbr: int32[n, dmax]`` ghost-padded with n; ``deg: int32[n]``.

    CUDA tensors go through the hand-written kernel (one launch per step,
    two ``[n+1, W]`` buffers allocated once and ping-ponged); CPU tensors
    through :func:`packed_rollout_plain`. The input ``sp`` is never written.
    ``partition``/``mesh`` (node sharding) come with a later slice of the
    port and are refused.
    """
    if partition is not None or mesh is not None:
        raise NotImplementedError(
            "packed_rollout(partition=, mesh=) is not ported yet: node "
            "sharding comes with slice 3 of the port (ROADMAP.md A15)"
        )
    return _rollout(nbr, deg, sp, steps, rule, tie, plain=False)


def packed_rollout_plain(nbr, deg, sp, steps: int, rule: str = "majority",
                         tie: str = "stay"):
    """The plain PyTorch version of :func:`packed_rollout` on any device:
    the kernel's yardstick on the card, the implementation on the CPU."""
    return _rollout(nbr, deg, sp, steps, rule, tie, plain=True)


def _bit_counts(sp: torch.Tensor) -> torch.Tensor:
    """int64[W*32]: per-replica count of +1 spins down each bit column,
    accumulated over row chunks (no [n, W, 32] expansion of the state)."""
    n, W = sp.shape
    shifts = torch.arange(WORD, dtype=torch.int32, device=sp.device)
    cnt = torch.zeros((W, WORD), dtype=torch.int64, device=sp.device)
    rows = _row_chunk(2 * W * WORD * 4)
    for i0 in range(0, n, rows):
        cnt += ((sp[i0:i0 + rows, :, None] >> shifts) & 1).sum(dim=0)
    return cnt.reshape(-1)


def _at_target(cnt: torch.Tensor, n: int, target: int) -> torch.Tensor:
    """bool flags from per-bit counts: the column is all-ones (target +1,
    count n) / all-zeros (any other target, count 0)."""
    return cnt == n if target == 1 else cnt == 0


def _pack_flags(flags: torch.Tensor) -> torch.Tensor:
    """bool[W*32] -> int32[W] bit flags (replica r = bit r%32 of word r//32)."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=flags.device)
    return _fold_u32((flags.view(-1, WORD).long() << shifts).sum(dim=1))


def packed_consensus_mask(sp: torch.Tensor, target: int = 1) -> torch.Tensor:
    """Per-replica consensus flags straight from the packed domain: replica
    r is at the homogeneous ``target`` state iff its bit column is all-ones
    (target +1) / all-zeros (target −1). torch has no AND/OR reduction, so
    the flags come from the per-bit counts: a column is all-ones iff its
    count is n and all-zeros iff it is 0. Returns int32[W] bit flags."""
    return _pack_flags(_at_target(_bit_counts(sp), sp.shape[0], target))


def packed_consensus_fraction(sp: torch.Tensor, n_replicas: int,
                              target: int = 1) -> float:
    """Fraction of replicas at the homogeneous ``target`` consensus. Pad
    replicas are excluded via ``n_replicas``."""
    if n_replicas > sp.shape[1] * WORD:
        raise ValueError(
            f"n_replicas={n_replicas} exceeds packed capacity "
            f"{sp.shape[1] * WORD} (W={sp.shape[1]} words)"
        )
    hit = _at_target(_bit_counts(sp)[:n_replicas], sp.shape[0], target)
    return float(hit.sum()) / n_replicas


def draw_packed_biased(seed: int, n: int, W: int, m0: float,
                       device: str | torch.device | None = None) -> torch.Tensor:
    """int32[n, W] packed spins drawn on ``device`` (default CUDA) with
    initial magnetization bias: each bit is +1 independently with
    probability (1+m0)/2, so E[m(0)] = m0 per replica
    (`ER_BDCM_entropy.ipynb:113-123`).

    Drawn from a ``torch.Generator`` seeded with ``seed`` on the device, in
    row chunks. The bits differ from the JAX package's ``jax.random`` draw for
    the same seed; only their statistics agree.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    p = (1.0 + m0) / 2.0
    out = torch.empty((n, W), dtype=torch.int32, device=dev)
    shifts = torch.arange(WORD, dtype=torch.int64, device=dev)
    rows = _row_chunk(3 * W * WORD * 8)
    for i0 in range(0, n, rows):
        rc = min(rows, n - i0)
        u = torch.rand((rc, W, WORD), generator=gen, device=dev)
        out[i0:i0 + rc] = _fold_u32(((u < p).long() << shifts).sum(dim=2))
    return out


def _inv_n(n: int, device) -> torch.Tensor:
    """The float32 reciprocal of n (1/n divided in float32): XLA rewrites a
    compiled division by the constant n into a multiplication by it, so the
    port multiplies by it wherever it holds a float to the JAX package's
    compiled program."""
    return (torch.ones((), dtype=torch.float32) / n).to(device)


def _magnetization_from_counts(cnt: torch.Tensor, n: int) -> torch.Tensor:
    """float32 m_r = (2·cnt_r − n)/n, computed as the JAX package's compiled
    program computes it (times :func:`_inv_n`), so that m_final and the
    near-consensus flags agree bit for bit."""
    return (2.0 * cnt.to(torch.float32) - n) * _inv_n(n, cnt.device)


def _consensus_bits(sp: torch.Tensor, R: int) -> torch.Tensor:
    """bool[R]: replica at EITHER homogeneous state (all +1 or all −1)."""
    cnt = _bit_counts(sp)[:R]
    return _at_target(cnt, sp.shape[0], 1) | _at_target(cnt, sp.shape[0], -1)


def _replica_magnetization(sp: torch.Tensor, R: int) -> torch.Tensor:
    """float32[R]: per-replica magnetization from the bit-column counts."""
    return _magnetization_from_counts(_bit_counts(sp)[:R], sp.shape[0])


def packed_consensus_scan(nbr, deg, sp, R: int, max_steps: int,
                          chunk: int = 10, near_eps: float = 0.01,
                          rule: str = "majority", tie: str = "stay") -> dict:
    """Roll packed replicas until every one has (near-)reached consensus or
    ``max_steps`` is spent, recording per-replica first-passage steps.

    Runs in ``chunk``-step slabs (first-passage resolution = chunk); after
    each slab two per-replica flags update from one pass of per-bit counts:

    - ``strict``: bit column homogeneous (count n or 0) — the absorbing
      all-+1/all-−1 state;
    - ``near``: |m_r| ≥ 1 − near_eps, compared in float32.

    The loop exits early once all ``R`` replicas are near-consensus. It is a
    host loop: the exit test reads one boolean back per slab, so the scan
    synchronises with the device once per ``chunk`` steps. ``R`` counts pad
    bits too when the caller passes R = W·32 (as :func:`consensus_point`
    does). Returns the final state and per-replica ``(strict, strict_step,
    near, near_step, m_final)``; unreached first passages are −1.
    ``steps_run`` is a Python int. ``sp`` is not written.

    ``chunk`` must divide ``max_steps``: the loop advances in whole slabs,
    so a non-dividing pair would run past the recorded budget — refused.
    """
    if max_steps % chunk:
        raise ValueError(
            f"chunk={chunk} must divide max_steps={max_steps} (the scan "
            "advances in whole chunks; a remainder would overshoot the "
            "recorded budget)"
        )
    _check_tables(nbr, deg, sp)
    n, W = sp.shape
    if R > W * WORD:
        raise ValueError(f"R={R} exceeds packed capacity {W * WORD}")
    dev = sp.device
    step = _stepper(nbr, deg, rule, tie)
    near_thr = torch.tensor(1.0 - near_eps, dtype=torch.float32, device=dev)
    ext = torch.cat([sp, sp.new_zeros(1, W)])
    strict = torch.zeros(R, dtype=torch.bool, device=dev)
    near = torch.zeros(R, dtype=torch.bool, device=dev)
    strict_t = torch.full((R,), -1, dtype=torch.int32, device=dev)
    near_t = torch.full((R,), -1, dtype=torch.int32, device=dev)
    t = 0
    while t < max_steps and not bool(near.all()):     # one sync per slab
        for _ in range(chunk):
            ext = step(ext)
        t += chunk
        cnt = _bit_counts(ext[:n])[:R]
        s_now = _at_target(cnt, n, 1) | _at_target(cnt, n, -1)
        n_now = _magnetization_from_counts(cnt, n).abs() >= near_thr
        t_now = torch.full_like(strict_t, t)
        strict_t = torch.where(s_now & ~strict, t_now, strict_t)
        near_t = torch.where(n_now & ~near, t_now, near_t)
        strict = strict | s_now
        near = near | n_now
    final = ext[:n]
    return {
        "sp": final, "steps_run": t,
        "strict": strict, "strict_step": strict_t,
        "near": near, "near_step": near_t,
        "m_final": _replica_magnetization(final, R),
    }


def packed_end_state(graph, s, steps: int, rule: str = "majority",
                     tie: str = "stay",
                     device: str | torch.device | None = None) -> torch.Tensor:
    """int8[R, n] spins in, int8[R, n] out through the packed rollout on
    ``device`` (default CUDA)."""
    dev = resolve_device(device)
    s = torch.as_tensor(s, device=dev)
    out = packed_rollout(
        torch.as_tensor(graph.nbr, dtype=torch.int32, device=dev),
        torch.as_tensor(graph.deg, dtype=torch.int32, device=dev),
        pack_spins(s), steps, rule, tie,
    )
    return unpack_spins(out, s.shape[0])
