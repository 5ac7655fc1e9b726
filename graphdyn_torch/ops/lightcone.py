"""Light-cone SA proposal evaluation, O(ball) instead of O(n) per flip (the
port of ``graphdyn/ops/lightcone.py``).

Synchronous dynamics moves information one hop per step, so flipping spin i
at t=0 can change the trajectory only inside the radius-t ball around i, and
after ``R = p+c−1`` steps the end-state delta lives inside ``B_R(i)``. The
chain carries the full trajectory ``S[t], t=0..R`` of its current
configuration; a candidate rolls only the ball, gathering neighbor values
from the ball slots when the neighbor is inside the ball and from the cached
trajectory when it is outside. The end-sum delta is the sum of (new −
cached) over the ball, and an accepted flip scatters the ball columns back
into the cache. Integer arithmetic throughout, so the chain is bit-identical
to the full-rollout chain.

Tables (:class:`LightconeTables`): ``ball[n, B]`` (ball node ids, self at
slot 0, ghost id n as padding), ``nbr_slot[n, B, dmax]`` (each ball node's
neighbors as ball slots, −1 outside) and ``nbr_glob[n, B, dmax]`` (the same
neighbors as global ids, ghost n as padding). The trajectory is ``int8[R,
T+1, n+2]``: column n is the ghost (always 0), column n+1 the trash column
that rejected flips scatter into.

The host builder (:func:`build_lightcone_tables`) is the reference's BFS;
the device builder (:func:`build_lightcone_tables_device`) is the
reference's sort-and-search construction in torch, on the tables' device.
Both give the JAX package's tables exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.utils.platform import resolve_device

_M32 = 0xFFFFFFFF


class LightconeTables(NamedTuple):
    ball: torch.Tensor       # int64[n, B], ball node ids, self at slot 0
    nbr_slot: torch.Tensor   # int64[n, B, dmax], ball slot of each neighbor, -1 outside
    nbr_glob: torch.Tensor   # int64[n, B, dmax], global id of each neighbor (n = ghost)
    radius: int
    ball_max: int


def _mul32(x, w):
    """``(x · w) mod 2³²`` for int64 values in ``[0, 2³²)``, in pieces whose
    products stay below 2⁴⁸ (no signed overflow)."""
    lo = x * (w & 0xFFFF)
    hi = ((x * (w >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _adjacency_checksums(nbr) -> tuple[int, int]:
    """Two position-weighted 32-bit checksums of a neighbor table (the
    reference's uint32 formulas), computed where the array lives: numpy on
    the host, torch on its device; only two scalars are read back."""
    if isinstance(nbr, torch.Tensor):
        flat = nbr.reshape(-1).to(torch.int64) & _M32
        pos = torch.arange(flat.shape[0], dtype=torch.int64, device=flat.device)
    else:
        flat = np.asarray(nbr).reshape(-1).astype(np.int64) & _M32
        pos = np.arange(flat.shape[0], dtype=np.int64)
    w1 = (_mul32(pos, 2654435761) + 0x9E3779B9) & _M32
    w2 = (_mul32(pos ^ 0x85EBCA6B, 2246822519) + 1) & _M32
    x = (flat + 1) & _M32
    c1 = _mul32(x, w1).sum() & _M32
    c2 = _mul32(x, w2).sum() & _M32
    return int(c1), int(c2)


def resolve_lightcone_tables(graph, radius: int, lc_tables=None,
                             device=None) -> LightconeTables:
    """Build tables for ``graph``/``radius`` on ``device``, or validate
    caller-supplied ones: slot 0 of every ball is the node itself, so
    ``nbr_glob[:, 0, :]`` is the adjacency the tables were built from, and
    its checksums must equal the graph's. A mismatched table would make the
    chain silently diverge, so it is refused. ``device`` defaults to CUDA."""
    device = resolve_device(device)
    if lc_tables is None:
        return build_lightcone_tables(graph, radius, device=device)
    if (
        lc_tables.radius != radius
        or lc_tables.ball.shape[0] != graph.n
        or lc_tables.nbr_glob.shape[2] != graph.nbr.shape[1]
        or _adjacency_checksums(lc_tables.nbr_glob[:, 0, :])
        != _adjacency_checksums(graph.nbr)
    ):
        raise ValueError(
            f"lc_tables were built for a different graph or radius "
            f"(tables: radius={lc_tables.radius}, "
            f"n={lc_tables.ball.shape[0]}; run: radius={radius} "
            f"(p+c-1), n={graph.n}); rebuild with build_lightcone_tables"
        )
    return LightconeTables(*(t.to(device) for t in lc_tables[:3]),
                           lc_tables.radius, lc_tables.ball_max)


def build_lightcone_tables(graph, radius: int,
                           device=None) -> LightconeTables:
    """Host BFS ball tables for every node (the reference's builder: BFS
    level order, each level sorted by id; ``B`` is the largest actual
    ball). O(n · ball) time and memory; the tables are moved to
    ``device`` (default CUDA)."""
    device = resolve_device(device)
    n = graph.n
    nbr = np.asarray(graph.nbr)
    dmax = nbr.shape[1]
    nbr_list = nbr.tolist()
    visited = [-1] * (n + 1)
    visited[n] = n + 1          # ghost: never admitted
    balls = []
    for i in range(n):
        visited[i] = i
        order = [i]
        frontier = [i]
        for _ in range(radius):
            nxt = []
            for j in frontier:
                for k in nbr_list[j]:
                    if visited[k] != i and k != n:
                        visited[k] = i
                        nxt.append(k)
            nxt.sort()
            order.extend(nxt)
            frontier = nxt
        balls.append(order)
    B = max(len(b) for b in balls)

    ball = np.full((n, B), n, np.int64)
    nbr_slot = np.full((n, B, dmax), -1, np.int64)
    nbr_glob = np.full((n, B, dmax), n, np.int64)
    slot_lookup = np.full(n + 1, -1, np.int64)    # ghost row n stays -1
    for i, order in enumerate(balls):
        L = len(order)
        ball[i, :L] = order
        nbr_glob[i, :L] = nbr[order]
        slot_lookup[order] = np.arange(L)
        nbr_slot[i, :L] = slot_lookup[nbr_glob[i, :L]]
        slot_lookup[order] = -1                   # O(ball) reset
    return LightconeTables(
        ball=torch.from_numpy(ball).to(device),
        nbr_slot=torch.from_numpy(nbr_slot).to(device),
        nbr_glob=torch.from_numpy(nbr_glob).to(device),
        radius=radius,
        ball_max=B,
    )


def ball_bound(dmax: int, radius: int) -> int:
    """Tree upper bound on the radius-``radius`` ball size at max degree
    ``dmax``: 1 + Σ_{k=1..r} dmax·(dmax−1)^{k−1}."""
    return 1 + sum(dmax * max(dmax - 1, 1) ** (k - 1)
                   for k in range(1, radius + 1))


def build_lightcone_tables_device(graph, radius: int,
                                  device=None) -> LightconeTables:
    """The ball tables built with torch on ``device`` (default CUDA;
    gathers, sorts and a row-wise binary search instead of the host BFS):
    only the ``[n, dmax]`` neighbor table is copied there.

    Per node i, as the reference's device builder: the radius-fold repeated
    neighbor gather from ``[i]`` (ghost n maps to itself), self-occurrences
    masked to ghost, sort and first-occurrence compaction, so the ball is
    ``{i}`` followed by the other members in ascending id order, padded to
    the tree bound ``B``; ``nbr_glob = nbr_ext[ball]``; ``nbr_slot`` by
    binary search in the sorted tail. Slot order differs from the host
    builder's, which the chain does not see (membership, self at slot 0 and
    self-consistency are all it reads). Refuses a build that would peak
    above ~8 GB (ragged graphs: the tree bound pads every row to the
    widest ball)."""
    device = resolve_device(device)
    n = graph.n
    nbr = torch.as_tensor(np.asarray(graph.nbr), device=device).to(torch.int64)
    dmax = int(nbr.shape[1])
    B = ball_bound(dmax, radius)
    build_bytes = 4 * n * B * (1 + 6 * dmax)
    if build_bytes > 8e9:
        raise ValueError(
            f"device ball-table build would peak at ~{build_bytes / 1e9:.0f}"
            f" GB (tree bound B={B} at dmax={dmax}, radius={radius}, n={n})"
            " — too ragged for the device builder's static padding; use "
            "build_lightcone_tables (host BFS, actual-ball-sized tables)"
        )
    nbr_ext = torch.cat([nbr, nbr.new_full((1, dmax), n)])
    ids = torch.arange(n, dtype=torch.int64, device=nbr.device)
    cand = ids[:, None]
    frontier = cand
    for _ in range(radius):
        frontier = nbr_ext[frontier].reshape(n, -1)
        cand = torch.cat([cand, frontier], dim=1)
    cand = torch.where(cand == ids[:, None], n, cand)
    srt = torch.sort(cand, dim=1).values              # ghosts (n) sort last
    first = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=nbr.device),
                       srt[:, 1:] != srt[:, :-1]], dim=1)
    uniq = torch.sort(torch.where(first & (srt < n), srt, n), dim=1).values
    tail = uniq[:, :B - 1].contiguous()               # ascending, ghost-padded
    ball = torch.cat([ids[:, None], tail], dim=1)     # [n, B]
    nbr_glob = nbr_ext[ball]                          # [n, B, dmax]
    q = nbr_glob.reshape(n, -1)
    pos = torch.searchsorted(tail, q.contiguous())
    hit = (q < n) & (pos < B - 1) & (
        torch.gather(tail, 1, pos.clamp(max=B - 2)) == q)
    slot = torch.where(hit, pos + 1, -1)              # tail slots start at 1
    slot = torch.where(q == ids[:, None], 0, slot)    # self -> slot 0
    return LightconeTables(
        ball=ball, nbr_slot=slot.reshape(n, B, dmax), nbr_glob=nbr_glob,
        radius=radius, ball_max=B,
    )


def _neighbor_index(nbr, n: int) -> torch.Tensor:
    """Flat gather index ``int64[rows, (n+1)·dmax]`` of the ghost-extended
    neighbor tables ``nbr`` (``[n, dmax]`` for one graph, ``[G, n, dmax]``
    for one graph per row): row g's entries are offsets into its own
    ``[n+1]`` state row; the ghost row n gathers the ghost."""
    nbr = torch.as_tensor(nbr).to(torch.int64)
    if nbr.ndim == 2:
        nbr = nbr[None]
    G, _, dmax = nbr.shape
    ext = torch.cat([nbr, nbr.new_full((G, 1, dmax), n)], dim=1)
    return ext.reshape(G, -1)


def rollout_ext(s_ext: torch.Tensor, idx: torch.Tensor, steps: int,
                R_coef: int, C_coef: int) -> torch.Tensor:
    """``steps`` synchronous updates of the ghost-extended spins ``int8[R,
    n+1]`` through the gather index of :func:`_neighbor_index` (one row, or
    one per state row): the reference's ``batched_rollout_impl`` arithmetic,
    ``R·sign(2·Σ s_nbr + C·s)``. The ghost column stays 0."""
    R, n1 = s_ext.shape
    idx = idx.expand(R, -1)
    dmax = idx.shape[1] // n1
    for _ in range(steps):
        sums = torch.gather(s_ext, 1, idx).view(R, n1, dmax).sum(
            dim=2, dtype=torch.int32)
        s_ext = (R_coef * torch.sign(2 * sums + C_coef * s_ext)).to(torch.int8)
    return s_ext


def batched_trajectory(nbr, s: torch.Tensor, steps: int, R_coef: int,
                       C_coef: int) -> torch.Tensor:
    """The trajectory cache ``int8[R, steps+1, n+2]`` of the batched rollout
    of ``s: int8[R, n]``: frames 0..steps, then the ghost column n and the
    trash column n+1, both 0."""
    Rr, n = s.shape
    idx = _neighbor_index(torch.as_tensor(nbr, device=s.device), n)
    cur = torch.cat([s, s.new_zeros(Rr, 1)], dim=1)
    frames = [cur]
    for _ in range(steps):
        cur = rollout_ext(cur, idx, 1, R_coef, C_coef)
        frames.append(cur)
    traj = torch.stack(frames, dim=1)                       # [R, T+1, n+1]
    return torch.cat([traj, s.new_zeros(Rr, steps + 1, 1)], dim=2)


def lightcone_flip_delta(tables: LightconeTables, traj: torch.Tensor, i,
                         R_coef: int, C_coef: int, radius: int):
    """Roll only the ball of each replica's proposal ``i`` against its
    cached trajectory. ``traj: int8[R, T+1, n+2]``, ``i: int[R]``. Returns
    ``(delta int32[R], vstack int8[R, T+1, B])``: the end-sum change and the
    flipped ball's trajectory for the accept-time scatter (slot 0 is i)."""
    R = traj.shape[0]
    n = traj.shape[2] - 2
    i = i.to(torch.int64)
    ball = tables.ball[i]                               # [R, B]
    B = ball.shape[1]
    slots = tables.nbr_slot[i].reshape(R, -1)           # [R, B·d]
    globs = tables.nbr_glob[i].reshape(R, -1)
    dmax = slots.shape[1] // B
    mask = ball < n
    inside = slots >= 0
    slots_c = slots.clamp(min=0)
    v = torch.gather(traj[:, 0], 1, ball).to(torch.int32) * mask
    v[:, 0] = -v[:, 0]                                  # the candidate flip
    frames = [v]
    for t in range(radius):
        nbvals = torch.where(inside, torch.gather(v, 1, slots_c),
                             torch.gather(traj[:, t], 1, globs).to(torch.int32))
        sums = nbvals.view(R, B, dmax).sum(dim=2)
        v = torch.where(mask, R_coef * torch.sign(2 * sums + C_coef * v), 0)
        frames.append(v)
    end_cached = torch.gather(traj[:, radius], 1, ball).to(torch.int32)
    delta = torch.where(mask, frames[-1] - end_cached, 0).sum(
        dim=1, dtype=torch.int32)
    return delta, torch.stack(frames, dim=1).to(torch.int8)


def lightcone_accept(tables: LightconeTables, traj: torch.Tensor, i,
                     vstack: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Scatter accepted flips' ball trajectories into ``traj`` in place and
    return it. Rejected replicas scatter into the trash column n+1 (never
    read); accepted ghost slots write 0 into the ghost column, a no-op."""
    n = traj.shape[2] - 2
    ball = tables.ball[i.to(torch.int64)]               # [R, B]
    tgt = torch.where(do[:, None], ball, n + 1)
    traj.scatter_(2, tgt[:, None, :].expand(-1, traj.shape[1], -1), vstack)
    return traj

