"""Graph layer: ensembles and the padded neighbor table.

The port's copy of the parts of ``graphdyn/graphs.py`` that the packed
dynamics and consensus path uses. Construction stays host-side numpy, copied
line for line, so the same seed gives the same ``nbr``/``deg``/``edges``
arrays in both packages; the tables move to the device as torch tensors in
the callers (:mod:`graphdyn_torch.models.consensus`).

- ``Graph.nbr``: ``int32[n, dmax]`` neighbor table, rows padded with the ghost
  node index ``n`` (state is gathered through a zero-extended copy, so ghost
  slots contribute nothing to neighbor counts).
- ``Graph.deg``: ``int32[n]`` degrees; ``Graph.edges``: ``int32[E, 2]``.

The distance-2 coloring of the fused annealer (``power_graph``,
``greedy_coloring``, ``validate_coloring``) and the layout statistic
``degree_cv`` are copied line for line too, so the same seed gives the same
colours. Sampling methods other than the numpy ones (``networkx``,
``native``), and the buckets, partitions, relabelings and edge tables, come
with the slices of the port that use them (ROADMAP.md, queue A).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Graph(NamedTuple):
    """A simple undirected graph in padded-table form (host numpy arrays).

    Attributes:
      nbr:   int32[n, dmax] neighbor table padded with ghost index ``n``.
      deg:   int32[n] degrees.
      edges: int32[E, 2] undirected edge list.
    """

    nbr: np.ndarray
    deg: np.ndarray
    edges: np.ndarray

    @property
    def n(self) -> int:
        return self.nbr.shape[0]

    @property
    def dmax(self) -> int:
        return self.nbr.shape[1]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to graphdyn_torch yet; it comes with a later "
        "slice of the port (ROADMAP.md, queue A)"
    )


# ---------------------------------------------------------------------------
# Construction from an edge list
# ---------------------------------------------------------------------------


def _directed_endpoints(n: int, edges: np.ndarray):
    if edges.size and (edges.min() < 0 or edges.max() >= n):
        raise ValueError(
            f"edge endpoints must be in [0, {n}); got range "
            f"[{edges.min()}, {edges.max()}]"
        )
    u, v = edges[:, 0], edges[:, 1]
    src = np.concatenate([u, v]).astype(np.int64)
    dst = np.concatenate([v, u]).astype(np.int64)
    return src, dst


def _padded_slots(n: int, keys: np.ndarray, values: np.ndarray, width: int, fill):
    """Scatter ``values`` into an ``[n, width]`` table grouped by ``keys``.

    Stable within each group (original order preserved). Rows padded with
    ``fill``.
    """
    order = np.argsort(keys, kind="stable")
    k_sorted = keys[order]
    v_sorted = values[order]
    counts = np.bincount(k_sorted, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(k_sorted.size) - starts[k_sorted]
    table = np.full((n, width), fill, dtype=np.int64)
    table[k_sorted, rank] = v_sorted
    return table


def graph_from_edges(n: int, edges: np.ndarray, dmax: int | None = None) -> Graph:
    """Build the padded neighbor-table Graph from an undirected edge list."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    src, dst = _directed_endpoints(n, edges)
    deg = np.bincount(src, minlength=n)
    actual_max = max(int(deg.max(initial=0)), 1)
    if dmax is None:
        dmax = actual_max
    elif dmax < actual_max:
        raise ValueError(f"dmax={dmax} < max degree {actual_max}")
    nbr = _padded_slots(n, src, dst, dmax, fill=n)
    return Graph(
        nbr=nbr.astype(np.int32),
        deg=deg.astype(np.int32),
        edges=edges.astype(np.int32),
    )


def remove_isolates(graph: Graph) -> tuple[Graph, int]:
    """Drop isolated nodes, relabel to 0..n'-1; returns (subgraph, n_iso).

    Mirrors the analytic treatment of isolates in the BDCM entropy sweep
    (`ER_BDCM_entropy.ipynb:283-291`).
    """
    keep = graph.deg > 0
    n_iso = int((~keep).sum())
    if n_iso == 0:
        return graph, 0
    relabel = np.cumsum(keep) - 1
    edges = relabel[graph.edges.astype(np.int64)]
    return graph_from_edges(int(keep.sum()), edges), n_iso


# ---------------------------------------------------------------------------
# Ensembles
# ---------------------------------------------------------------------------


def _as_rng(seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def random_regular_graph(
    n: int,
    d: int,
    *,
    seed=None,
    method: str = "pairing",
    max_repair_rounds: int = 200,
) -> Graph:
    """Sample a d-regular simple graph on n nodes.

    ``method='pairing'``: configuration-model stub pairing with vectorized
    conflict repair — asymptotically uniform like the reference's
    `nx.random_regular_graph` (`SA_RRG.py:59-60`) and fast at N=10⁶.
    """
    if n * d % 2 != 0:
        raise ValueError("n*d must be even")
    if d >= n:
        raise ValueError("need d < n")
    if method != "pairing":
        raise _not_ported(f"random_regular_graph(method={method!r})")

    rng = _as_rng(seed)
    if d > (n - 1) // 2:
        # Dense degrees: stub re-pairing almost never finds a simple pairing.
        # Sample the (n-1-d)-regular complement instead (complement of a
        # simple regular graph is simple and regular).
        comp = random_regular_graph(n, n - 1 - d, seed=rng, method="pairing") \
            if n - 1 - d > 0 else None
        i, j = np.triu_indices(n, k=1)
        all_codes = i * n + j
        if comp is None:
            edges = np.stack([i, j], axis=1)
        else:
            ce = comp.edges.astype(np.int64)
            lo, hi = np.minimum(ce[:, 0], ce[:, 1]), np.maximum(ce[:, 0], ce[:, 1])
            keep = ~np.isin(all_codes, lo * n + hi)
            edges = np.stack([i[keep], j[keep]], axis=1)
        return graph_from_edges(n, edges, dmax=d)

    stubs = np.repeat(np.arange(n, dtype=np.int64), d)
    rng.shuffle(stubs)
    u, v = stubs[0::2].copy(), stubs[1::2].copy()
    E = u.size

    for _ in range(max_repair_rounds):
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        code = lo * n + hi
        selfloop = u == v
        # mark extra copies of duplicated edges (keep the first of each)
        order = np.argsort(code, kind="stable")
        sorted_code = code[order]
        dup_sorted = np.zeros(E, dtype=bool)
        dup_sorted[1:] = sorted_code[1:] == sorted_code[:-1]
        dup = np.zeros(E, dtype=bool)
        dup[order] = dup_sorted
        bad = selfloop | dup
        nbad = int(bad.sum())
        if nbad == 0:
            break
        # re-pair the bad stubs together with an equal number of good edges
        # (breaking up good edges avoids parity deadlocks)
        idx_bad = np.where(bad)[0]
        idx_good = np.where(~bad)[0]
        take = min(idx_good.size, max(nbad, 8))
        idx_pool = np.concatenate(
            [idx_bad, rng.choice(idx_good, size=take, replace=False)]
        )
        pool_stubs = np.concatenate([u[idx_pool], v[idx_pool]])
        rng.shuffle(pool_stubs)
        half = idx_pool.size
        u[idx_pool] = pool_stubs[:half]
        v[idx_pool] = pool_stubs[half:]
    else:
        raise RuntimeError("RRG repair did not converge; try another seed")

    return graph_from_edges(n, np.stack([u, v], axis=1), dmax=d)


def _decode_triu(code: np.ndarray, n: int):
    """Decode linear upper-triangle index k -> (i, j), i < j (vectorized)."""
    # float64 host math: sqrt in float32 loses the exact integer decode
    # above ~2^24 edges
    code = code.astype(np.float64)
    nn = 2 * n - 1
    i = np.floor((nn - np.sqrt(nn * nn - 8.0 * code)) / 2.0).astype(np.int64)
    # float guard: correct i by at most one in either direction
    for _ in range(2):
        start = i * (2 * n - i - 1) // 2
        i = np.where(start > code.astype(np.int64), i - 1, i)
        start = i * (2 * n - i - 1) // 2
        nexts = (i + 1) * (2 * n - i - 2) // 2
        i = np.where(code.astype(np.int64) >= nexts, i + 1, i)
    start = i * (2 * n - i - 1) // 2
    j = code.astype(np.int64) - start + i + 1
    return i, j


def erdos_renyi_graph(
    n: int,
    p: float,
    *,
    seed=None,
    method: str = "numpy",
) -> Graph:
    """Sample G(n, p) with an exact Binomial(M, p) edge count and a uniform
    edge subset (the reference draws `nx.fast_gnp_random_graph`,
    `ER_BDCM_entropy.ipynb:280`)."""
    if method != "numpy":
        raise _not_ported(f"erdos_renyi_graph(method={method!r})")

    rng = _as_rng(seed)
    M = n * (n - 1) // 2
    m = int(rng.binomial(M, p)) if p < 1.0 else M
    if m == 0:
        return graph_from_edges(n, np.empty((0, 2), dtype=np.int64))
    if m > M // 4 or M <= (1 << 22):
        # Dense (or small) regime: rejection sampling degrades to
        # coupon-collecting; draw an exact m-subset instead. O(M) memory,
        # which a dense edge list costs anyway.
        codes = rng.choice(M, size=m, replace=False)
    else:
        # Sparse regime: rejection-sample distinct pair codes from [0, M).
        codes = np.array([], dtype=np.int64)
        while codes.size < m:
            extra = rng.integers(0, M, size=int((m - codes.size) * 1.2) + 8)
            codes = np.unique(np.concatenate([codes, extra]))
        codes = rng.permutation(codes)[:m]
    i, j = _decode_triu(np.sort(codes), n)
    return graph_from_edges(n, np.stack([i, j], axis=1))


# ---------------------------------------------------------------------------
# Layout statistic and distance-2 coloring (the fused annealer's setup)
# ---------------------------------------------------------------------------


def degree_cv(deg) -> float:
    """Coefficient of variation of a degree sequence (std/mean, host
    float): ~0 for an RRG, ``1/sqrt(c)`` for ER(c), diverging with n for a
    power-law tail. ``fused_anneal(layout="auto")`` consults it through
    :func:`graphdyn_torch.ops.bucketed.auto_layout`."""
    deg = np.asarray(deg)
    if deg.size == 0:
        return 0.0
    mean = float(deg.mean())
    if mean <= 0.0:
        return 0.0
    return float(deg.std()) / mean


def power_graph(graph: Graph, radius: int) -> Graph:
    """The graph ``G^radius``: an edge between every pair of distinct nodes
    at distance ≤ ``radius`` in ``graph`` (host numpy, repeated
    neighbor-table expansion, O(n·dmax^radius) memory at build time). A
    proper coloring of ``G²`` puts same-colour nodes at distance ≥ 3, so
    their radius-1 update balls are disjoint."""
    if radius < 1:
        raise ValueError(f"radius must be >= 1, got {radius}")
    n = graph.n
    if radius == 1:
        return graph
    # frontier expansion over the ghost-extended table: ball[k] holds every
    # node at distance <= k (dense [n, width] with ghost padding)
    nbr = graph.nbr.astype(np.int64)
    ball = nbr
    for _ in range(radius - 1):
        nbr_ext = np.concatenate(
            [nbr, np.full((1, graph.dmax), n, np.int64)], axis=0
        )
        grown = nbr_ext[ball.reshape(-1)].reshape(n, -1)
        ball = np.concatenate([ball, grown], axis=1)
    src = np.repeat(np.arange(n, dtype=np.int64), ball.shape[1])
    dst = ball.reshape(-1)
    keep = (dst != n) & (src != dst)
    src, dst = src[keep], dst[keep]
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    codes = np.unique(lo * n + hi)
    edges = np.stack([codes // n, codes % n], axis=1)
    return graph_from_edges(n, edges)


def greedy_coloring(graph: Graph, *, seed: int = 0) -> np.ndarray:
    """Greedy proper node coloring, host numpy and deterministic per seed:
    nodes are visited highest-degree-first with a seeded jitter ordering
    equal degrees, each taking the smallest colour absent from its
    already-coloured neighbors. No monochromatic edge, and χ ≤ dmax + 1.

    Returns ``int32[n]`` colours in ``[0, χ)``. Distance-2 colorings come
    from ``greedy_coloring(power_graph(g, 2))``."""
    n = graph.n
    rng = np.random.default_rng(seed)
    jitter = rng.random(n)
    order = np.lexsort((jitter, -graph.deg.astype(np.int64)))
    colors = np.full(n, -1, np.int64)
    nbr = graph.nbr
    # smallest-free-colour scan: used[] sized dmax+2 so argmin always finds
    # a free slot within the chi <= dmax+1 bound
    width = graph.dmax + 2
    used = np.zeros(width, bool)
    for i in order:
        used[:] = False
        cs = colors[nbr[i][nbr[i] != n]]
        used[cs[cs >= 0]] = True
        colors[i] = int(np.argmin(used))
    return colors.astype(np.int32)


def validate_coloring(graph: Graph, colors: np.ndarray) -> list[str]:
    """Validity problems of a coloring for ``graph`` (empty list = valid):
    monochromatic edges, the χ ≤ dmax+1 greedy bound, out-of-range or
    non-contiguous colour ids. An invalid distance-2 coloring would make the
    whole-class update silently wrong, so the table builder refuses it."""
    problems = []
    colors = np.asarray(colors)
    if colors.shape != (graph.n,):
        return [f"colors shape {colors.shape} != ({graph.n},)"]
    e = graph.edges.astype(np.int64)
    if e.size:
        mono = int((colors[e[:, 0]] == colors[e[:, 1]]).sum())
        if mono:
            problems.append(f"{mono} monochromatic edge(s)")
    if colors.min(initial=0) < 0:
        problems.append("negative color id")
    chi = int(colors.max(initial=-1)) + 1
    if chi > graph.dmax + 1:
        problems.append(f"chi={chi} exceeds dmax+1={graph.dmax + 1}")
    if chi and len(np.unique(colors)) != chi:
        problems.append(f"non-contiguous color ids (chi={chi})")
    return problems
