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
colours. So are the BDCM message-passing tables (``EdgeTables``,
``build_edge_tables``, ``degree_classes``), the batched stack of same-size
graphs (``stack_graphs``), the disjoint union of arbitrary graphs
(``disjoint_union``, the entropy union's layout) and the replica-major
disjoint union (``replicate_disjoint``, ``replicate_edge_tables``). The
replica union also has a
device builder (``replicate_disjoint_device``,
``replicate_edge_tables_device``) that offset-tiles the base tables with
torch ops on the target device, so a large union never crosses the host
link. So are the ingestion of an external edge list (``from_edgelist``), the
power-law sampler (``powerlaw_graph``), the breadth-first relabeling
(``bfs_order``, ``permute_nodes``) and the degree-bucketed layout
(``DegreeBuckets``, ``degree_buckets``) of the power-law path. The
``networkx`` sampling methods import networkx inside the call (the machine
with the card has none); the ``native`` methods build the port's own copy of
the C++ sampler (:mod:`graphdyn_torch._native`) with g++ at first use. The
partitions of the node-sharded layouts come with ROADMAP.md A15.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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


class EdgeTables(NamedTuple):
    """Directed-edge tables for message passing (host numpy arrays, or int32
    torch tensors from the device union builder).

    Directed edge ``e < E`` is ``(src[e], dst[e]) = edges[e]``; ``e + E`` is
    the reversed edge. ``ghost_edge == 2E`` pads ragged rows.

    Attributes:
      src, dst:        int32[2E].
      edge_deg:        int32[2E], number of BP-incoming messages = deg(src)-1.
      in_edges:        int32[2E, dmax-1], incoming directed edges (k, src[e]),
                       k ∈ ∂src[e] \\ {dst[e]}, padded with 2E.
      node_in_edges:   int32[n, dmax], directed edges (k, i) into node i.
      node_out_edges:  int32[n, dmax], directed edges (i, k) out of node i.
      rev_map:         int32[2E] or None. None means the canonical halved
                       layout (reverse of e is (e+E) mod 2E); the
                       replica-major union carries the reversal explicitly.
    """

    src: np.ndarray
    dst: np.ndarray
    edge_deg: np.ndarray
    in_edges: np.ndarray
    node_in_edges: np.ndarray
    node_out_edges: np.ndarray
    rev_map: np.ndarray | None = None

    @property
    def num_directed(self) -> int:
        return self.src.shape[0]

    @property
    def num_edges(self) -> int:
        return self.src.shape[0] // 2

    def rev(self, e):
        if self.rev_map is not None:
            return self.rev_map[e]
        E = self.num_edges
        if E == 0:
            return e
        return (e + E) % (2 * E)


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


def build_edge_tables(graph: Graph) -> EdgeTables:
    """Build directed-edge message-passing tables for a Graph."""
    n, dmax = graph.n, graph.dmax
    edges = graph.edges.astype(np.int64)
    E = edges.shape[0]
    ghost_edge = 2 * E
    src, dst = _directed_endpoints(n, edges)
    eid = np.arange(2 * E, dtype=np.int64)

    node_in = _padded_slots(n, dst, eid, dmax, fill=ghost_edge)
    node_out = _padded_slots(n, src, eid, dmax, fill=ghost_edge)

    # Incoming messages of edge e: directed edges into src[e], minus rev(e).
    rev = (eid + E) % (2 * E)
    rows = node_in[src]                       # [2E, dmax]
    drop = (rows == rev[:, None]) | (rows == ghost_edge)
    order = np.argsort(drop, axis=1, kind="stable")  # keep (False) first
    kept = np.take_along_axis(rows, order, axis=1)
    kept_mask = np.take_along_axis(drop, order, axis=1)
    width = max(dmax - 1, 1)
    in_edges = np.where(kept_mask, ghost_edge, kept)[:, :width]

    edge_deg = graph.deg[src] - 1

    return EdgeTables(
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        edge_deg=edge_deg.astype(np.int32),
        in_edges=in_edges.astype(np.int32),
        node_in_edges=node_in.astype(np.int32),
        node_out_edges=node_out.astype(np.int32),
    )


def degree_classes(values: np.ndarray) -> dict[int, np.ndarray]:
    """Host-side grouping {degree: indices} (the notebook's degree classes,
    `ER_BDCM_entropy.ipynb:276-295`): each class is one static DP depth."""
    out: dict[int, np.ndarray] = {}
    for d in np.unique(values):
        out[int(d)] = np.where(values == d)[0].astype(np.int32)
    return out


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

    ``method='pairing'`` (default): configuration-model stub pairing with
    vectorized conflict repair — asymptotically uniform like the reference's
    `nx.random_regular_graph` (`SA_RRG.py:59-60`) and fast at N=10⁶.
    ``method='networkx'`` defers to networkx (imported here, only when asked)
    for sampling-parity runs; ``method='native'`` runs the C++ sampler.
    """
    if n * d % 2 != 0:
        raise ValueError("n*d must be even")
    if d >= n:
        raise ValueError("need d < n")
    if method == "networkx":
        import networkx as nx

        G = nx.random_regular_graph(d, n, seed=seed)
        return graph_from_edges(n, np.array(G.edges, dtype=np.int64))
    if method == "native":
        from graphdyn_torch._native import native_random_regular

        return graph_from_edges(n, native_random_regular(n, d, seed))

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
    edge subset. ``method='networkx'`` mirrors the reference's
    `nx.fast_gnp_random_graph` (`ER_BDCM_entropy.ipynb:280`; networkx is
    imported here, only when asked); ``method='native'`` runs the C++
    sampler."""
    if method == "networkx":
        import networkx as nx

        G = nx.fast_gnp_random_graph(n, p, seed=seed)
        edges = np.array(G.edges, dtype=np.int64).reshape(-1, 2)
        return graph_from_edges(n, edges)
    if method == "native":
        from graphdyn_torch._native import native_erdos_renyi

        return graph_from_edges(n, native_erdos_renyi(n, p, seed))

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


def from_edgelist(
    edges,
    *,
    n: int | None = None,
    dmax: int | None = None,
    strict: bool = False,
) -> Graph:
    """Ingest an external undirected edge list into the padded-table
    :class:`Graph`. Accepts an ``[E, 2]`` array or any iterable of ``(u,
    v)`` pairs. Self-loops are dropped and duplicate undirected edges
    (either orientation) keep their first occurrence in input order;
    ``strict=True`` raises ``ValueError`` naming the first offending rows
    instead. Endpoints outside ``[0, n)`` always raise. ``n`` defaults to
    ``max id + 1`` (it must be given for an empty list);
    ``from_edgelist(g.edges, n=g.n)`` reproduces ``g`` for a simple graph.
    """
    if isinstance(edges, np.ndarray):
        e = edges.astype(np.int64).reshape(-1, 2)
    else:
        e = np.array(list(edges), dtype=np.int64).reshape(-1, 2)
    if n is None:
        if e.size == 0:
            raise ValueError("empty edge list: pass n explicitly")
        if e.min() < 0:
            raise ValueError(
                "negative node id(s) in edge list: first offending rows "
                f"{e[(e < 0).any(axis=1)][:5].tolist()}"
            )
        n = int(e.max()) + 1
    if e.size:
        bad = (e < 0).any(axis=1) | (e >= n).any(axis=1)
        if bad.any():
            rows = np.flatnonzero(bad)
            raise ValueError(
                f"{rows.size} edge endpoint(s) outside [0, {n}): first at "
                f"input row(s) {rows[:5].tolist()} = "
                f"{e[rows[:5]].tolist()}; fix the ids or pass a larger n"
            )
    loops = e[:, 0] == e[:, 1] if e.size else np.zeros(0, bool)
    if strict and loops.any():
        rows = np.flatnonzero(loops)
        raise ValueError(
            f"strict edge list has {rows.size} self-loop(s): first at "
            f"input row(s) {rows[:5].tolist()} = "
            f"{e[rows[:5]].tolist()}; drop them upstream or call with "
            "strict=False to sanitize"
        )
    e = e[~loops]
    if e.size:
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        key = lo * max(n, 1) + hi
        uniq, first, counts = np.unique(
            key, return_index=True, return_counts=True)
        if strict and (counts > 1).any():
            dup_keys = uniq[counts > 1]
            order = np.argsort(first[counts > 1])
            ex = [[int(k) // max(n, 1), int(k) % max(n, 1)]
                  for k in dup_keys[order][:5]]
            raise ValueError(
                f"strict edge list has {dup_keys.size} duplicate "
                f"undirected edge(s) (counting either orientation): first "
                f"duplicated pair(s) {ex}; dedup upstream or call with "
                "strict=False to keep each pair's first occurrence"
            )
        e = e[np.sort(first)]                      # first occurrence kept
    return graph_from_edges(n, e, dmax=dmax)


def powerlaw_graph(
    n: int,
    *,
    gamma: float = 2.5,
    dmin: int = 2,
    dmax: int | None = None,
    seed=None,
    method: str = "configuration",
) -> Graph:
    """Sample a power-law (scale-free) graph on ``n`` nodes, the degree
    regime of opinion consensus on social networks, where one hub can have
    ``~n^(1/(γ−1))`` neighbors (the degree-bucketed layout of
    :func:`degree_buckets` is its fast path).

    ``method='configuration'`` (default): degrees drawn from ``P(k) ∝
    k^−γ`` on ``[dmin, dmax]`` (``dmax`` defaults to ``n−1``), stubs paired
    uniformly, self-loops and duplicate edges erased. ``method='ba'``:
    Barabási–Albert preferential attachment with ``dmin`` edges per new
    node, a Python loop for small graphs. Host numpy, deterministic per
    ``seed``: the same seed gives the JAX package's arrays.
    """
    if n < 2:
        raise ValueError(f"need n >= 2, got {n}")
    if dmin < 1:
        raise ValueError(f"dmin must be >= 1, got {dmin}")
    if gamma <= 1.0:
        raise ValueError(f"gamma must be > 1, got {gamma}")
    if dmax is None:
        dmax = n - 1
    if not dmin <= dmax <= n - 1:
        raise ValueError(f"need dmin <= dmax <= n-1, got [{dmin}, {dmax}]")
    rng = _as_rng(seed)
    if method == "ba":
        m = dmin
        if m >= n:
            raise ValueError(f"BA needs dmin < n, got dmin={dmin}, n={n}")
        # sampling uniformly from the endpoint multiset is degree-
        # proportional sampling
        repeated: list[int] = list(range(m))
        edges = []
        for v in range(m, n):
            chosen: set[int] = set()
            guard = 0
            while len(chosen) < m:
                guard += 1
                if guard > 64 * m:
                    # degenerate early multiset: draw the rest uniformly
                    pool = [u for u in range(v) if u not in chosen]
                    chosen.update(
                        int(u) for u in rng.choice(
                            pool, size=m - len(chosen), replace=False)
                    )
                    break
                chosen.add(int(repeated[int(rng.integers(len(repeated)))]))
            for u in chosen:
                edges.append((u, v))
                repeated.extend((u, v))
        return from_edgelist(np.array(edges, dtype=np.int64), n=n)
    if method != "configuration":
        raise ValueError(
            f"method must be 'configuration' or 'ba', got {method!r}"
        )
    ks = np.arange(dmin, dmax + 1, dtype=np.int64)
    w = ks ** (-gamma)
    deg = rng.choice(ks, size=n, p=w / w.sum())
    if deg.sum() % 2:                               # stub parity
        i = int(rng.integers(n))
        if (deg < dmax).any():
            while deg[i] >= dmax:                   # keep support [dmin, dmax]
                i = int(rng.integers(n))
            deg[i] += 1
        else:
            deg[i] -= 1                # dmin == dmax == every draw: shed one
    stubs = np.repeat(np.arange(n, dtype=np.int64), deg)
    rng.shuffle(stubs)
    u, v = stubs[0::2], stubs[1::2]
    keep = u != v                                   # erased: no self-loops
    u, v = u[keep], v[keep]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    _, first = np.unique(lo * n + hi, return_index=True)
    first = np.sort(first)                          # erased: dedup, stable
    return graph_from_edges(n, np.stack([lo[first], hi[first]], axis=1))


def bfs_order(graph: Graph) -> np.ndarray:
    """Breadth-first node ordering (frontier-vectorized; spans all
    components): ``order[k]`` is the old id of the node given new id ``k``.
    Under it a node's neighbours sit within a few frontier widths of each
    other, so the rows a step gathers lie near each other in device memory
    (B4 in ROADMAP.md measures what that buys the packed step). Dynamics
    are label-equivariant, so results only permute."""
    n = graph.n
    nbr = graph.nbr
    visited = np.zeros(n + 1, bool)
    visited[n] = True                      # ghost slot
    order = np.empty(n, np.int64)
    pos = 0
    scan = 0                               # next unvisited seed
    while pos < n:
        while scan < n and visited[scan]:
            scan += 1
        frontier = np.array([scan], np.int64)
        visited[scan] = True
        while frontier.size:
            order[pos : pos + frontier.size] = frontier
            pos += frontier.size
            nxt = np.unique(nbr[frontier].reshape(-1))
            nxt = nxt[~visited[nxt]]
            visited[nxt] = True
            frontier = nxt
    return order


def permute_nodes(graph: Graph, order: np.ndarray) -> tuple[Graph, np.ndarray]:
    """Relabel nodes so old node ``order[k]`` becomes new node ``k``.
    Returns ``(relabeled_graph, inv)`` with ``inv[old] = new``; a spin
    vector follows as ``s_new = s_old[..., order]``."""
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    new_edges = inv[graph.edges.astype(np.int64)]
    return graph_from_edges(graph.n, new_edges, dmax=graph.dmax), inv


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Vectorized ``int.bit_length`` (host int math, no float log2)."""
    v = np.asarray(v, dtype=np.int64)
    out = np.zeros(v.shape, np.int64)
    for k in range(63):
        bit = np.int64(1) << k
        out += v >= bit
        if not (v >= bit).any():
            break
    return out


class DegreeBuckets(NamedTuple):
    """Degree-bucketed node layout (host numpy), the power-law fast path.

    Nodes are permuted bucket-major into ``O(log dmax)`` power-of-two
    degree buckets: node ``i`` lands in bucket ``ceil(log2(deg_i))``
    (degrees 0 and 1 in bucket 0), so every node of a width-``2^b`` bucket
    has a degree in ``(2^(b-1), 2^b]`` and the bucket's neighbor block
    ``nbr[b]: int32[n_b, 2^b]`` pads each row at most 2x. Total entries are
    ``<= 4E + n_0`` where the padded table has ``n·dmax``. Neighbor entries
    are permuted node ids indexing the bucketed state order, ghost-padded
    with ``n``. Only non-empty buckets are kept.

    Attributes:
      n:       global node count.
      order:   int64[n] old id of the node in permuted slot k.
      inv:     int64[n] permuted slot of old node i.
      offsets: int64[B+1] bucket boundaries in the permuted order.
      widths:  tuple[int, ...] per-bucket padded width (powers of two,
               strictly increasing).
      nbr:     tuple of int32[n_b, width_b] per-bucket neighbor blocks.
      deg:     tuple of int32[n_b] per-bucket true degrees.
    """

    n: int
    order: np.ndarray
    inv: np.ndarray
    offsets: np.ndarray
    widths: tuple
    nbr: tuple
    deg: tuple

    @property
    def B(self) -> int:
        return len(self.widths)

    @property
    def table_entries(self) -> int:
        """Σ_b n_b · width_b, the bucketed analogue of ``n·dmax``."""
        return int(sum(t.shape[0] * t.shape[1] for t in self.nbr))


def degree_buckets(graph: Graph, *, seed: int | None = None) -> DegreeBuckets:
    """Build the :class:`DegreeBuckets` layout of ``graph`` (host numpy,
    deterministic): ``seed=None`` keeps the original order within each
    bucket, an int seed shuffles within buckets deterministically."""
    n = graph.n
    deg = graph.deg.astype(np.int64)
    bucket = _bit_length(np.maximum(deg - 1, 0))    # deg<=1 -> 0, else ceil(log2)
    if seed is None:
        order = np.argsort(bucket, kind="stable").astype(np.int64)
    else:
        jitter = np.random.default_rng(seed).random(n)
        order = np.lexsort((jitter, bucket)).astype(np.int64)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    # the ghost index n maps to itself
    inv_ext = np.concatenate([inv, [n]])

    present = np.unique(bucket)
    counts = np.array([(bucket == b).sum() for b in present], np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    widths, nbrs, degs = [], [], []
    for k, b in enumerate(present):
        ids = order[offsets[k]:offsets[k + 1]]
        w = 1 << int(b)
        take = min(w, graph.dmax)
        blk = inv_ext[graph.nbr[ids, :take].astype(np.int64)]
        if take < w:
            blk = np.concatenate(
                [blk, np.full((ids.size, w - take), n, np.int64)], axis=1
            )
        widths.append(w)
        nbrs.append(blk.astype(np.int32))
        degs.append(graph.deg[ids].astype(np.int32))
    return DegreeBuckets(
        n=n,
        order=order,
        inv=inv,
        offsets=offsets,
        widths=tuple(widths),
        nbr=tuple(nbrs),
        deg=tuple(degs),
    )


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


# ---------------------------------------------------------------------------
# Batched stacks and replica-major disjoint unions
# ---------------------------------------------------------------------------


class GraphStack(NamedTuple):
    """``G`` same-size graphs as one batched table set (host numpy arrays):
    member ``g``'s neighbor row block is ``nbr[g]``, ghost-padded to the
    stack-wide ``dmax`` with each member's OWN ghost index ``n`` (ghost rows
    contribute 0 to neighbor sums, so padding a member to a wider ``dmax``
    cannot change its dynamics)."""

    nbr: np.ndarray   # int32[G, n, dmax]
    deg: np.ndarray   # int32[G, n]

    @property
    def G(self) -> int:
        return self.nbr.shape[0]

    @property
    def n(self) -> int:
        return self.nbr.shape[1]

    @property
    def dmax(self) -> int:
        return self.nbr.shape[2]


def stack_graphs(graphs, dmax: int | None = None) -> GraphStack:
    """Stack same-``n`` graphs into the batched ``nbr[G, n, dmax]`` layout.
    Members with a smaller ``dmax`` are re-padded with their ghost index; a
    member wider than ``dmax`` is refused."""
    if not graphs:
        raise ValueError("empty graph stack")
    ns = {g.n for g in graphs}
    if len(ns) != 1:
        raise ValueError(f"stacked graphs must share n, got {sorted(ns)}")
    n = ns.pop()
    width = max(g.dmax for g in graphs)
    if dmax is None:
        dmax = width
    elif dmax < width:
        raise ValueError(f"dmax={dmax} < stack max degree width {width}")
    nbr = np.full((len(graphs), n, dmax), n, np.int32)
    for k, g in enumerate(graphs):
        nbr[k, :, : g.dmax] = g.nbr
    return GraphStack(
        nbr=nbr, deg=np.stack([g.deg for g in graphs]).astype(np.int32)
    )


def disjoint_union(graphs) -> tuple[Graph, np.ndarray, np.ndarray]:
    """Disjoint union of arbitrary graphs (graph k's nodes shifted by the
    cumulative node count). Returns ``(union, node_gid, edge_gid)``:
    ``node_gid[i]`` / ``edge_gid[e]`` is the member index of union node i /
    undirected union edge e (edges keep per-graph order, concatenated, so
    each member's nodes and edges are one contiguous block). The union's
    degree classes are the merged classes of its members."""
    G = len(graphs)
    if G == 0:
        raise ValueError("empty union")
    ns = [g.n for g in graphs]
    offs = np.cumsum([0] + ns)
    edges = [
        g.edges.astype(np.int64) + offs[k] for k, g in enumerate(graphs)
        if g.num_edges
    ]
    edges = (
        np.concatenate(edges) if edges else np.empty((0, 2), np.int64)
    )
    node_gid = np.repeat(np.arange(G), ns)
    edge_gid = np.repeat(np.arange(G), [g.num_edges for g in graphs])
    return graph_from_edges(int(offs[-1]), edges), node_gid, edge_gid


def replicate_disjoint(graph: Graph, R: int) -> Graph:
    """Disjoint union of ``R`` copies of ``graph`` (copy r occupies nodes
    ``[r*n, (r+1)*n)``), built by direct tiling of the base tables — equal
    to ``graph_from_edges`` over the shifted edge list, without its sort."""
    n = graph.n
    E = graph.num_edges
    dmax = graph.dmax
    noff = np.arange(R, dtype=np.int64) * n
    edges = (
        graph.edges.astype(np.int64)[None] + noff[:, None, None]
    ).reshape(R * E, 2)
    nbr = graph.nbr.astype(np.int64)
    # ghost slot n -> union ghost R*n; real neighbors shift per replica
    nbr_u = np.where(
        nbr[None] == n, R * n, nbr[None] + noff[:, None, None]
    ).reshape(R * n, dmax)
    return Graph(
        nbr=nbr_u.astype(np.int32),
        deg=np.tile(graph.deg, R).astype(np.int32),
        edges=edges.astype(np.int32),
    )


def replicate_edge_tables(tables: EdgeTables, R: int, n: int) -> EdgeTables:
    """Directed-edge tables for ``replicate_disjoint(g, R)`` in REPLICA-MAJOR
    edge layout: replica ``r``'s directed edges occupy rows
    ``[r·2E, (r+1)·2E)`` — copy ``r`` of the base tables with edge ids offset
    by ``r·2E`` and node ids by ``r·n``. Every index of replica ``r`` stays
    inside its own block; the reversal is carried in ``rev_map``."""
    twoE = tables.num_directed
    E = tables.num_edges
    ghost, ghost_u = twoE, R * twoE
    eoff = np.arange(R, dtype=np.int64) * twoE
    noff = np.arange(R, dtype=np.int64) * n

    def rep_edge_ids(t: np.ndarray) -> np.ndarray:
        """Tile a table of (ghost-padded) directed-edge ids across replicas."""
        t = t.astype(np.int64)
        off = eoff.reshape((R,) + (1,) * t.ndim)
        out = np.where(t[None] == ghost, ghost_u, t[None] + off)
        return out.reshape((R * t.shape[0],) + t.shape[1:]).astype(np.int32)

    src = (tables.src.astype(np.int64)[None] + noff[:, None]).reshape(-1)
    dst = (tables.dst.astype(np.int64)[None] + noff[:, None]).reshape(-1)
    base_rev = (np.arange(twoE, dtype=np.int64) + E) % max(twoE, 1)
    rev_map = (base_rev[None] + eoff[:, None]).reshape(-1)
    return EdgeTables(
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        edge_deg=np.tile(tables.edge_deg, R),
        in_edges=rep_edge_ids(tables.in_edges),
        node_in_edges=rep_edge_ids(tables.node_in_edges),
        node_out_edges=rep_edge_ids(tables.node_out_edges),
        rev_map=rev_map.astype(np.int32),
    )


def _check_i32(R: int, period: int):
    if R * period >= 2**31:
        raise ValueError(
            f"union ids exceed int32 (R={R} x period={period}); split the "
            "replicas across several smaller unions"
        )


def _rep_ids_device(t, R: int, period: int, ghost: int, ghost_u: int,
                    device) -> torch.Tensor:
    """Tile a table of (ghost-padded) ids across R replicas on ``device``:
    replica r's copy is offset by ``r·period``; ``ghost`` maps to
    ``ghost_u`` unshifted. Only the base table crosses to the device;
    int32 throughout (range-guarded)."""
    _check_i32(R, period)
    t = torch.as_tensor(np.asarray(t).astype(np.int32), device=device)
    off = (torch.arange(R, dtype=torch.int32, device=device) * period
           ).reshape((R,) + (1,) * t.ndim)
    out = torch.where(t == ghost, torch.tensor(ghost_u, dtype=torch.int32,
                                               device=device), t + off)
    return out.reshape((R * t.shape[0],) + tuple(t.shape[1:]))


def replicate_disjoint_device(graph: Graph, R: int, device) -> Graph:
    """:func:`replicate_disjoint` computed on ``device``: the returned
    ``Graph`` holds int32 torch tensors built by offset arithmetic from the
    base graph's host tables, so the union's ``[R·n, dmax]`` neighbor table
    never crosses the host link. Same layout as the host builder (tested
    equal)."""
    n = graph.n
    return Graph(
        nbr=_rep_ids_device(graph.nbr, R, n, n, R * n, device),
        deg=torch.as_tensor(graph.deg, dtype=torch.int32,
                            device=device).repeat(R),
        edges=_rep_ids_device(graph.edges, R, n, -1, -1, device),
    )


def replicate_edge_tables_device(tables: EdgeTables, R: int, n: int,
                                 device) -> EdgeTables:
    """:func:`replicate_edge_tables` computed on ``device`` (the same
    replica-major layout; int32 torch tensors). See
    :func:`replicate_disjoint_device` for why."""
    twoE = tables.num_directed
    E = tables.num_edges
    ghost, ghost_u = twoE, R * twoE
    base_rev = (np.arange(twoE, dtype=np.int64) + E) % max(twoE, 1)

    def rep(t, period, g, gu):
        return _rep_ids_device(t, R, period, g, gu, device)

    return EdgeTables(
        src=rep(tables.src, n, -1, -1),                 # no ghost nodes
        dst=rep(tables.dst, n, -1, -1),
        edge_deg=torch.as_tensor(tables.edge_deg, dtype=torch.int32,
                                 device=device).repeat(R),
        in_edges=rep(tables.in_edges, twoE, ghost, ghost_u),
        node_in_edges=rep(tables.node_in_edges, twoE, ghost, ghost_u),
        node_out_edges=rep(tables.node_out_edges, twoE, ghost, ghost_u),
        rev_map=rep(base_rev, twoE, -1, -1),
    )
