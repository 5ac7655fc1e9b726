"""The rest of the port's graph layer against the JAX package's: the same
inputs and seeds give the same arrays, bit for bit (integer tables, no
tolerance) — ``from_edgelist`` across its sanitise and strict cases,
``powerlaw_graph`` (both methods, several seeds), ``bfs_order``,
``degree_buckets`` (seed None and an int), ``permute_nodes``, and the
``networkx`` and ``native`` sampling methods. Dynamics after
``permute_nodes`` equal the permuted dynamics."""

import numpy as np
import pytest
import torch

import graphdyn.graphs as jg
import graphdyn_torch.graphs as tg
from graphdyn_torch.interop import degree_buckets_from_jax
from graphdyn_torch.ops.packed import packed_rollout_plain


def _same_graph(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _same_buckets(a, b):
    assert a.n == b.n and a.widths == b.widths and a.B == b.B
    assert a.table_entries == b.table_entries
    for f in ("order", "inv", "offsets"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for f in ("nbr", "deg"):
        for x, y in zip(getattr(a, f), getattr(b, f)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


EDGELISTS = {
    "clean": np.array([[0, 1], [1, 2], [2, 3], [3, 0], [0, 2]]),
    "loops_and_dups": np.array([[0, 1], [1, 0], [2, 2], [1, 2], [0, 1],
                                [3, 1], [4, 4], [2, 1]]),
    "pairs_list": [(5, 1), (1, 5), (2, 3), (3, 3), (0, 4)],
    "empty_with_n": np.zeros((0, 2), np.int64),
}


@pytest.mark.parametrize("name", list(EDGELISTS))
def test_from_edgelist_sanitise_and_strict_match_jax(name):
    e = EDGELISTS[name]
    n = 6 if name == "empty_with_n" else None
    _same_graph(jg.from_edgelist(e, n=n), tg.from_edgelist(e, n=n))
    _same_graph(jg.from_edgelist(e, n=8, dmax=7),
                tg.from_edgelist(e, n=8, dmax=7))
    if name in ("clean", "empty_with_n"):
        _same_graph(jg.from_edgelist(e, n=n, strict=True),
                    tg.from_edgelist(e, n=n, strict=True))
        return
    for m in (jg, tg):
        with pytest.raises(ValueError, match="strict edge list"):
            m.from_edgelist(e, strict=True)


def test_from_edgelist_refusals_and_round_trip():
    for m in (jg, tg):
        with pytest.raises(ValueError, match="pass n explicitly"):
            m.from_edgelist([])
        with pytest.raises(ValueError, match="negative"):
            m.from_edgelist([(0, -1)])
        with pytest.raises(ValueError, match="outside"):
            m.from_edgelist([(0, 7)], n=5)
    g = tg.random_regular_graph(40, 3, seed=2)
    _same_graph(tg.from_edgelist(g.edges, n=g.n, strict=True), g)


@pytest.mark.parametrize("method", ["configuration", "ba"])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_powerlaw_graph_matches_jax(method, seed):
    kw = dict(gamma=2.3, dmin=2, seed=seed, method=method)
    _same_graph(jg.powerlaw_graph(300, **kw), tg.powerlaw_graph(300, **kw))
    kw = dict(gamma=2.8, dmin=1, dmax=20, seed=seed, method=method)
    _same_graph(jg.powerlaw_graph(120, **kw), tg.powerlaw_graph(120, **kw))


def test_powerlaw_graph_refusals_and_rng_passthrough():
    for m in (jg, tg):
        for kw, match in ((dict(n=1), "n >= 2"), (dict(n=10, dmin=0), "dmin"),
                          (dict(n=10, gamma=1.0), "gamma"),
                          (dict(n=10, dmin=4, dmax=3), "dmin <= dmax"),
                          (dict(n=10, method="x"), "method")):
            with pytest.raises(ValueError, match=match):
                m.powerlaw_graph(**kw)
    _same_graph(jg.powerlaw_graph(100, seed=np.random.default_rng(4)),
                tg.powerlaw_graph(100, seed=np.random.default_rng(4)))


LAYOUT_GRAPHS = {
    "powerlaw": lambda m: m.powerlaw_graph(600, gamma=2.3, dmin=2, seed=7),
    "er_ragged": lambda m: m.erdos_renyi_graph(200, 4.0 / 199, seed=3),
    "rrg": lambda m: m.random_regular_graph(100, 3, seed=1),
}


@pytest.mark.parametrize("gname", list(LAYOUT_GRAPHS))
def test_bfs_order_degree_buckets_and_permute_match_jax(gname):
    g_j, g_t = LAYOUT_GRAPHS[gname](jg), LAYOUT_GRAPHS[gname](tg)
    _same_graph(g_j, g_t)
    o_j, o_t = jg.bfs_order(g_j), tg.bfs_order(g_t)
    assert o_j.dtype == o_t.dtype
    np.testing.assert_array_equal(o_j, o_t)
    np.testing.assert_array_equal(np.sort(o_t), np.arange(g_t.n))
    for order in (o_t, np.random.default_rng(5).permutation(g_t.n)):
        (pj, inv_j), (pt, inv_t) = (jg.permute_nodes(g_j, order),
                                    tg.permute_nodes(g_t, order))
        _same_graph(pj, pt)
        np.testing.assert_array_equal(inv_j, inv_t)
    for seed in (None, 0, 11):
        b_j = jg.degree_buckets(g_j, seed=seed)
        b_t = tg.degree_buckets(g_t, seed=seed)
        _same_buckets(b_j, b_t)
        _same_buckets(degree_buckets_from_jax(b_j), b_t)
        # widths are powers of two, each row's degree in (w/2, w]
        for w, d in zip(b_t.widths, b_t.deg):
            assert w & (w - 1) == 0
            assert (d <= w).all() and (w == 1 or (d > w // 2).all())
        assert b_t.table_entries <= 4 * g_t.num_edges + g_t.n
    bl_j = jg._bit_length(np.arange(70))
    np.testing.assert_array_equal(bl_j, tg._bit_length(np.arange(70)))


def test_dynamics_after_permute_nodes_equal_permuted_dynamics():
    g = tg.powerlaw_graph(300, gamma=2.3, dmin=2, seed=2)
    rng = np.random.default_rng(0)
    sp = torch.from_numpy(rng.integers(-2**31, 2**31, size=(g.n, 2),
                                       dtype=np.int64).astype(np.int32))
    order = tg.bfs_order(g)
    gp, inv = tg.permute_nodes(g, order)

    def roll(gr, x):
        return packed_rollout_plain(torch.from_numpy(gr.nbr),
                                    torch.from_numpy(gr.deg), x, 4,
                                    "majority", "change")

    want = roll(g, sp)
    got = roll(gp, sp[torch.from_numpy(order)])
    assert torch.equal(got[torch.from_numpy(inv)], want)


@pytest.mark.parametrize("method", ["networkx", "native"])
def test_networkx_and_native_methods_match_jax(method):
    for seed in (0, 9):
        _same_graph(jg.random_regular_graph(60, 3, seed=seed, method=method),
                    tg.random_regular_graph(60, 3, seed=seed, method=method))
        _same_graph(jg.erdos_renyi_graph(80, 0.05, seed=seed, method=method),
                    tg.erdos_renyi_graph(80, 0.05, seed=seed, method=method))
