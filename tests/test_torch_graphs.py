"""The port's graph builders against the JAX package's: the same seed gives
identical ``nbr``/``deg``/``edges`` arrays (both are host numpy)."""

import numpy as np
import torch
import pytest

from graphdyn import graphs as jg
from graphdyn_torch import graphs as tg, interop


def _assert_same(a, b):
    np.testing.assert_array_equal(a.nbr, b.nbr)
    np.testing.assert_array_equal(a.deg, b.deg)
    np.testing.assert_array_equal(a.edges, b.edges)
    assert a.nbr.dtype == b.nbr.dtype == np.int32
    assert (a.n, a.dmax, a.num_edges) == (b.n, b.dmax, b.num_edges)


@pytest.mark.parametrize("n", [100, 1000])
@pytest.mark.parametrize("d", [3, 4])
def test_rrg_pairing_identical(n, d):
    _assert_same(jg.random_regular_graph(n, d, seed=7),
                 tg.random_regular_graph(n, d, seed=7))


@pytest.mark.parametrize("n,d", [(20, 15), (12, 11), (30, 20)])
def test_rrg_dense_complement_identical(n, d):
    # d > (n-1)//2 takes the complement branch (d = n-1: no complement)
    _assert_same(jg.random_regular_graph(n, d, seed=3),
                 tg.random_regular_graph(n, d, seed=3))


@pytest.mark.parametrize("n,c", [(500, 3.0), (500, 200.0), (5000, 6.0)])
def test_er_identical(n, c):
    # n=500: M <= 2^22, the exact-subset branch; n=5000 at c=6: M > 2^22
    # and m < M/4, the rejection branch
    M = n * (n - 1) // 2
    assert (M > (1 << 22)) == (n == 5000)
    _assert_same(jg.erdos_renyi_graph(n, c / n, seed=11),
                 tg.erdos_renyi_graph(n, c / n, seed=11))


def test_er_empty_and_full():
    _assert_same(jg.erdos_renyi_graph(50, 0.0, seed=1),
                 tg.erdos_renyi_graph(50, 0.0, seed=1))
    _assert_same(jg.erdos_renyi_graph(30, 1.0, seed=1),
                 tg.erdos_renyi_graph(30, 1.0, seed=1))


def test_remove_isolates_identical():
    g_j, iso_j = jg.remove_isolates(jg.erdos_renyi_graph(800, 1.5 / 800, seed=2))
    g_t, iso_t = tg.remove_isolates(tg.erdos_renyi_graph(800, 1.5 / 800, seed=2))
    assert iso_j == iso_t > 0
    _assert_same(g_j, g_t)
    # a graph without isolates comes back as it is
    g = tg.random_regular_graph(50, 3, seed=0)
    assert tg.remove_isolates(g) == (g, 0)


def test_graph_from_edges_and_decode_identical():
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 40, size=(60, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    _assert_same(jg.graph_from_edges(40, edges), tg.graph_from_edges(40, edges))
    _assert_same(jg.graph_from_edges(40, edges, dmax=12),
                 tg.graph_from_edges(40, edges, dmax=12))
    with pytest.raises(ValueError, match="dmax"):
        tg.graph_from_edges(40, edges, dmax=1)
    with pytest.raises(ValueError, match="endpoints"):
        tg.graph_from_edges(10, np.array([[0, 10]]))
    codes = rng.choice(1000 * 999 // 2, size=500, replace=False)
    for a, b in zip(jg._decode_triu(codes, 1000), tg._decode_triu(codes, 1000)):
        np.testing.assert_array_equal(a, b)


def test_rng_passthrough_and_refusals():
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    assert tg._as_rng(rng_t) is rng_t
    _assert_same(jg.random_regular_graph(60, 3, seed=rng_j),
                 tg.random_regular_graph(60, 3, seed=rng_t))
    with pytest.raises(ValueError, match="even"):
        tg.random_regular_graph(5, 3, seed=0)
    with pytest.raises(ValueError, match="d < n"):
        tg.random_regular_graph(4, 4, seed=0)
    # the networkx and native samplers run (since the power-law slice) and
    # give the JAX package's arrays for the same seed
    for method in ("networkx", "native"):
        _assert_same(jg.random_regular_graph(10, 3, seed=0, method=method),
                     tg.random_regular_graph(10, 3, seed=0, method=method))
        _assert_same(jg.erdos_renyi_graph(10, 0.3, seed=0, method=method),
                     tg.erdos_renyi_graph(10, 0.3, seed=0, method=method))


POWER_CASES = {
    "rrg": lambda m: m.random_regular_graph(200, 3, seed=5),
    "er": lambda m: m.erdos_renyi_graph(150, 3.0 / 150, seed=6),  # isolates
}


@pytest.mark.parametrize("gname", list(POWER_CASES))
def test_power_graph_and_distance2_coloring_identical(gname):
    g_j, g_t = POWER_CASES[gname](jg), POWER_CASES[gname](tg)
    _assert_same(g_j, g_t)
    assert tg.degree_cv(g_t.deg) == jg.degree_cv(g_j.deg)
    for r in (1, 2, 3):
        _assert_same(jg.power_graph(g_j, r), tg.power_graph(g_t, r))
    g2_j, g2_t = jg.power_graph(g_j, 2), tg.power_graph(g_t, 2)
    for seed in (0, 7):
        c_j = jg.greedy_coloring(g2_j, seed=seed)
        c_t = tg.greedy_coloring(g2_t, seed=seed)
        assert c_t.dtype == c_j.dtype == np.int32
        np.testing.assert_array_equal(c_t, c_j)
        assert tg.validate_coloring(g2_t, c_t) == [] == \
            jg.validate_coloring(g2_j, c_j)
    # a broken coloring: the same problems reported
    bad = c_t.copy()
    bad[g2_t.edges[0, 1]] = bad[g2_t.edges[0, 0]]
    bad[0] = -1
    assert tg.validate_coloring(g2_t, bad) == jg.validate_coloring(g2_j, bad)
    assert tg.validate_coloring(g2_t, bad[:-1]) == \
        jg.validate_coloring(g2_j, bad[:-1])
    with pytest.raises(ValueError, match="radius"):
        tg.power_graph(g_t, 0)


def test_degree_cv_auto_layout_and_bucketed_refusal():
    from graphdyn.ops import bucketed as jb
    from graphdyn_torch.config import DynamicsConfig, SAConfig
    from graphdyn_torch.ops import bucketed as tb
    from graphdyn_torch.search.fused import fused_anneal

    assert tb.BUCKETED_CV_THRESHOLD == jb.BUCKETED_CV_THRESHOLD
    # a star with a tail: degree CV far above the threshold
    star = np.array([[0, i] for i in range(1, 60)] + [[1, 2], [3, 4]])
    hub_j, hub_t = jg.graph_from_edges(60, star), tg.graph_from_edges(60, star)
    graphs = [(jg.random_regular_graph(50, 3, seed=0),
               tg.random_regular_graph(50, 3, seed=0)),
              (jg.erdos_renyi_graph(80, 2.0 / 80, seed=1),
               tg.erdos_renyi_graph(80, 2.0 / 80, seed=1)),
              (hub_j, hub_t)]
    for g_j, g_t in graphs:
        assert tg.degree_cv(g_t.deg) == jg.degree_cv(g_j.deg)
        assert tb.auto_layout(g_t.deg) == jb.auto_layout(g_j.deg)
        assert tb.auto_layout(g_t.deg, threshold=0.3) == \
            jb.auto_layout(g_j.deg, threshold=0.3)
    assert tb.auto_layout(hub_t.deg) == "bucketed"
    assert tg.degree_cv(np.zeros(0)) == 0.0 == tg.degree_cv(np.zeros(3))
    # the bucketed layout runs (since the power-law slice): the hub graph
    # is relabeled bucket-major and the spins mapped back, so auto and
    # bucketed give the padded run on the relabeled graph
    cfg = SAConfig(dynamics=DynamicsConfig(p=1, c=1))
    g_b, inv = tg.permute_nodes(hub_t, tg.degree_buckets(hub_t).order)
    want = fused_anneal(g_b, cfg, n_replicas=2, max_sweeps=2, layout="padded",
                        device="cpu").s[..., inv]
    for layout in ("auto", "bucketed"):
        got = fused_anneal(hub_t, cfg, n_replicas=2, max_sweeps=2,
                           layout=layout, device="cpu")
        np.testing.assert_array_equal(got.s, want)


TABLE_CASES = {
    "rrg": lambda m: m.random_regular_graph(60, 4, seed=2),
    "er": lambda m: m.erdos_renyi_graph(80, 2.5 / 80, seed=3),  # isolates
}


def _same_tables(a, b):
    for f in ("src", "dst", "edge_deg", "in_edges", "node_in_edges",
              "node_out_edges", "rev_map"):
        x, y = getattr(a, f), getattr(b, f)
        if y is None:
            assert x is None, f
            continue
        x = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)
        assert x.dtype == np.asarray(y).dtype, f
    assert a.num_directed == b.num_directed and a.num_edges == b.num_edges


@pytest.mark.parametrize("gname", list(TABLE_CASES))
def test_edge_tables_classes_stack_and_unions_identical(gname):
    g_j, g_t = TABLE_CASES[gname](jg), TABLE_CASES[gname](tg)
    t_j, t_t = jg.build_edge_tables(g_j), tg.build_edge_tables(g_t)
    _same_tables(t_t, t_j)
    e = np.arange(t_j.num_directed)
    np.testing.assert_array_equal(t_t.rev(e), t_j.rev(e))
    for values in (t_j.edge_deg, g_j.deg):
        c_j, c_t = jg.degree_classes(values), tg.degree_classes(values)
        assert list(c_t) == list(c_j)
        for d in c_j:
            np.testing.assert_array_equal(c_t[d], c_j[d])
            assert c_t[d].dtype == c_j[d].dtype
    for R in (1, 3):
        _assert_same(jg.replicate_disjoint(g_j, R), tg.replicate_disjoint(g_t, R))
        u_j = jg.replicate_edge_tables(t_j, R, g_j.n)
        u_t = tg.replicate_edge_tables(t_t, R, g_t.n)
        _same_tables(u_t, u_j)
        e = np.arange(u_j.num_directed)
        np.testing.assert_array_equal(u_t.rev(e), u_j.rev(e))
    # the stack re-pads narrower members with their own ghost index
    others = [TABLE_CASES[gname](jg), jg.random_regular_graph(g_j.n, 2, seed=9)]
    s_j = jg.stack_graphs([g_j] + others)
    s_t = tg.stack_graphs([g_t] + [interop.graph_from_arrays(o.nbr, o.deg, o.edges)
                                   for o in others])
    np.testing.assert_array_equal(s_t.nbr, s_j.nbr)
    np.testing.assert_array_equal(s_t.deg, s_j.deg)
    assert (s_t.G, s_t.n, s_t.dmax) == (s_j.G, s_j.n, s_j.dmax)
    with pytest.raises(ValueError, match="share n"):
        tg.stack_graphs([g_t, tg.random_regular_graph(10, 3, seed=0)])
    with pytest.raises(ValueError, match="dmax"):
        tg.stack_graphs([g_t], dmax=1)


@pytest.mark.parametrize("gname", list(TABLE_CASES))
def test_device_union_builder_equals_host(gname):
    """The torch union builders (offset-tiled on the target device) equal
    the host builders of both packages, the pattern of
    tests/test_hpr.py:310; the int32 range guard refuses overflowing
    unions."""
    g = TABLE_CASES[gname](tg)
    t = tg.build_edge_tables(g)
    R = 3
    _same_tables(tg.replicate_edge_tables_device(t, R, g.n, "cpu"),
                 tg.replicate_edge_tables(t, R, g.n))
    gd, gh = tg.replicate_disjoint_device(g, R, "cpu"), tg.replicate_disjoint(g, R)
    for f in ("nbr", "deg", "edges"):
        x = getattr(gd, f)
        assert x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), getattr(gh, f), err_msg=f)
    with pytest.raises(ValueError, match="int32"):
        tg._check_i32(2**16, 2**15)
    with pytest.raises(ValueError, match="int32"):
        tg.replicate_disjoint_device(g, 2**31 // g.n + 1, "cpu")
