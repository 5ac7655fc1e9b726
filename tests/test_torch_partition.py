"""The port's edge-cut partitioner against the JAX package's: the same graph
and seed give the same ``Partition`` arrays and the same ghost tables, bit
for bit (integer tables, no tolerance) — on a random regular graph, an
Erdős–Rényi graph and a power-law graph with and without hub splitting."""

import numpy as np
import pytest

import graphdyn.graphs as jg
import graphdyn_torch.graphs as tg

GRAPHS = {
    "rrg": lambda m: m.random_regular_graph(300, 3, seed=4),
    "er": lambda m: m.erdos_renyi_graph(250, 4.0 / 249, seed=2),
    "powerlaw": lambda m: m.powerlaw_graph(400, gamma=2.3, dmin=2, seed=1),
}


def _same_partition(a, b):
    for f in ("part", "order", "offsets", "interior"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.edge_cut == b.edge_cut
    if a.hubs is None:
        assert b.hubs is None
    else:
        assert a.hubs.dtype == b.hubs.dtype
        np.testing.assert_array_equal(a.hubs, b.hubs)
    assert a.P == b.P
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.boundary, b.boundary)


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 7])
def test_partition_graph_and_ghosts_match_jax(name, P, seed):
    gj, gt = GRAPHS[name](jg), GRAPHS[name](tg)
    pj = jg.partition_graph(gj, P, seed=seed)
    pt = tg.partition_graph(gt, P, seed=seed)
    _same_partition(pj, pt)
    assert tg.edge_cut(gt, pt.part) == jg.edge_cut(gj, pj.part) == pt.edge_cut
    for x, y in zip(jg.partition_ghosts(gj, pj), tg.partition_ghosts(gt, pt),
                    strict=True):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("threshold", [6, 12])
def test_hub_split_partition_matches_jax(P, threshold):
    gj = jg.powerlaw_graph(400, gamma=2.2, dmin=2, seed=3)
    gt = tg.powerlaw_graph(400, gamma=2.2, dmin=2, seed=3)
    pj = jg.partition_graph(gj, P, seed=1, hub_threshold=threshold)
    pt = tg.partition_graph(gt, P, seed=1, hub_threshold=threshold)
    assert pt.hubs is not None and pt.hubs.size > 0
    assert (pt.part[pt.hubs] == -1).all()
    _same_partition(pj, pt)
    for x, y in zip(jg.partition_ghosts(gj, pj), tg.partition_ghosts(gt, pt),
                    strict=True):
        np.testing.assert_array_equal(x, y)


def test_partition_refusals_match_jax():
    g = tg.random_regular_graph(20, 3, seed=0)
    for bad, match in ((0, "n_parts must be >= 1"), (21, "n_parts=21 > n=20")):
        with pytest.raises(ValueError, match=match):
            tg.partition_graph(g, bad)
    with pytest.raises(ValueError, match="hub_threshold must be >= 1"):
        tg.partition_graph(g, 2, hub_threshold=0)
