"""The port's grouped and ensemble entropy ladders: the grouped grid equal
to the serial cell loop bit for bit (G ∈ {1, 3, 8} on a 9-cell grid whose
cells stop at different λ) and close to the JAX package's grid; the union
against per-graph ladders, with an all-isolate and an edgeless member, and
two union runs equal bit for bit; the congruent ensemble against serial
ladders and the JAX package's; the entropy-floor and plateau exits; the
interop of the stacked cell tables.

Tolerances: bit for bit where the same program runs (grouped == serial,
two runs); float64 1e-9 against the JAX package's congruent ensemble
(equal sweep counts); 1e-4 for float32 curves (the f32 delta rounds at
about 1% of eps, so a fixed point may stop a sweep earlier or later); 2e-3
and 5e-4 where the union or the ensemble starts from another chi than the
per-graph ladder it is compared with (the JAX package's own bounds).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax

from graphdyn import graphs as jg
from graphdyn.config import DynamicsConfig as JDyn
from graphdyn.config import EntropyConfig as JCfg
from graphdyn.models import entropy as jem
from graphdyn.ops import bdcm as jb
from graphdyn_torch import interop
from graphdyn_torch.config import DynamicsConfig, EntropyConfig
from graphdyn_torch.graphs import (
    disjoint_union,
    erdos_renyi_graph,
    graph_from_edges,
    random_regular_graph,
    remove_isolates,
)
from graphdyn_torch.models import entropy as tem

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the tensors are small and the
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def x64():
    """float64 on the JAX side, switched back afterwards."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _pcfg(**kw):
    dyn = kw.pop("dynamics", None)
    return EntropyConfig(**kw, **({"dynamics": DynamicsConfig(**dyn)}
                                  if dyn else {}))


def _jcfg(**kw):
    dyn = kw.pop("dynamics", None)
    return JCfg(**kw, **({"dynamics": JDyn(**dyn)} if dyn else {}))


# ---------------------------------------------------------------------------
# grouped == serial; unions; ensembles; exits
# ---------------------------------------------------------------------------


GRID = dict(n=24, deg=np.array([1.1, 1.5, 2.0]), seed=2)


def _grid_cfg():
    # ent_floor between the degrees' ent1 levels, so the cells exit at
    # different λ; 3 reps × 3 degrees = 9 cells
    return _pcfg(lmbd_max=0.2, lmbd_step=0.1, num_rep=3, ent_floor=0.25)


@pytest.fixture(scope="module")
def serial_grid():
    return tem.entropy_grid(GRID["n"], GRID["deg"], _grid_cfg(),
                            seed=GRID["seed"], group_size=0, device=CPU)


@pytest.mark.parametrize("G", [1, 3, 8])
def test_grid_grouped_equals_serial(serial_grid, G):
    assert serial_grid.n_lambda.min() < serial_grid.n_lambda.max()
    res = tem.entropy_grid(GRID["n"], GRID["deg"], _grid_cfg(),
                           seed=GRID["seed"], group_size=G, device=CPU)
    for f in res._fields:
        np.testing.assert_array_equal(getattr(res, f),
                                      getattr(serial_grid, f), err_msg=f)


def test_grid_sweeps_fill_the_visited_lambdas(serial_grid):
    """The grid's per-λ fixed-point sweep counts (the port's addition):
    at least one sweep at every visited λ, 0 past each cell's n_lambda."""
    L = serial_grid.ent.shape[2]
    visited = np.arange(L) < serial_grid.n_lambda[..., None]
    assert serial_grid.sweeps.shape == serial_grid.ent.shape
    assert (serial_grid.sweeps[visited] > 0).all()
    assert (serial_grid.sweeps[~visited] == 0).all()


def test_grid_matches_jax_grid():
    cfg = dict(lmbd_max=0.1, lmbd_step=0.1, num_rep=1)
    deg = np.array([1.2, 1.6])
    want = jem.entropy_grid(30, deg, _jcfg(**cfg), seed=3)
    got = tem.entropy_grid(30, deg, _pcfg(**cfg), seed=3, device=CPU)
    for f in ("nodes_isolated", "mean_degrees", "max_degrees",
              "mean_degrees_total", "counts", "n_lambda"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    for f in ("ent", "m_init", "ent1"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=1e-4, err_msg=f)


def test_union_against_per_graph_with_isolate_and_edgeless_members():
    """Heterogeneous ER members (isolates included), an all-isolate member
    and an edgeless one: each member equals its own per-graph ladder (a
    different chi init, the same fixed point: 2e-3, as the JAX package's
    test), and the degenerate members take the closed form."""
    lambdas = np.array([0.0, 0.2, 0.4])
    iso = graph_from_edges(5, np.empty((0, 2), np.int64))
    graphs = [erdos_renyi_graph(120, 1.2 / 119, seed=s) for s in (1, 2)]
    graphs += [iso, graph_from_edges(3, np.empty((0, 2), np.int64))]
    assert all((g.deg == 0).any() for g in graphs)
    res = tem.entropy_ensemble_union(graphs, _pcfg(), seed=0, lambdas=lambdas,
                                     device=CPU)
    assert res.lambdas.size == 3
    assert np.all(np.isfinite(res.ent)) and np.all(np.isfinite(res.m_init))
    for k in range(2):
        ref = tem.entropy_sweep(graphs[k], _pcfg(), seed=10 + k,
                                lambdas=lambdas, device=CPU)
        for f in ("ent", "m_init", "ent1"):
            np.testing.assert_allclose(getattr(res, f)[:, k], getattr(ref, f),
                                       atol=2e-3)
    np.testing.assert_allclose(res.m_init[:, 2:], 1.0)
    np.testing.assert_allclose(res.ent[:, 2:], -lambdas[:, None] * np.ones(2))
    np.testing.assert_array_equal(res.edge_gid, disjoint_union(
        [remove_isolates(g)[0] for g in graphs])[2])
    again = tem.entropy_ensemble_union(graphs, _pcfg(), seed=0,
                                       lambdas=lambdas, device=CPU)
    np.testing.assert_array_equal(again.ent, res.ent)      # bit for bit


def test_union_all_edgeless_closed_form_and_matches_jax():
    iso = graph_from_edges(5, np.empty((0, 2), np.int64))
    lambdas = np.array([0.0, 0.5, 1.0])
    res = tem.entropy_ensemble_union([iso, iso], _pcfg(), lambdas=lambdas,
                                     device=CPU)
    np.testing.assert_allclose(res.m_init, 1.0)
    np.testing.assert_allclose(res.ent, -lambdas[:, None] * np.ones((1, 2)))
    np.testing.assert_allclose(res.ent1, 0.0, atol=1e-12)
    jiso = jg.graph_from_edges(5, np.empty((0, 2), np.int64))
    want = jem.entropy_ensemble_union([jiso, jiso], JCfg(), lambdas=lambdas)
    for f in ("ent", "m_init", "ent1", "sweeps"):
        np.testing.assert_array_equal(getattr(res, f), getattr(want, f))


def test_disjoint_union_matches_jax():
    gj = [jg.erdos_renyi_graph(30, 2.0 / 29, seed=s) for s in (0, 1)]
    gj.append(jg.graph_from_edges(4, np.empty((0, 2), np.int64)))
    gt = [interop.graph_from_arrays(g.nbr, g.deg, g.edges) for g in gj]
    want, got = jg.disjoint_union(gj), disjoint_union(gt)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    blocks = tem.member_blocks(got[1], 3, CPU)
    x = torch.arange(got[1].size, dtype=torch.float64)
    sums = tem._block_reduce(x, blocks, 0.0, "sum")
    np.testing.assert_array_equal(
        sums.numpy(), np.bincount(got[1], weights=x.numpy(), minlength=3))


def test_congruent_ensemble_against_serial_and_jax():
    lambdas = np.array([0.0, 0.1, 0.2])
    gj = [jg.random_regular_graph(50, 3, seed=k) for k in range(3)]
    gt = [random_regular_graph(50, 3, seed=k) for k in range(3)]
    cfg = dict(lmbd_max=0.2, lmbd_step=0.1, dtype="float64")
    res = tem.entropy_ensemble(gt, _pcfg(**cfg), seed=5, lambdas=lambdas,
                               device=CPU)
    assert res.ent1.shape == (3, 3) and res.chi.shape[0] == 3
    for k, g in enumerate(gt):
        one = tem.entropy_sweep(g, _pcfg(**cfg), chi0=res.chi[k],
                                lambdas=lambdas[-1:], device=CPU)
        np.testing.assert_allclose(one.ent1[-1], res.ent1[-1, k], atol=5e-4)
    with x64():
        want = jem.entropy_ensemble(gj, _jcfg(**cfg), seed=5, lambdas=lambdas)
    np.testing.assert_array_equal(res.sweeps, want.sweeps)
    for f in ("ent", "m_init", "ent1"):
        np.testing.assert_allclose(getattr(res, f), getattr(want, f),
                                   rtol=0, atol=1e-9, err_msg=f)


def _small_graph_pair():
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0], [0, 4]])
    return jg.graph_from_edges(5, edges), graph_from_edges(5, edges)


@pytest.mark.parametrize("floor,expect", [(10.0, 1), (-1e9, 4)])
def test_ent_floor_exit_matches_jax(floor, expect):
    gj, gt = _small_graph_pair()
    cfg = dict(lmbd_max=3.0, lmbd_step=1.0, ent_floor=floor)
    want = jem.entropy_sweep(gj, _jcfg(**cfg), seed=0)
    got = tem.entropy_sweep(gt, _pcfg(**cfg), seed=0, device=CPU)
    assert got.lambdas.size == want.lambdas.size
    assert got.lambdas.size == expect or got.nonconverged > 0
    np.testing.assert_allclose(got.ent1, want.ent1, atol=1e-4)


def test_plateau_exit_matches_jax_and_prefix():
    gj, gt = _small_graph_pair()
    base = dict(lmbd_max=5.0, lmbd_step=0.5, ent_floor=-1e9)
    full = tem.entropy_sweep(gt, _pcfg(**base), seed=0, device=CPU)
    cfg = dict(base, plateau_eps=1e9, plateau_patience=2)
    res = tem.entropy_sweep(gt, _pcfg(**cfg), seed=0, device=CPU)
    want = jem.entropy_sweep(gj, _jcfg(**cfg), seed=0)
    assert res.lambdas.size == want.lambdas.size == 3
    np.testing.assert_array_equal(res.m_init, full.m_init[:3])
    np.testing.assert_array_equal(res.ent1, full.ent1[:3])


def test_isolates_enter_analytically():
    """Isolated nodes contribute −λ·n_iso/n to φ and +n_iso/n to m_init."""
    edges = np.array([[0, 1], [1, 2]])
    lambdas = np.array([0.0, 0.5])
    r_iso = tem.entropy_sweep(graph_from_edges(5, edges), _pcfg(), seed=1,
                              lambdas=lambdas, device=CPU)
    r_core = tem.entropy_sweep(graph_from_edges(3, edges), _pcfg(), seed=1,
                               lambdas=lambdas, device=CPU)
    np.testing.assert_allclose(r_iso.ent * 5, r_core.ent * 3 - lambdas * 2,
                               atol=1e-5)
    np.testing.assert_allclose(r_iso.m_init * 5, r_core.m_init * 3 + 2,
                               atol=1e-5)


def test_interop_stack_equals_jax_stack():
    cells = [jb.BDCMData(jg.remove_isolates(jg.erdos_renyi_graph(
        40, c / 39, seed=s))[0], class_bucket=16)
        for s, c in ((0, 1.2), (1, 2.0), (2, 1.6))]
    want = jb.stack_bdcm(cells)
    got = interop.stacked_bdcm_from_jax(want)
    assert got.twoE_max == want.twoE_max
    np.testing.assert_array_equal(got.leaf_idx, want.leaf_idx)
    for (d1, i1, e1, a1), (d2, i2, e2, a2) in zip(got.edge_classes,
                                                  want.edge_classes):
        assert d1 == d2
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_array_equal(a1, a2)
    chis = [np.asarray(c.init_messages(3)) for c in cells]
    np.testing.assert_array_equal(got.stack_chi(chis).numpy(),
                                  np.asarray(want.stack_chi(chis)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_gate_admits_every_entropy_class(dtype):
    """Every edge class that config 4's union (64 × ER(1000, 1.5/999)) and
    the entropy CLI's default grid (n=1000, deg 1.0 1.5 2.0, 3 reps, the
    stacked cells) produce is admitted by the CUDA kernel's gate, so the
    card runs them all through the kernel; the high-degree ones take the
    block path."""
    from graphdyn_torch.ops import bdcm as tb
    from graphdyn_torch.ops import bdcm_cuda

    tdt = torch.float32 if dtype == "float32" else torch.float64
    subs = [remove_isolates(erdos_renyi_graph(1000, 1.5 / 999, seed=k))[0]
            for k in range(64)]
    union = tb.BDCMData(disjoint_union(subs)[0], dtype=dtype)
    cells = [tb.BDCMData(remove_isolates(erdos_renyi_graph(
        1000, deg / 999, seed=1000 * di + rep))[0], class_bucket=64,
        dtype=dtype)
        for di, deg in enumerate((1.0, 1.5, 2.0)) for rep in range(3)]
    ds = {c.d for c in union.edge_classes}
    ds |= {d for d, _, _, _ in tb.stack_bdcm(cells[:8]).edge_classes}
    ds |= {c.d for c in cells[8].edge_classes}
    assert max(ds) >= 5
    paths = {d: bdcm_cuda.launch_plan(d, 2, tdt)["path"] for d in ds}
    assert all(bdcm_cuda.bdcm_kernel_supported(d, 2, tdt) for d in ds), paths
    assert {paths[d] for d in ds if d >= 5} == {"block"}
    assert tb.resolve_modes(sorted(ds), T=2, dtype=tdt, kernel="auto",
                            device="cuda") == ("cuda",) * len(ds)
