"""The port's BDCM core against the JAX package's: the static data and the
numpy init exactly; the ρ-lattice DP, the class update, the plain twin of
the K3 kernel (against the Pallas kernel in interpret mode and against the
XLA class update), the sweep in both variants and with padded classes, and
the marginals at stated tolerances; the brute-force oracle of
``tests/test_hpr_oracle.py``; the replica union against each copy.

Tolerances: float32 rtol 1e-5, atol 1e-7; float64 rtol 1e-12, atol 1e-15.
The port sums in another order than XLA (an elementwise product and a sum
over the lattice axis where XLA runs a dot; the kernel twin multiplies by
1/z where XLA divides), so the results agree to rounding, not bit for bit.
The CUDA kernel runs only on a GPU; ``chip_smoke.py`` holds it against the
same plain version there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.ops import bdcm as jb
from graphdyn.ops import pallas_bdcm as jpb
from graphdyn_torch import interop
from graphdyn_torch.ops import bdcm as tb

TOL = {"float32": dict(rtol=1e-5, atol=1e-7),
       "float64": dict(rtol=1e-12, atol=1e-15)}
TDT = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs small tensors here: one intra-op thread per test
    process avoids oversubscribing the cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def x64():
    """float64 on the JAX side for one test, switched back afterwards (the
    pattern of tests/test_hpr.py:465-470)."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _pair(make):
    g_j = make(jg)
    return g_j, interop.graph_from_arrays(g_j.nbr, g_j.deg, g_j.edges)


GRAPHS = {
    "rrg": lambda m: m.random_regular_graph(40, 4, seed=3),
    "er": lambda m: m.erdos_renyi_graph(60, 3.0 / 60, seed=1),  # ragged, leaves
    # small graphs for the larger lattices: T = 5 on d = 3 (RRG(10, 4)),
    # T = 6 on d = 2 (RRG(10, 3)), T = 4 on a hub of degree 14
    "rrg10_4": lambda m: m.random_regular_graph(10, 4, seed=2),
    "rrg10_3": lambda m: m.random_regular_graph(10, 3, seed=2),
}


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL[dtype])


# ---------------------------------------------------------------------------
# static data and init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bucket", [None, 16])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_bdcm_data_and_init_identical(gname, bucket, x64):
    g_j, g_t = _pair(GRAPHS[gname])
    for dt in ("float32", "float64"):
        dj = jb.BDCMData(g_j, class_bucket=bucket, dtype=jnp.dtype(dt))
        dtp = tb.BDCMData(g_t, class_bucket=bucket, dtype=dt)
        for f in ("valid", "x0", "leaf01", "leaf_idx"):
            a, b = getattr(dtp, f), getattr(dj, f)
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
        for f in ("T", "K", "n", "num_directed", "num_edges", "padded"):
            assert getattr(dtp, f) == getattr(dj, f), f
        for cls_t, cls_j in zip(dtp.edge_classes + dtp.node_classes,
                                dj.edge_classes + dj.node_classes):
            assert len(cls_t) == len(cls_j) and cls_t[0] == cls_j[0]
            for a, b in zip(cls_t[1:], cls_j[1:]):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        assert len(dtp.edge_classes) == len(dj.edge_classes)
        assert len(dtp.node_classes) == len(dj.node_classes)
        for seed in (0, 7):
            got = dtp.init_messages(seed)
            assert got.dtype == TDT[dt]
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(dj.init_messages(seed)))
        classes = interop.edge_classes_from_jax(dj)
        assert [c.d for c in classes] == [c.d for c in dtp.edge_classes]
    tabs = interop.edge_tables_from_jax(jg.build_edge_tables(g_j))
    np.testing.assert_array_equal(tabs.in_edges, dtp.tables.in_edges)
    assert tabs.rev_map is None
    with pytest.raises(ValueError, match="float32 or float64"):
        tb.BDCMData(g_t, dtype="float16")


def test_flat_offsets_identical():
    for T in (1, 2, 3, 4):
        for d in range(1, 9):
            got, want = tb._flat_offsets(d, T), jpb._flat_offsets(d, T)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


# ---------------------------------------------------------------------------
# the class update: DP, XLA twin, kernel twin
# ---------------------------------------------------------------------------


def _class_inputs(d, T, G, Ed, dt, seed=7):
    rng = np.random.default_rng(seed)
    K, M = 2**T, (d + 1) ** T
    npdt = np.float32 if dt == "float32" else np.float64
    chi_in = rng.random((G, Ed, d, K, K)).astype(npdt)
    A = rng.random((K, K, M)).astype(npdt)
    chi_old = rng.random((G, Ed, K, K)).astype(npdt)
    tilts = (rng.random((G, K)) + 0.5).astype(npdt)
    return chi_in, A, chi_old, tilts


# (d, T, Ed, dtypes): the register and block lattices at 37 edges; T = 5 and
# 6 (K = 32, 64) and the lattices past a block's shared memory at T = 4 (the
# card's global path: d = 13 in float32, d = 10 in float64) on one to three
# edges, so the [Ed, K, M] lattices and the [K, K, M] factor stay small here.
# The JAX side runs jitted: its eager roll DP compiles each of the d·K
# shifts apart (13 s at T = 6 on one x86 CPU core).
BOTH = ("float32", "float64")


@pytest.mark.parametrize("d,T,Ed,dts", [
    (1, 2, 37, BOTH), (3, 2, 37, BOTH), (2, 3, 37, BOTH), (3, 5, 3, BOTH),
    (2, 6, 2, BOTH), (13, 4, 1, ("float32",)), (10, 4, 1, ("float64",))])
def test_neighbor_dp_and_class_update_match_jax(d, T, Ed, dts, x64):
    K = 2**T
    ref = jax.jit(lambda ci, A, tl, co, eps: (
        jb._neighbor_dp(ci, d, T, K),
        jb.class_update(ci, A, tl, co, d=d, T=T, K=K, damp=0.3,
                        eps_clamp=eps)))
    for dt in dts:
        chi_in, A, chi_old, tilts = _class_inputs(d, T, 1, Ed, dt)
        LL_t = tb._neighbor_dp(torch.from_numpy(chi_in[0]), d, T, K)
        for eps in (0.0, 1e-12):
            LL_j, want = ref(
                jnp.asarray(chi_in[0]), jnp.asarray(A), jnp.asarray(tilts[0]),
                jnp.asarray(chi_old[0]), jnp.asarray(eps, jnp.dtype(dt)))
            _close(LL_t.numpy(), LL_j, dt)
            got = tb.class_update(
                torch.from_numpy(chi_in[0]), torch.from_numpy(A),
                torch.from_numpy(tilts[0]), torch.from_numpy(chi_old[0]),
                d=d, T=T, K=K, damp=0.3, eps_clamp=eps)
            assert got.dtype == TDT[dt]
            _close(got.numpy(), want, dt)
            plain = tb.dp_contract_grouped(
                torch.from_numpy(chi_in), torch.from_numpy(
                    A * tilts[0][:, None, None]), torch.from_numpy(chi_old),
                d=d, T=T, damp=0.3, eps_clamp=eps, kernel="plain")
            _close(plain[0].numpy(), want, dt)


# The Pallas kernel's interpret mode compiles its fully unrolled body, which
# takes seconds for the T=2 lattices and close to a minute for (d=2, T=4)
# per shape; the larger lattices are held against the XLA class update (the
# JAX package's own plain reference) instead, below.
INTERPRET_CASES = [
    # (d, T, G, eps_clamp, per-group a_tilted)
    (2, 2, 1, 1e-12, True), (3, 2, 3, 0.0, False),
]


@pytest.mark.parametrize("d,T,G,eps,per_group", INTERPRET_CASES)
def test_plain_contract_matches_pallas_interpret(d, T, G, eps, per_group):
    """The plain twin against ``dp_contract_grouped(..., interpret=True)``
    (f32, the kernel's dtype) at Ed = 200, not a multiple of the 128-lane
    tile, shared and per-group factor."""
    chi_in, A, chi_old, tilts = _class_inputs(d, T, G, 200, "float32")
    a = A[None] * tilts[:, :, None, None] if per_group else A
    want = jpb.dp_contract_grouped(
        jnp.asarray(chi_in), jnp.asarray(a), jnp.asarray(chi_old), d=d, T=T,
        damp=0.3, eps_clamp=eps, interpret=True)
    got = tb.dp_contract_grouped(
        torch.from_numpy(chi_in), torch.from_numpy(np.ascontiguousarray(a)),
        torch.from_numpy(chi_old), d=d, T=T, damp=0.3, eps_clamp=eps)
    _close(got.numpy(), want, "float32")


@pytest.mark.parametrize("d,T", [(1, 2), (2, 2), (3, 2), (4, 2), (3, 3), (2, 4)])
def test_plain_contract_matches_xla_and_port_class_update(d, T, x64):
    """The plain twin against the JAX package's XLA class update (vmapped
    over the group, per-group tilts folded into the factor or shared) and
    the port's own ``class_update``, G = 3, Ed = 129, eps ∈ {0, 1e-12}, f32
    and f64 (G = 1 is each member: the rows do not depend on G, below)."""
    K = 2**T
    G = 3
    for dt in ("float32", "float64"):
        ref = jax.jit(jax.vmap(lambda ci, A, co, tl, eps: jb.class_update(
            ci, A, tl, co, d=d, T=T, K=K, damp=0.4, eps_clamp=eps),
            in_axes=(0, None, 0, 0, None)))
        for eps, per_group in ((1e-12, True), (0.0, False)):
            chi_in, A, chi_old, tilts = _class_inputs(d, T, G, 129, dt,
                                                      seed=d + per_group)
            if not per_group:
                tilts = np.broadcast_to(tilts[:1], tilts.shape).copy()
            a = A[None] * tilts[:, :, None, None] if per_group else \
                A * tilts[0][:, None, None]
            got = tb.dp_contract_grouped(
                torch.from_numpy(chi_in), torch.from_numpy(a),
                torch.from_numpy(chi_old), d=d, T=T, damp=0.4,
                eps_clamp=eps, kernel="plain")
            assert got.dtype == TDT[dt] and got.shape == chi_old.shape
            want = ref(jnp.asarray(chi_in), jnp.asarray(A),
                       jnp.asarray(chi_old), jnp.asarray(tilts),
                       jnp.asarray(eps, jnp.dtype(dt)))
            _close(got.numpy(), want, dt)
            for g in range(G):
                port = tb.class_update(
                    torch.from_numpy(chi_in[g]), torch.from_numpy(A),
                    torch.from_numpy(tilts[g]), torch.from_numpy(chi_old[g]),
                    d=d, T=T, K=K, damp=0.4, eps_clamp=eps)
                _close(got[g].numpy(), port.numpy(), dt)


def test_plain_contract_rows_independent_of_group_and_chunk(monkeypatch):
    """A row's result does not depend on G, Ed or the row chunk: member g of
    a G=3 call equals a G=1 call on its rows, bit for bit, also when the
    rows are cut into chunks of 7."""
    d, T = 3, 2
    chi_in, A, chi_old, _ = _class_inputs(d, T, 3, 50, "float32")
    ci, co, a = (torch.from_numpy(x) for x in (chi_in, chi_old, A))
    full = tb.dp_contract_grouped_plain(ci, a, co, d=d, T=T, damp=0.4)
    monkeypatch.setattr(tb, "_row_chunk", lambda bytes_per_row: 7)
    for g in range(3):
        one = tb.dp_contract_grouped_plain(ci[g:g + 1, 10:40], a,
                                           co[g:g + 1, 10:40], d=d, T=T,
                                           damp=0.4)
        assert torch.equal(one[0], full[g, 10:40])
    assert torch.equal(tb.dp_contract(ci[1], a, co[1], d=d, T=T, damp=0.4,
                                      kernel="plain"), full[1])


# ---------------------------------------------------------------------------
# the sweep and the marginals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gname,bucket,variant,p,c,dts", [
    ("rrg", None, "hpr", 1, 1, BOTH), ("er", 16, "hpr", 1, 1, BOTH),
    ("rrg", 16, "entropy", 1, 1, BOTH), ("er", None, "entropy", 1, 1, BOTH),
    ("rrg10_4", None, "hpr", 4, 1, BOTH),
    # the JAX XLA sweep at T = 6 compiles for ~20 s per dtype on a CPU
    ("rrg10_3", None, "entropy", 5, 1, ("float64",)),
])
def test_make_sweep_and_marginals_match_xla(gname, bucket, variant, p, c, dts,
                                            x64):
    """One sweep through ``make_sweep`` against the JAX package's XLA sweep
    (``use_pallas=False``): the HPr variant (bias-weighted, invalid sources
    kept, eps 0) and the entropy variant (invalid sources masked, eps
    1e-12), with and without padded classes; then the marginals. At T = 2,
    T = 5 (one class, d = 3) and T = 6 (one class, d = 2)."""
    g_j, g_t = _pair(GRAPHS[gname])
    hpr = variant == "hpr"
    kw = dict(damp=0.4, eps_clamp=0.0 if hpr else 1e-12,
              mask_invalid_src=not hpr, with_bias=hpr)
    for dt in dts:
        dj = jb.BDCMData(g_j, class_bucket=bucket, dtype=jnp.dtype(dt), p=p,
                         c=c)
        dtp = tb.BDCMData(g_t, class_bucket=bucket, dtype=dt, p=p, c=c)
        chi = dtp.init_messages(3)
        lmbd = 25.0 if hpr else 0.7
        args_j = [jnp.asarray(chi.numpy()), jnp.asarray(lmbd, jnp.dtype(dt))]
        args_t = [chi, lmbd]
        if hpr:
            rng = np.random.default_rng(4)
            be = rng.random((dtp.num_directed, dtp.K)).astype(dtp.np_dtype)
            args_j.append(jnp.asarray(be))
            args_t.append(torch.from_numpy(be))
        want = np.asarray(jb.make_sweep(dj, use_pallas=False, **kw)(*args_j))
        sweep = tb.make_sweep(dtp, device="cpu", **kw)
        assert sweep.spec.modes == ("plain",) * len(dtp.edge_classes)
        got = sweep(*args_t)
        assert got.dtype == TDT[dt] and tuple(got.shape) == want.shape
        _close(got.numpy(), want, dt)
        m_want = np.asarray(jb.make_marginals(dj)(jnp.asarray(want)))
        m_got = tb.make_marginals(dtp, device="cpu")(torch.from_numpy(want))
        _close(m_got.numpy(), m_want, dt)


# the brute-force oracle of tests/test_hpr_oracle.py, against the port
from tests.test_hpr_oracle import (  # noqa: E402
    _setup as _oracle_setup,
    oracle_marginals,
    oracle_sweep,
)


def _oracle_port(n, d, p, c, seed):
    g, tables, data, chi, biases, bias_edge = _oracle_setup(n, d, p, c, seed)
    dtp = tb.BDCMData(interop.graph_from_arrays(g.nbr, g.deg, g.edges), p=p,
                      c=c)
    return g, tables, dtp, chi, biases, bias_edge


@pytest.mark.parametrize(
    "n,d,p,c,lmbd",
    [(16, 4, 1, 1, 25.0), (16, 4, 1, 1, 1.0), (14, 3, 2, 1, 2.0)],
)
def test_sweep_matches_bruteforce_oracle(n, d, p, c, lmbd):
    """`tests/test_hpr_oracle.py:133` against the port, at its tolerance."""
    g, tables, dtp, chi, biases, bias_edge = _oracle_port(n, d, p, c, 3)
    sweep = tb.make_sweep(dtp, damp=0.4, eps_clamp=0.0, mask_invalid_src=False,
                          with_bias=True, device="cpu")
    got = sweep(torch.tensor(chi, dtype=torch.float32), lmbd,
                torch.tensor(bias_edge, dtype=torch.float32)).numpy()
    want = oracle_sweep(chi, biases, tables, p=p, c=c, lmbd=lmbd, damp=0.4)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-6)


def test_iterated_sweep_matches_oracle():
    """`tests/test_hpr_oracle.py:148`: 4 iterated sweeps."""
    n, d, p, c, lmbd = 16, 4, 1, 1, 25.0
    g, tables, dtp, chi, biases, bias_edge = _oracle_port(n, d, p, c, 9)
    sweep = tb.make_sweep(dtp, damp=0.4, eps_clamp=0.0, mask_invalid_src=False,
                          with_bias=True, device="cpu")
    got = torch.tensor(chi, dtype=torch.float32)
    be = torch.tensor(bias_edge, dtype=torch.float32)
    want = chi
    for _ in range(4):
        got = sweep(got, lmbd, be)
        want = oracle_sweep(want, biases, tables, p=p, c=c, lmbd=lmbd, damp=0.4)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=1e-6)


def test_marginals_match_oracle_and_eps_clamp():
    """`tests/test_hpr_oracle.py:164-184`: the marginals, and the 1e-15
    clamp on an all-mass-on-one-side chi."""
    g, tables, dtp, chi, _, _ = _oracle_port(16, 4, 1, 1, 5)
    marg = tb.make_marginals(dtp, eps=1e-15, device="cpu")
    got = marg(torch.tensor(chi, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, oracle_marginals(chi, tables, 16),
                               rtol=2e-4, atol=1e-7)
    g, tables, dtp, chi, _, _ = _oracle_port(12, 3, 1, 1, 7)
    chi = np.zeros_like(chi)
    chi[:, 0, 0] = 1.0
    got = tb.make_marginals(dtp, eps=1e-15, device="cpu")(
        torch.tensor(chi, dtype=torch.float32)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, oracle_marginals(chi, tables, 12),
                               rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_union_sweep_equals_each_copy_bit_for_bit(gname):
    """Over the device-built union of R copies (replica-major), the plain
    sweep and marginals equal each copy's own, bit for bit."""
    _, g = _pair(GRAPHS[gname])
    R = 3
    base = tb.BDCMData(g)
    union = tb.replicate_bdcm_device(base, R, "cpu")
    kw = dict(damp=0.4, eps_clamp=0.0, mask_invalid_src=False, with_bias=True,
              device="cpu")
    chis = [base.init_messages(s) for s in range(R)]
    rng = np.random.default_rng(0)
    bes = [torch.from_numpy(rng.random((base.num_directed, base.K)).astype(
        np.float32)) for _ in range(R)]
    got = tb.make_sweep(union, **kw)(torch.cat(chis), 25.0, torch.cat(bes))
    sweep = tb.make_sweep(base, **kw)
    m_u = tb.make_marginals(union, device="cpu")(got)
    m_b = tb.make_marginals(base, device="cpu")
    twoE = base.num_directed
    for r in range(R):
        one = sweep(chis[r], 25.0, bes[r])
        assert torch.equal(got[r * twoE:(r + 1) * twoE], one)
        assert torch.equal(m_u[r * g.n:(r + 1) * g.n], m_b(one))
