"""The port's chromatic class step against the JAX package's
``ops/chromatic.py``: the same tables, and the same words, accepts and sums
under injected uniforms (the ``tests/test_search.py`` chromatic pattern).
Packed words cross between the packages as uint32 numpy arrays."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.ops import chromatic as jc
from graphdyn.ops.dynamics import Rule as JRule, TieBreak as JTie
from graphdyn.ops.packed import pack_spins as j_pack_spins
from graphdyn_torch.interop import (
    chromatic_tables_from_jax,
    graph_from_arrays,
    words_from_numpy,
    words_to_numpy,
)
from graphdyn_torch.ops import chromatic as tc
from graphdyn_torch.ops.dynamics import Rule, TieBreak

RULE_TIE = [("majority", "stay"), ("majority", "change"),
            ("minority", "stay"), ("minority", "change")]
GRAPHS = {
    "rrg": jg.random_regular_graph(60, 3, seed=1),
    "er": jg.erdos_renyi_graph(50, 4.0 / 49, seed=2),     # ragged, isolates
}


def _setup(gname, R=5, seed=3):
    g = GRAPHS[gname]
    tables = jc.build_chromatic_tables(g, seed=0)
    W = -(-R // 32)
    Rp = 32 * W
    rng = np.random.default_rng(seed)
    s = (2 * rng.integers(0, 2, size=(R, g.n)) - 1).astype(np.int8)
    sp_ext = np.concatenate([np.asarray(j_pack_spins(s)),
                             np.zeros((1, W), np.uint32)])
    u = rng.random((g.n, Rp)).astype(np.float32)
    active = np.zeros(Rp, bool)
    active[:R] = True
    return g, tables, sp_ext, u, active, Rp


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_build_chromatic_tables_equal(gname):
    g = GRAPHS[gname]
    want = jc.build_chromatic_tables(g, seed=4)
    got = tc.build_chromatic_tables(
        graph_from_arrays(g.nbr, g.deg, g.edges), seed=4)
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.chi, got.n, got.dmax) == (want.chi, want.n, want.dmax)
    same = chromatic_tables_from_jax(want)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(same, name), getattr(want, name))


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_build_chromatic_tables_precomputed_coloring(gname):
    """A (power graph, colours) pair passed in gives the tables built from
    scratch; an invalid colouring is refused all the same."""
    from graphdyn_torch import graphs as tg

    g = GRAPHS[gname]
    tgraph = graph_from_arrays(g.nbr, g.deg, g.edges)
    g2 = tg.power_graph(tgraph, 2)
    colors = tg.greedy_coloring(g2, seed=4)
    got = tc.build_chromatic_tables(tgraph, seed=4, coloring=(g2, colors))
    want = tc.build_chromatic_tables(tgraph, seed=4)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    with pytest.raises(ValueError, match="coloring invalid"):
        tc.build_chromatic_tables(tgraph, coloring=(g2, np.zeros_like(colors)))


@pytest.mark.parametrize("rule,tie", RULE_TIE)
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_one_step_and_replica_end_sums_equal(gname, rule, tie):
    g, tables, sp_ext, _, _, _ = _setup(gname, R=40)
    n, dmax = g.n, tables.dmax
    n_planes = max(dmax.bit_length(), 1)
    thr_j, even_j = jc._threshold_words(jnp.asarray(tables.deg_ext), n_planes)
    want = np.asarray(jc._one_step(jnp.asarray(sp_ext),
                                   jnp.asarray(tables.nbr_ext), thr_j, even_j,
                                   n, dmax, JRule(rule), JTie(tie)))
    deg_t = torch.from_numpy(tables.deg_ext)
    thr_t, even_t = tc._threshold_words(deg_t, n_planes)
    got = tc._one_step(words_from_numpy(sp_ext),
                       torch.from_numpy(tables.nbr_ext), thr_t, even_t, n,
                       dmax, Rule(rule), TieBreak(tie))
    np.testing.assert_array_equal(words_to_numpy(got), want)
    sums_j = np.asarray(jc.replica_end_sums(
        sp_ext[:n], tables.nbr_ext, tables.deg_ext, n, dmax, rule, tie))
    sums_t = tc.replica_end_sums(words_from_numpy(sp_ext[:n]),
                                 torch.from_numpy(tables.nbr_ext), deg_t, n,
                                 dmax, rule, tie)
    assert sums_t.dtype == torch.int32
    np.testing.assert_array_equal(sums_t.numpy(), sums_j)


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_accept_apply_equal_injected_u(gname):
    """The accept core inside a compiled program (as the fused chain runs
    it) against the port's, on the same words, ends and uniforms."""
    g, tables, sp_ext, u, active, Rp = _setup(gname)
    n, dmax = g.n, tables.dmax
    n_planes = max(dmax.bit_length(), 1)
    thr, even = jc._threshold_words(jnp.asarray(tables.deg_ext), n_planes)
    c = 1
    flip = np.concatenate([tables.masks[c], [0]]).astype(np.uint32)
    end = jc._one_step(jnp.asarray(sp_ext), jnp.asarray(tables.nbr_ext), thr,
                       even, n, dmax, JRule.MAJORITY, JTie.STAY)
    end_all = jc._one_step(jnp.asarray(sp_ext ^ flip[:, None]),
                           jnp.asarray(tables.nbr_ext), thr, even, n, dmax,
                           JRule.MAJORITY, JTie.STAY)
    rng = np.random.default_rng(5)
    a = (rng.uniform(0.1, 3.0, Rp) * n).astype(np.float32)
    b = (rng.uniform(0.1, 3.0, Rp) * n).astype(np.float32)
    run = jax.jit(jc.accept_apply, static_argnames=("n",))
    sp_j, acc_j, ds_j = run(jnp.asarray(sp_ext), end, end_all, jnp.asarray(u),
                            jnp.asarray(tables.masks[c]), jnp.asarray(a),
                            jnp.asarray(b), jnp.asarray(active),
                            jnp.asarray(tables.nbr_self), n=n)
    sp_t, acc_t, ds_t = tc.accept_apply(
        words_from_numpy(sp_ext), words_from_numpy(np.asarray(end)),
        words_from_numpy(np.asarray(end_all)), torch.from_numpy(u),
        words_from_numpy(tables.masks[c][None])[0], torch.from_numpy(a),
        torch.from_numpy(b), torch.from_numpy(active),
        torch.from_numpy(tables.nbr_self), n=n)
    np.testing.assert_array_equal(words_to_numpy(sp_t), np.asarray(sp_j))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(ds_t.numpy(), np.asarray(ds_j))
    assert acc_t.any() and not acc_t.all()


@pytest.mark.parametrize("rule,tie", [("majority", "stay"),
                                      ("minority", "change")])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_class_update_equal_injected_u(gname, rule, tie):
    """One chromatic class step, called as ``tests/test_search.py`` calls the
    reference's. Words, ΔΣ, the accept count and the annealed drives are
    equal bit for bit (the port raises ``par`` to the class size with the
    C library's ``powf``, which is what XLA's f32 ``pow`` calls on the
    CPU)."""
    g, tables, sp_ext, u, active, Rp = _setup(gname)
    n, dmax = g.n, tables.dmax
    n_planes = max(dmax.bit_length(), 1)
    a = np.full(Rp, 0.7, np.float32)
    b = np.full(Rp, 1.3, np.float32)
    thr, even = jc._threshold_words(jnp.asarray(tables.deg_ext), n_planes)
    kw = dict(n=n, dmax=dmax, par_a=1.0005, par_b=1.0005, a_cap=1e9,
              b_cap=1e9)
    for c in range(tables.chi):
        want = jc.class_update(
            jnp.asarray(sp_ext), jnp.asarray(u), jnp.asarray(tables.masks[c]),
            jnp.int32(tables.class_sizes[c]), jnp.asarray(a), jnp.asarray(b),
            jnp.asarray(active), jnp.asarray(tables.nbr_ext),
            jnp.asarray(tables.nbr_self), thr, even,
            rule=JRule(rule), tie=JTie(tie), **kw)
        thr_t, even_t = tc._threshold_words(torch.from_numpy(tables.deg_ext),
                                            n_planes)
        got = tc.class_update(
            words_from_numpy(sp_ext), torch.from_numpy(u),
            words_from_numpy(tables.masks[c][None])[0],
            torch.tensor(int(tables.class_sizes[c]), dtype=torch.int32),
            torch.from_numpy(a), torch.from_numpy(b),
            torch.from_numpy(active), torch.from_numpy(tables.nbr_ext),
            torch.from_numpy(tables.nbr_self), thr_t, even_t,
            rule=Rule(rule), tie=TieBreak(tie), **kw)
        np.testing.assert_array_equal(words_to_numpy(got[0]),
                                      np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert int(got[4]) == int(want[4])


@pytest.mark.parametrize("par", [1.0005, 1.001, 0.9995, 1.0001, 1.01])
def test_anneal_factor_equals_xla_f32_pow(par):
    """The anneal factor over every exponent 0..20000 equals the JAX
    package's jitted f32 ``par ** k`` bit for bit (inf where it
    overflows, as there)."""
    ks = np.arange(0, 20001, dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, k: p ** k)(jnp.float32(par),
                                                    jnp.asarray(ks)))
    got = tc._anneal_factor(par, torch.from_numpy(ks.astype(np.int32)),
                            20000).numpy()
    np.testing.assert_array_equal(got, want)


def test_ball_counts_and_pack_roundtrip():
    g, tables, sp_ext, _, _, _ = _setup("er", R=64)
    want = np.asarray(jc._ball_counts(jnp.asarray(sp_ext),
                                      jnp.asarray(tables.nbr_self)))
    got = tc._ball_counts(words_from_numpy(sp_ext),
                          torch.from_numpy(tables.nbr_self))
    np.testing.assert_array_equal(got.numpy(), want)
    pm = tc._unpack_pm1(words_from_numpy(sp_ext))
    np.testing.assert_array_equal(
        pm.numpy(), np.asarray(jc._unpack_pm1(jnp.asarray(sp_ext))))
    np.testing.assert_array_equal(
        words_to_numpy(tc._pack_bool(pm > 0, 2)), sp_ext)
