"""The port's chromatic chain (``ChromState``/``chromatic_chunk`` in
``graphdyn_torch/ops/chromatic.py`` and ``search/chromatic.py``) against the
JAX package.

The reference's ``chromatic_chunk`` draws its uniforms inside the loop from
``jax.random``, so the parity oracle is a loop of the JAX package's
``class_update`` over the same injected uniforms, with the chunk's
bookkeeping (end sums, first passages, freezing, the per-sweep stop test).
The chain starts from a JAX ``ChromState`` after one sweep of the
reference's own chunk (:func:`chrom_state_from_jax`)."""

from functools import lru_cache, partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.config import DynamicsConfig as JDyn, SAConfig as JSA
from graphdyn.ops import chromatic as jc
from graphdyn.ops.dynamics import Rule as JRule, TieBreak as JTie
from graphdyn.ops.packed import pack_spins as j_pack_spins
from graphdyn.search.chromatic import chromatic_anneal as j_chromatic_anneal
from graphdyn_torch.config import DynamicsConfig, SAConfig
from graphdyn_torch.interop import (
    chrom_state_from_jax,
    graph_from_arrays,
    words_to_numpy,
)
from graphdyn_torch.ops import chromatic as tc
from graphdyn_torch.search.chromatic import chromatic_anneal

GRAPHS = {
    "rrg": jg.random_regular_graph(60, 3, seed=1),
    "er": jg.erdos_renyi_graph(50, 4.0 / 49, seed=2),     # ragged, isolates
}
SWEEPS = 3
CFG = dict(par_a=1.0005, par_b=1.0005)


@lru_cache(maxsize=None)
def _start(gname, rule, tie, R=5):
    """The reference's initial state (``chromatic_anneal``'s assembly) and
    one sweep of its own chunk, keyed by jax.random (made once per graph
    and rule, for both ``stop_on_first`` cases)."""
    g = GRAPHS[gname]
    n = g.n
    tables = jc.build_chromatic_tables(g, seed=0)
    W = -(-R // 32)
    Rp = 32 * W
    rng = np.random.default_rng(4)
    s0 = (2 * rng.integers(0, 2, size=(R, n)) - 1).astype(np.int8)
    sp = j_pack_spins(s0)
    sum_end0 = jc.replica_end_sums(sp, tables.nbr_ext, tables.deg_ext, n,
                                   tables.dmax, rule, tie)
    real = np.zeros(Rp, bool)
    real[:R] = True
    st = jc.ChromState(
        sp=jnp.asarray(sp), sum_end=sum_end0,
        a=jnp.full(Rp, 0.015 * n, jnp.float32),
        b=jnp.full(Rp, 0.010 * n, jnp.float32),
        steps=jnp.int32(0), sweeps=jnp.int32(0),
        t_target=jnp.full(Rp, -1, jnp.int32), active=jnp.asarray(real),
        accepted=jnp.int32(0), chunk_s=jnp.int32(0))
    static = dict(n=n, dmax=tables.dmax, rule=rule, tie=tie,
                  a_cap=4.5 * n, b_cap=5.0 * n, target_sum=int(0.3 * n), **CFG)
    args = (jnp.asarray(tables.masks), jnp.asarray(tables.class_sizes, jnp.int32),
            jnp.asarray(tables.nbr_ext), jnp.asarray(tables.nbr_self),
            jnp.asarray(tables.deg_ext))
    st = jc.chromatic_chunk(st, jax.random.PRNGKey(7), *args, chunk_sweeps=1,
                            **static)
    return tables, st, static, Rp


@lru_cache(maxsize=None)
def _jitted_class_update(n, dmax, rule, tie, par_a, par_b, a_cap, b_cap):
    """The JAX package's ``class_update`` jitted once per set of statics,
    so that the cases of one graph and rule share its compile."""
    return jax.jit(partial(
        jc.class_update, n=n, dmax=dmax, rule=JRule(rule), tie=JTie(tie),
        par_a=par_a, par_b=par_b, a_cap=a_cap, b_cap=b_cap))


def _oracle(tables, st, u_steps, static, sweeps, stop_on_first):
    """A loop of the JAX package's ``class_update`` with the chunk's
    bookkeeping, on numpy/JAX arrays."""
    n, dmax = static["n"], static["dmax"]
    n_planes = max(int(dmax).bit_length(), 1)
    thr_bits, even_mask = jc._threshold_words(jnp.asarray(tables.deg_ext),
                                              n_planes)
    step = _jitted_class_update(
        n, dmax, static["rule"], static["tie"], static["par_a"],
        static["par_b"], static["a_cap"], static["b_cap"])
    sp, sum_end = np.asarray(st.sp), np.asarray(st.sum_end)
    a, b = np.asarray(st.a), np.asarray(st.b)
    steps, n_sweeps = int(st.steps), int(st.sweeps)
    t_tgt, active = np.asarray(st.t_target), np.asarray(st.active)
    accepted = int(st.accepted)
    for _ in range(sweeps):
        if not active.any() or (stop_on_first and (t_tgt >= 0).any()):
            break
        for c in range(tables.chi):
            sp_ext = np.concatenate([sp, np.zeros((1, sp.shape[1]), np.uint32)])
            sp_ext, dsend, a, b, n_acc = step(
                jnp.asarray(sp_ext), jnp.asarray(u_steps[steps]),
                jnp.asarray(tables.masks[c]),
                jnp.int32(tables.class_sizes[c]), jnp.asarray(a),
                jnp.asarray(b), jnp.asarray(active),
                jnp.asarray(tables.nbr_ext), jnp.asarray(tables.nbr_self),
                thr_bits, even_mask)
            sp = np.asarray(sp_ext)[:n]
            a, b = np.asarray(a), np.asarray(b)
            sum_end = sum_end + np.asarray(dsend)
            steps += 1
            hit = active & (sum_end >= static["target_sum"])
            t_tgt = np.where(hit, steps, t_tgt)
            active = active & ~hit
            accepted += int(n_acc)
        n_sweeps += 1
    return dict(sp=sp, sum_end=sum_end, a=a, b=b, steps=steps,
                sweeps=n_sweeps, t_target=t_tgt, active=active,
                accepted=accepted)


@pytest.mark.parametrize("stop_on_first", [False, True],
                         ids=["all", "stop_on_first"])
@pytest.mark.parametrize("rule,tie", [("majority", "stay"),
                                      ("minority", "change")],
                         ids=["majority", "minority"])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_chunk_under_injected_uniforms_equals_class_update_loop(
        gname, rule, tie, stop_on_first):
    g = GRAPHS[gname]
    tables, st, static, Rp = _start(gname, rule, tie)
    rng = np.random.default_rng(9)
    u_steps = rng.random((int(st.steps) + SWEEPS * tables.chi, g.n, Rp)
                         ).astype(np.float32)
    want = _oracle(tables, st, u_steps, static, SWEEPS, stop_on_first)
    tt = tc.ChromaticTables(*(np.array(f) for f in tables))
    tst = chrom_state_from_jax(st._replace(chunk_s=jnp.int32(0)))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    got = tc.chromatic_chunk(
        tst, 0, t(tt.masks.view(np.int32)), t(tt.class_sizes.astype(np.int32)),
        t(tt.nbr_ext), t(tt.nbr_self), t(tt.deg_ext),
        chunk_sweeps=SWEEPS, stop_on_first=stop_on_first,
        uniforms=torch.from_numpy(u_steps), **static)
    np.testing.assert_array_equal(words_to_numpy(got.sp), want["sp"])
    for name in ("sum_end", "a", "b", "t_target", "active"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name],
                                      err_msg=name)
    for name in ("steps", "sweeps", "accepted"):
        assert int(getattr(got, name)) == want[name], name
    assert int(got.chunk_s) == want["sweeps"] - int(st.sweeps)


def _port_graph(g):
    return graph_from_arrays(g.nbr, g.deg, g.edges)


def test_anneal_is_reproducible_chunk_invariant_and_reaches_the_target():
    g = _port_graph(GRAPHS["rrg"])
    cfg = SAConfig(dynamics=DynamicsConfig(p=1, c=1))
    kw = dict(n_replicas=5, seed=3, m_target=0.3, max_sweeps=40,
              device="cpu")
    a = chromatic_anneal(g, cfg, chunk_sweeps=7, **kw)
    b = chromatic_anneal(g, cfg, chunk_sweeps=3, **kw)
    for name in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), name)
    assert np.all(a.steps_to_target >= 0)
    assert np.all(a.m_end >= 0.3)
    np.testing.assert_array_equal(a.sweeps_to_target,
                                  a.steps_to_target / a.chi)
    # the JAX package's run has the same tables, initial state and fields
    want = j_chromatic_anneal(GRAPHS["rrg"], JSA(dynamics=JDyn(p=1, c=1)),
                              n_replicas=5, seed=3, m_target=0.3,
                              max_sweeps=1)
    assert a._fields == want._fields and a.chi == want.chi


def test_refusals():
    g = _port_graph(GRAPHS["rrg"])
    with pytest.raises(ValueError, match="p = c = 1"):
        chromatic_anneal(g, SAConfig(dynamics=DynamicsConfig(p=2, c=1)),
                         device="cpu")
    cfg = SAConfig(dynamics=DynamicsConfig(p=1, c=1))
    for kw, what in ((dict(m_target=0.0), "m_target"),
                     (dict(chunk_sweeps=0), "chunk_sweeps"),
                     (dict(max_sweeps=0), "max_sweeps")):
        with pytest.raises(ValueError, match=what):
            chromatic_anneal(g, cfg, device="cpu", **kw)
