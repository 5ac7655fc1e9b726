"""The port's light-cone evaluation (``graphdyn_torch/ops/lightcone.py``)
against the JAX package's ``graphdyn/ops/lightcone.py``: the host and the
device ball tables equal the reference's, the trajectory and one flip's
delta and scatter equal the reference's, and the light-cone chain equals
the full-rollout chain in the port and the JAX package's light-cone chain
under injected streams (the ``tests/test_sa.py:247`` pattern)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.config import DynamicsConfig as JDyn, SAConfig as JSA
from graphdyn.models import sa as jsa
from graphdyn.ops import lightcone as jl
from graphdyn_torch.config import DynamicsConfig, SAConfig
from graphdyn_torch.interop import (
    graph_from_arrays,
    lightcone_tables_from_jax,
    sa_state_from_jax,
    sa_state_to_numpy,
)
from graphdyn_torch.models import sa as tsa
from graphdyn_torch.ops import lightcone as tl

L = 300
GRAPHS = {
    "rrg": jg.random_regular_graph(60, 3, seed=5),
    # ragged (degrees 0..3, 18 isolates) in the RRG's padded shape [60, 3],
    # so the two graphs share the JAX package's compiles
    "er": jg.erdos_renyi_graph(60, 1.8 / 59, seed=9),
}
CHAINS = [(1, 1, "majority", "stay"), (3, 1, "majority", "stay"),
          (2, 2, "majority", "stay"), (2, 1, "minority", "change")]


def _port_graph(g):
    return graph_from_arrays(g.nbr, g.deg, g.edges)


def _assert_tables_equal(got, want):
    for name in ("ball", "nbr_slot", "nbr_glob"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert (got.radius, got.ball_max) == (want.radius, want.ball_max)


@pytest.mark.parametrize("radius", [1, 3])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_tables_equal_jax_host_and_device_builders(gname, radius):
    g = GRAPHS[gname]
    tg = _port_graph(g)
    _assert_tables_equal(
        tl.build_lightcone_tables(tg, radius, device="cpu"),
        jl.build_lightcone_tables(g, radius))
    _assert_tables_equal(
        tl.build_lightcone_tables_device(tg, radius, device="cpu"),
        jl.build_lightcone_tables_device(g, radius))
    assert tl.ball_bound(g.dmax, radius) == jl.ball_bound(g.dmax, radius)
    assert tl._adjacency_checksums(g.nbr) == jl._adjacency_checksums(g.nbr)
    assert tl._adjacency_checksums(torch.from_numpy(g.nbr)) == \
        jl._adjacency_checksums(jnp.asarray(g.nbr))


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_trajectory_flip_delta_and_accept_equal_jax(gname):
    g = GRAPHS[gname]
    radius, (R_coef, C_coef) = 2, (1, -1)          # majority / change
    rng = np.random.default_rng(3)
    s = (2 * rng.integers(0, 2, size=(4, g.n)) - 1).astype(np.int8)
    i = rng.integers(0, g.n, size=4).astype(np.int32)
    do = np.array([True, False, True, True])
    jt = jl.build_lightcone_tables(g, radius)
    tt = lightcone_tables_from_jax(jt)
    traj_j = jl.batched_trajectory(jnp.asarray(g.nbr), jnp.asarray(s),
                                   radius, R_coef, C_coef)
    traj_t = tl.batched_trajectory(torch.from_numpy(g.nbr),
                                   torch.from_numpy(s), radius, R_coef,
                                   C_coef)
    np.testing.assert_array_equal(traj_t.numpy(), np.asarray(traj_j))
    dj, vj = jl.lightcone_flip_delta(jt, traj_j, jnp.asarray(i), R_coef,
                                     C_coef, radius)
    dt_, vt = tl.lightcone_flip_delta(tt, traj_t, torch.from_numpy(i),
                                      R_coef, C_coef, radius)
    np.testing.assert_array_equal(dt_.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    nj = np.asarray(jl.lightcone_accept(jt, traj_j, jnp.asarray(i), vj,
                                        jnp.asarray(do)))
    nt = tl.lightcone_accept(tt, traj_t, torch.from_numpy(i), vt,
                             torch.from_numpy(do)).numpy()
    # the trash column n+1 takes whatever rejected scatters write
    np.testing.assert_array_equal(nt[:, :, :g.n + 1], nj[:, :, :g.n + 1])


@pytest.mark.parametrize("p,c,rule,tie", CHAINS,
                         ids=["p1c1", "p3c1", "p2c2", "minority"])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_lightcone_equals_full_and_jax_lightcone(gname, p, c, rule, tie):
    g = GRAPHS[gname]
    rng = np.random.default_rng(11)
    R = 3
    kw = dict(s0=(2 * rng.integers(0, 2, size=(R, g.n)) - 1).astype(np.int8),
              proposals=rng.integers(0, g.n, size=(R, L)).astype(np.int32),
              uniforms=rng.random(size=(R, L)))
    tcfg = SAConfig(dynamics=DynamicsConfig(p=p, c=c, rule=rule, tie=tie))
    jcfg = JSA(dynamics=JDyn(p=p, c=c, rule=rule, tie=tie))
    tg = _port_graph(g)
    full = tsa.simulated_annealing(tg, tcfg, device="cpu", **kw)
    lc = tsa.simulated_annealing(tg, tcfg, rollout_mode="lightcone",
                                 device="cpu", **kw)
    want = jsa.simulated_annealing(g, jcfg, rollout_mode="lightcone",
                                   backend="jax", **kw)
    for got in (lc, full):
        np.testing.assert_array_equal(got.s, want.s)
        np.testing.assert_array_equal(got.num_steps, want.num_steps)
        np.testing.assert_array_equal(got.m_final, want.m_final)
        np.testing.assert_array_equal(got.mag_reached, want.mag_reached)


def test_prebuilt_and_device_tables_run_the_same_chain_and_bad_ones_refuse():
    g = GRAPHS["rrg"]
    tg = _port_graph(g)
    cfg = SAConfig(dynamics=DynamicsConfig(p=2, c=1))
    rng = np.random.default_rng(2)
    kw = dict(s0=(2 * rng.integers(0, 2, size=(2, g.n)) - 1).astype(np.int8),
              proposals=rng.integers(0, g.n, size=(2, L)).astype(np.int32),
              uniforms=rng.random(size=(2, L)), rollout_mode="lightcone",
              device="cpu")
    base = tsa.simulated_annealing(tg, cfg, **kw)
    for tables in (tl.build_lightcone_tables_device(tg, 2, device="cpu"),
                   lightcone_tables_from_jax(jl.build_lightcone_tables(g, 2))):
        got = tsa.simulated_annealing(tg, cfg, lc_tables=tables, **kw)
        np.testing.assert_array_equal(got.s, base.s)
        np.testing.assert_array_equal(got.num_steps, base.num_steps)
    other = _port_graph(jg.random_regular_graph(60, 3, seed=6))
    for bad in (tl.build_lightcone_tables(tg, 3, device="cpu"),
                tl.build_lightcone_tables(other, 2, device="cpu")):
        with pytest.raises(ValueError, match="different graph or radius"):
            tsa.simulated_annealing(tg, cfg, lc_tables=bad, **kw)


def test_chain_resumes_from_a_jax_mid_chain_state():
    """The port continues a light-cone chain from the JAX package's state
    after 150 steps (:func:`sa_state_from_jax`) and ends where the JAX
    chain ends."""
    g = GRAPHS["er"]
    p, c, (R_coef, C_coef), radius = 2, 1, (1, 1), 2
    rng = np.random.default_rng(5)
    R = 2
    s0 = (2 * rng.integers(0, 2, size=(R, g.n)) - 1).astype(np.int8)
    prop = rng.integers(0, g.n, size=(R, L)).astype(np.int32)
    unif = rng.random(size=(R, L)).astype(np.float32)
    jt = jl.build_lightcone_tables(g, radius)
    nbr = jnp.asarray(g.nbr)
    keys = jnp.zeros((R, 2), jnp.uint32)
    st = jsa._sa_init(nbr, jnp.asarray(s0), keys, jnp.full(R, 0.9, jnp.float32),
                      jnp.full(R, 0.6, jnp.float32), rollout_steps=radius,
                      R_coef=R_coef, C_coef=C_coef, lightcone=True)
    consts = (jnp.float32(1.0005), jnp.float32(1.0005),
              jnp.float32(4.5 * g.n), jnp.float32(5.0 * g.n),
              jnp.asarray(prop), jnp.asarray(unif))
    loop_kw = dict(rollout_steps=radius, R_coef=R_coef, C_coef=C_coef,
                   max_steps=L, injected=True, stream_len=L, lc_tables=jt)
    mid = jsa._sa_loop(nbr, st, *consts, chunk_steps=150, **loop_kw)
    end = jsa._sa_loop(nbr, mid._replace(chunk_t=jnp.zeros((), jnp.int32)),
                       *consts, **loop_kw)
    tg = _port_graph(g)
    cfg = SAConfig(dynamics=DynamicsConfig(p=p, c=c))
    got = tsa._sa_loop(
        None, sa_state_from_jax(mid, seeds=[0, 1]),
        tsa.sa_consts(cfg, g.n, torch.float32, "cpu"),
        torch.from_numpy(prop), torch.from_numpy(unif),
        rollout_steps=radius, R_coef=R_coef, C_coef=C_coef, max_steps=L,
        injected=True, stream_len=L, chunk_steps=L,
        lc_tables=tl.build_lightcone_tables(tg, radius, device="cpu"))
    got = sa_state_to_numpy(got)
    for name in ("sum_end", "a", "b", "t", "m_final", "active"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(end, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got["traj"][:, :, :g.n + 1],
                                  np.asarray(end.traj)[:, :, :g.n + 1])
