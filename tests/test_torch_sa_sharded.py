"""The port's sharded SA solver (``graphdyn_torch.parallel.sa_sharded``) on
spawned gloo ranks (4 ranks, one spawn for the module), against the JAX
package's ``sa_sharded`` on its 8-device CPU mesh and against the
unsharded solvers, bit for bit (spins, steps, sentinels; injected streams):

- gather, halo and light-cone modes on a 2 × 2 replica × node mesh (and
  1 × 4, 4 × 1), an RRG and a ragged ER graph, hubs split in halo mode, a
  padded replica axis with the timeout sentinel, a temperature ladder;
- the port's counter stream: equal to the port's unsharded
  ``simulated_annealing`` under the same seed;
- one chain preempted at P = 2 (gather), resumed and preempted again at
  P = 4 (halo) and finished at P = 1 (light-cone): equal to its
  uninterrupted twin;
- the refusals (streamed layout, halo with one shard, an unknown rollout
  mode, a partition without the halo mode)."""

import numpy as np
import pytest

from graphdyn.config import DynamicsConfig as JDyn
from graphdyn.config import SAConfig as JSA
from graphdyn.graphs import erdos_renyi_graph as j_er
from graphdyn.graphs import random_regular_graph as j_rrg
from graphdyn.models.sa import simulated_annealing as j_sa
from graphdyn.parallel.mesh import device_pool, make_mesh as j_make_mesh
from graphdyn.parallel.sa_sharded import sa_sharded as j_sa_sharded
from graphdyn_torch.config import DynamicsConfig, SAConfig
from graphdyn_torch.models.sa import simulated_annealing as t_sa

import torch_ranks

RRG = ("rrg", 60, 3, 5)
ER = ("er", 59, 4.0, 3)
PL = ("powerlaw", 90, 2.2, 4)


def _case(key, graph, shape, node_mode, rollout_mode="full", **kw):
    return dict(key=key, graph=graph, shape=shape, node_mode=node_mode,
                rollout_mode=rollout_mode, R=kw.pop("R", 4),
                L=kw.pop("L", 400), seed=kw.pop("seed", 6), **kw)


CASES = [
    _case("gather-2x2", RRG, (2, 2), "gather"),
    _case("halo-2x2", RRG, (2, 2), "halo"),
    _case("lightcone-4x1", RRG, (4, 1), "gather", "lightcone"),
    _case("gather-1x4", RRG, (1, 4), "gather"),
    _case("halo-1x4", RRG, (1, 4), "halo"),
    _case("er-gather-2x2", ER, (2, 2), "gather", L=300, seed=4),
    _case("er-halo-1x4", ER, (1, 4), "halo", L=300, seed=4),
    _case("pl-halo-hubs-1x4", PL, (1, 4), "halo", L=300, seed=2, hub=6),
    _case("pl-halo-hubs-2x2", PL, (2, 2), "halo", L=300, seed=2, hub=6),
    _case("pad-timeout-4x1", RRG, (4, 1), "gather", R=3, L=40, seed=11,
          max_steps=30),
    _case("ladder-2x2", RRG, (2, 2), "halo", seed=13,
          a0=np.linspace(0.5, 2.0, 4) * 60 * 0.015),
    _case("prng-2x2", RRG, (2, 2), "gather", injected=False, prng_seed=3,
          max_steps=400),
    _case("prng-lightcone-4x1", RRG, (4, 1), "gather", "lightcone",
          injected=False, prng_seed=3, max_steps=400),
    _case("p3-halo-2x2", RRG, (2, 2), "halo", p=3, L=300, seed=9),
]
BY_KEY = {c["key"]: c for c in CASES}
RESUME = dict(graph=RRG, R=4, L=400, seed=21, legs=[
    dict(shape=(2, 2), node_mode="gather", rollout_mode="full",
         preempt_at=2),
    dict(shape=(1, 4), node_mode="halo", rollout_mode="full", preempt_at=2),
    dict(shape=(4, 1), node_mode="gather", rollout_mode="lightcone"),
])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sa_sharded_ranks"))
    res = torch_ranks.run_ranks("sa_sharded_worker", 4, root, CASES, RESUME,
                                root)
    for r in res[1:]:                   # every rank returns the same result
        for k, v in res[0].items():
            if k == "resume":
                continue
            for f in v:
                np.testing.assert_array_equal(r[k][f], v[f])
    return res[0]


def _jgraph(gargs):
    kind, n, a, s = gargs
    if kind == "rrg":
        return j_rrg(n, a, seed=s)
    if kind == "er":
        return j_er(n, a / (n - 1), seed=s)
    from graphdyn.graphs import powerlaw_graph

    return powerlaw_graph(n, gamma=a, dmin=2, seed=s)


def _same(got, want):
    np.testing.assert_array_equal(got["s"], np.asarray(want.s))
    np.testing.assert_array_equal(got["num_steps"],
                                  np.asarray(want.num_steps))
    np.testing.assert_array_equal(got["m_final"], np.asarray(want.m_final))
    np.testing.assert_array_equal(got["mag_reached"],
                                  np.asarray(want.mag_reached))


def _jax_unsharded(c):
    g, s0, prop, unif = torch_ranks._sa_inputs(c["graph"], c["R"], c["L"],
                                               c["seed"])
    return j_sa(_jgraph(c["graph"]), JSA(dynamics=JDyn(p=c.get("p", 1), c=1)),
                s0=s0, a0=c.get("a0"), proposals=prop, uniforms=unif,
                max_steps=c.get("max_steps"))


INJECTED = [c["key"] for c in CASES if c.get("injected", True)]


@pytest.mark.parametrize("key", INJECTED)
def test_injected_chains_equal_the_jax_unsharded_solver(ranks, key):
    _same(ranks[key], _jax_unsharded(BY_KEY[key]))


@pytest.mark.parametrize("key", ["gather-2x2", "halo-2x2", "lightcone-4x1",
                                 "pl-halo-hubs-2x2"])
def test_injected_chains_equal_jax_sa_sharded(ranks, key):
    c = BY_KEY[key]
    g, s0, prop, unif = torch_ranks._sa_inputs(c["graph"], c["R"], c["L"],
                                               c["seed"])
    gj = _jgraph(c["graph"])
    kw = {}
    if c.get("hub"):
        from graphdyn.graphs import partition_graph

        kw["partition"] = partition_graph(gj, c["shape"][1], seed=0,
                                          hub_threshold=c["hub"])
    shape = c["shape"]
    mesh = j_make_mesh(shape, ("replica", "node"),
                       devices=device_pool(shape[0] * shape[1]))
    want = j_sa_sharded(gj, JSA(dynamics=JDyn(p=c.get("p", 1), c=1)),
                        mesh=mesh, s0=s0, proposals=prop, uniforms=unif,
                        node_mode=c["node_mode"],
                        rollout_mode=c["rollout_mode"], **kw)
    _same(ranks[key], want)


@pytest.mark.parametrize("key", ["prng-2x2", "prng-lightcone-4x1"])
def test_counter_stream_equals_the_unsharded_port(ranks, key):
    c = BY_KEY[key]
    g, s0, _, _ = torch_ranks._sa_inputs(c["graph"], c["R"], c["L"],
                                         c["seed"])
    want = t_sa(g, SAConfig(dynamics=DynamicsConfig(p=1, c=1)), s0=s0,
                seed=c["prng_seed"], max_steps=c["max_steps"],
                rollout_mode=c["rollout_mode"], device="cpu")
    _same(ranks[key], want)


def test_pad_replicas_and_timeout_sentinel(ranks):
    got = ranks["pad-timeout-4x1"]
    assert got["s"].shape == (3, 60)
    assert (got["m_final"] == 2.0).any() or (got["num_steps"] <= 30).all()


def test_resume_across_shard_counts(ranks):
    legs = ranks["resume"]
    assert [x[0] for x in legs] == ["preempted", "preempted", "done"]
    c = dict(RESUME, p=1)
    _same(legs[-1][1], _jax_unsharded(c))


def test_refusals():
    from graphdyn_torch.parallel.sa_sharded import sa_sharded

    class Mesh:                      # a 1 × 1 mesh, rank 0
        mesh_dim_names = ("replica", "node")
        shape = (1, 1)

        def get_local_rank(self, name):
            return 0

    g = torch_ranks._graph(*RRG)
    with pytest.raises(NotImplementedError, match="A15b"):
        sa_sharded(g, mesh=Mesh(), layout="streamed", device="cpu")
    with pytest.raises(ValueError, match="node axis of size >= 2"):
        sa_sharded(g, mesh=Mesh(), node_mode="halo", device="cpu")
    with pytest.raises(ValueError, match="rollout_mode"):
        sa_sharded(g, mesh=Mesh(), rollout_mode="x", device="cpu")
    with pytest.raises(ValueError, match="partition= requires"):
        sa_sharded(g, mesh=Mesh(), partition=object(), device="cpu")
