"""The port's int8 synchronous dynamics against the JAX package's, bit for
bit, over the (rule, tie) matrix on RRG d=3, RRG d=4 and ragged ER (the
matrix of tests/test_dynamics.py). Inputs are made with numpy from a seed and
handed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import graphdyn
from graphdyn import graphs as jg
from graphdyn.ops import dynamics as jd
from graphdyn_torch import observe as tobs
from graphdyn_torch.interop import graph_from_arrays
from graphdyn_torch.ops import dynamics as td

RULE_TIE = [("majority", "stay"), ("majority", "change"),
            ("minority", "stay"), ("minority", "change")]

GRAPHS = {
    "rrg3": jg.random_regular_graph(60, 3, seed=0),
    "rrg4": jg.random_regular_graph(50, 4, seed=1),
    "er": jg.erdos_renyi_graph(80, 2.5 / 80, seed=2),   # ragged, isolates kept
}


def _spins(shape, seed):
    rng = np.random.default_rng(seed)
    return (2 * rng.integers(0, 2, size=shape) - 1).astype(np.int8)


@pytest.mark.parametrize("rule,tie", RULE_TIE)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_step_spins_matches_jax(name, rule, tie):
    g = GRAPHS[name]
    s = _spins(g.n, 1)
    ref = np.asarray(jd.step_spins(jnp.asarray(g.nbr), jnp.asarray(s), rule, tie))
    out = td.step_spins(torch.from_numpy(g.nbr), torch.from_numpy(s), rule, tie)
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("rule,tie", RULE_TIE)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_run_dynamics_single_and_batched_match_jax(name, rule, tie):
    g = GRAPHS[name]
    tg = graph_from_arrays(g.nbr, g.deg, g.edges)
    s1 = _spins(g.n, 2)
    ref1 = np.asarray(graphdyn.run_dynamics(g, s1, 5, rule, tie, backend="jax"))
    out1 = graphdyn_run_port(tg, s1, 5, rule, tie)
    np.testing.assert_array_equal(out1, ref1)
    sb = _spins((8, g.n), 3)
    refb = np.asarray(graphdyn.run_dynamics(g, sb, 4, rule, tie, backend="jax"))
    outb = graphdyn_run_port(tg, sb, 4, rule, tie)
    np.testing.assert_array_equal(outb, refb)


def graphdyn_run_port(g, s, steps, rule, tie):
    out = td.run_dynamics(g, s, steps, rule, tie, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("gather", ["fused", "per_slot"])
@pytest.mark.parametrize("rule,tie", RULE_TIE)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_batched_rollout_schedules_match_jax(name, rule, tie, gather):
    g = GRAPHS[name]
    s = _spins((6, g.n), 4)
    ref = np.asarray(jd.batched_rollout(jnp.asarray(g.nbr), jnp.asarray(s), 3,
                                        rule, tie, gather))
    out = td.batched_rollout(torch.from_numpy(g.nbr), torch.from_numpy(s), 3,
                             rule, tie, gather)
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), ref)


def test_end_state_coefficients_and_refusals():
    g = GRAPHS["er"]
    tg = graph_from_arrays(g.nbr, g.deg, g.edges)
    s = _spins((4, g.n), 5)
    ref = np.asarray(jd.end_state(g, s, 3, 2, "minority", "change", backend="jax"))
    out = td.end_state(tg, s, 3, 2, "minority", "change", device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    # a raw neighbor table works as the graph, as in the JAX package
    np.testing.assert_array_equal(
        td.run_dynamics(g.nbr, s[0], 2, device="cpu").numpy(),
        np.asarray(jd.run_dynamics(g.nbr, s[0], 2, backend="jax")))
    for rule, tie in RULE_TIE:
        assert td.rule_coefficients(rule, tie) == jd.rule_coefficients(rule, tie)
    st = torch.from_numpy(s)
    assert td.batched_rollout(torch.from_numpy(g.nbr), st, 0) is st
    with pytest.raises(ValueError, match="gather"):
        td.batched_rollout(torch.from_numpy(g.nbr), st, 1, gather="bogus")
    with pytest.raises(ValueError):
        td.step_spins(torch.from_numpy(g.nbr), st[0], rule="plurality")


def test_observables_match_jax():
    from graphdyn import observe as jobs

    s = _spins((16, 200), 6)
    s[3] = 1
    s[7] = -1
    np.testing.assert_array_equal(tobs.magnetization(torch.from_numpy(s)).numpy(),
                                  np.asarray(jobs.magnetization(s)))
    for target in (1, -1):
        assert float(tobs.consensus_fraction(torch.from_numpy(s), target)) == \
            float(jobs.consensus_fraction(s, target))
    assert tobs.spin_updates_per_sec(10, 32, 5, 2.0) == \
        jobs.spin_updates_per_sec(10, 32, 5, 2.0)
    assert tobs.tilted_entropy(0.5, 2.0, 0.25) == \
        float(jobs.tilted_entropy(0.5, 2.0, 0.25))
