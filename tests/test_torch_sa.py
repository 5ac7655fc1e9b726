"""The port's serial SA chain (``graphdyn_torch/models/sa.py``) against the
JAX package's ``graphdyn/models/sa.py``.

Parity under injected streams, on the ``tests/test_sa.py`` pattern: the same
``s0``, ``proposals`` and ``uniforms`` go into both packages, and
``num_steps``, ``s`` and ``m_final`` must be equal and ``mag_reached``
within 1e-6. In counter-stream mode the port's draws are its own, so the
test compares statistics over 16 seeds; the same chains are also held bit
for bit against the JAX package's PRNG chains by replaying the reference's
``jax.random`` draws as injected streams. Graphs: a d=3 RRG and a ragged ER
graph with isolates, both n = 60 (not a power of two, so ``·(1/n)`` and
``/n`` round differently) and padded to the same neighbor-table shape."""

import json
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.config import DynamicsConfig as JDyn, SAConfig as JSA
from graphdyn.models import sa as jsa
from graphdyn_torch.config import DynamicsConfig, SAConfig
from graphdyn_torch.interop import graph_from_arrays
from graphdyn_torch.models import sa as tsa
from graphdyn_torch.ops.dynamics import end_state

L = 300
GRAPHS = {
    "rrg": jg.random_regular_graph(60, 3, seed=5),
    # ragged (degrees 0..3, 18 isolates) in the RRG's padded shape [60, 3],
    # so the two graphs share the JAX package's compiles
    "er": jg.erdos_renyi_graph(60, 1.8 / 59, seed=9),
}
DYNAMICS = [(3, 1), (1, 1), (2, 2)]
RULES = [("majority", "stay"), ("minority", "change")]


def _port_graph(g):
    return graph_from_arrays(g.nbr, g.deg, g.edges)


def _streams(g, R=3, seed=11):
    rng = np.random.default_rng(seed)
    s0 = (2 * rng.integers(0, 2, size=(R, g.n)) - 1).astype(np.int8)
    proposals = rng.integers(0, g.n, size=(R, L)).astype(np.int32)
    uniforms = rng.random(size=(R, L))
    return s0, proposals, uniforms


def _configs(p, c, rule="majority", tie="stay"):
    return (JSA(dynamics=JDyn(p=p, c=c, rule=rule, tie=tie)),
            SAConfig(dynamics=DynamicsConfig(p=p, c=c, rule=rule, tie=tie)))


def assert_same_chains(want, got):
    np.testing.assert_array_equal(got.num_steps, want.num_steps)
    np.testing.assert_array_equal(got.s, want.s)
    np.testing.assert_array_equal(got.m_final, want.m_final)
    np.testing.assert_allclose(got.mag_reached, want.mag_reached, atol=1e-6)


@pytest.mark.parametrize("rule,tie", RULES, ids=["majority", "minority"])
@pytest.mark.parametrize("p,c", DYNAMICS, ids=["p3c1", "p1c1", "p2c2"])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_injected_stream_parity_with_jax(gname, p, c, rule, tie):
    g = GRAPHS[gname]
    s0, proposals, uniforms = _streams(g)
    jcfg, tcfg = _configs(p, c, rule, tie)
    kw = dict(s0=s0, proposals=proposals, uniforms=uniforms)
    want = jsa.simulated_annealing(g, jcfg, backend="jax", **kw)
    got = tsa.simulated_annealing(_port_graph(g), tcfg, device="cpu", **kw)
    assert_same_chains(want, got)


def test_float64_chain_equals_jax_under_x64():
    """``dtype='float64'`` is the reference's x64 chain: int64 step counter,
    no int32 clamp of the 2n³ budget, f64 ΔH and exp. JAX's x64 mode is
    switched on for the JAX side only and back off after it."""
    g = GRAPHS["er"]
    s0, proposals, uniforms = _streams(g, R=2)
    jcfg, tcfg = _configs(2, 1)
    kw = dict(s0=s0, proposals=proposals, uniforms=uniforms)
    jax.config.update("jax_enable_x64", True)
    try:
        want = jsa.simulated_annealing(g, jcfg, dtype=jnp.float64,
                                       backend="jax", **kw)
        jprep = jsa.prepare_sa_inputs(g, jcfg, n_replicas=2)
    finally:
        jax.config.update("jax_enable_x64", False)
    got = tsa.simulated_annealing(_port_graph(g), tcfg, dtype="float64",
                                  device="cpu", **kw)
    assert got.num_steps.dtype == want.num_steps.dtype == np.int64
    assert got.m_final.dtype == want.m_final.dtype == np.float64
    assert_same_chains(want, got)
    tprep = tsa.prepare_sa_inputs(_port_graph(g), tcfg, n_replicas=2,
                                  dtype="float64")
    assert tprep[7] == jprep[7] == 2 * g.n**3


@lru_cache(maxsize=None)
def _chunked_er_chains(chunk_steps):
    """The ER graph's p=2 chains in ``chunk_steps``-step chunks: injected
    streams, and the counter stream (a chain's draws depend only on its
    seed and step). Returns ``(injected, counter, host reads)``; made once
    per chunk length."""
    g = _port_graph(GRAPHS["er"])
    s0, proposals, uniforms = _streams(GRAPHS["er"])
    cfg = _configs(2, 1)[1]
    tsa.HOST_READS = 0
    injected = tsa.simulated_annealing(
        g, cfg, s0=s0, proposals=proposals, uniforms=uniforms,
        chunk_steps=chunk_steps, device="cpu")
    reads = tsa.HOST_READS
    counter = tsa.simulated_annealing(g, cfg, n_replicas=3, seed=4,
                                      max_steps=300, chunk_steps=chunk_steps,
                                      device="cpu")
    return injected, counter, reads


@pytest.mark.parametrize("chunk_steps", [1, 7, 100])
def test_chunk_length_does_not_change_the_chain(chunk_steps):
    base, a, _ = _chunked_er_chains(tsa.CHUNK_STEPS)
    split, b, reads = _chunked_er_chains(chunk_steps)
    assert_same_chains(base, split)
    assert reads <= int(split.num_steps.max()) / chunk_steps + 1
    assert_same_chains(a, b)


def _jax_draws(R, n, seed, steps):
    """The reference's PRNG-mode draws of replicas ``seed + r`` for steps
    0..steps-1, as injected streams ``[R, steps]``."""
    keys = jax.vmap(jax.random.PRNGKey)(
        np.arange(R, dtype=np.uint32) + np.uint32(seed))

    def at(t):
        return jsa.draw_sa_proposal(keys, jnp.full((R,), t, jnp.int32), None,
                                    None, injected=False, stream_len=1, n=n,
                                    dt=jnp.float32)

    i, u = jax.vmap(at)(jnp.arange(steps, dtype=jnp.int32))
    return np.array(i).T, np.array(u, np.float64).T


def test_replayed_jax_prng_chains_are_the_jax_chains():
    g = GRAPHS["rrg"]
    jcfg, tcfg = _configs(2, 1)
    R, seed, budget = 2, 7, 400
    want = jsa.simulated_annealing(g, jcfg, n_replicas=R, seed=seed,
                                   max_steps=budget, backend="jax")
    proposals, uniforms = _jax_draws(R, g.n, seed, budget + 1)
    got = tsa.simulated_annealing(_port_graph(g), tcfg, n_replicas=R,
                                  seed=seed, proposals=proposals,
                                  uniforms=uniforms, max_steps=budget,
                                  device="cpu")
    assert_same_chains(want, got)


def test_counter_stream_statistics_match_jax():
    """PRNG mode: the mean of ``mag_reached`` over 16 chains (seeds 0..15)
    at n=300 after a fixed 2000-step budget lies within 4 standard errors
    (4·sqrt(var_jax/16 + var_port/16)) of the JAX package's."""
    g = jg.random_regular_graph(300, 3, seed=1)
    jcfg, tcfg = _configs(1, 1)
    kw = dict(n_replicas=16, seed=0, max_steps=2000)
    want = jsa.simulated_annealing(g, jcfg, backend="jax", **kw)
    got = tsa.simulated_annealing(_port_graph(g), tcfg, device="cpu", **kw)
    mj = want.mag_reached.astype(np.float64)
    mt = got.mag_reached.astype(np.float64)
    se = np.sqrt(mj.var(ddof=1) / 16 + mt.var(ddof=1) / 16)
    assert abs(mj.mean() - mt.mean()) <= 4 * se, (mj.mean(), mt.mean(), se)
    assert np.all(got.num_steps == want.num_steps)   # all ran the budget


def test_consensus_chains_roll_out_to_all_plus_one():
    g = jg.random_regular_graph(24, 3, seed=2)
    tcfg = _configs(2, 1)[1]
    r = tsa.simulated_annealing(_port_graph(g), tcfg, n_replicas=3, seed=3,
                                max_steps=5000, device="cpu")
    assert np.any(r.m_final == 1.0)
    for k in np.flatnonzero(r.m_final == 1.0):
        out = end_state(_port_graph(g), r.s[k], 2, 1, device="cpu")
        assert torch.all(out == 1)
        assert r.mag_reached[k] < 1.0


def test_timeout_sentinel_and_step_budget():
    g = GRAPHS["rrg"]
    s0, proposals, uniforms = _streams(g, R=2)
    uniforms = np.full_like(uniforms, 0.999999)
    r = tsa.simulated_annealing(_port_graph(g), _configs(3, 1)[1], s0=s0,
                                proposals=proposals, uniforms=uniforms,
                                max_steps=10, device="cpu")
    done = r.m_final == 2.0
    assert np.all(done | (r.m_final == 1.0))
    assert np.all(r.num_steps[done] == 11)       # t passes max_steps


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_prepare_sa_inputs_and_energy_equal(gname):
    g = GRAPHS[gname]
    jcfg, tcfg = _configs(3, 1)
    for kw in (dict(n_replicas=4, seed=9),
               dict(n_replicas=3, seed=2, a0=np.arange(3.0), b0=2.5,
                    max_steps=10**12),
               dict(s0=_streams(g)[0], proposals=_streams(g)[1],
                    uniforms=_streams(g)[2], max_steps=50)):
        want = jsa.prepare_sa_inputs(g, jcfg, **kw)
        got = tsa.prepare_sa_inputs(_port_graph(g), tcfg, **kw)
        assert len(want) == len(got)
        for w, t in zip(want, got):
            np.testing.assert_array_equal(np.asarray(t), np.asarray(w))
    s = _streams(g)[0]
    want = jsa.energy(g, s, 0.9, 0.6, 3, 1, backend="jax")
    got = tsa.energy(_port_graph(g), s, 0.9, 0.6, 3, 1, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert tsa.energy(_port_graph(g), s[0], 0.9, 0.6, 3, 1,
                      device="cpu") == want[0]


def test_refusals_name_the_roadmap_item():
    g = _port_graph(GRAPHS["rrg"])
    cfg = _configs(3, 1)[1]
    for kernel in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="fused_anneal"):
            tsa.simulated_annealing(g, cfg, kernel=kernel, device="cpu")
    # the bucketed and streamed layouts run since the power-law slice; what
    # stays refused names its item (checkpoints, A16), and the layouts'
    # own refusals are the JAX package's
    for kw, item in ((dict(checkpoint_path="x"), "A16"),
                     (dict(checkpoint_path="x", layout="streamed"), "A16")):
        with pytest.raises(NotImplementedError, match=item):
            tsa.simulated_annealing(g, cfg, device="cpu", **kw)
    with pytest.raises(ValueError, match="proposals"):
        tsa.simulated_annealing(g, cfg, layout="bucketed", device="cpu",
                                proposals=np.zeros((1, 2), np.int32),
                                uniforms=np.zeros((1, 2)))
    with pytest.raises(ValueError, match="rollout_mode='full'"):
        tsa.simulated_annealing(g, cfg, layout="streamed",
                                rollout_mode="lightcone", device="cpu")
    with pytest.raises(NotImplementedError, match="A16"):
        tsa.sa_ensemble(20, 3, cfg, checkpoint_path="x", device="cpu")
    with pytest.raises(ValueError, match="rollout_mode"):
        tsa.simulated_annealing(g, cfg, rollout_mode="x", device="cpu")


CLI_CASES = {
    "sa": ["sa", "--n", "30", "--d", "3", "--n-stat", "2", "--max-steps",
           "30"],
    "chromatic": ["chromatic", "--n", "40", "--replicas", "3",
                  "--max-sweeps", "2"],
    "temper": ["temper", "--n", "40", "--lanes", "3", "--max-steps", "60",
               "--swap-interval", "20"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_json_and_npz_keys_are_the_references(case, tmp_path, capsys):
    from graphdyn.cli import main as jmain
    from graphdyn_torch.cli import main as tmain

    argv = CLI_CASES[case]
    docs, files = [], []
    for name, main, extra in (("jax", jmain, []),
                              ("port", tmain, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.npz")
        assert main(argv + extra + ["--out", out]) == 0
        docs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
        with np.load(out) as f:
            files.append(sorted(f.files))
    assert sorted(docs[1]) == sorted(docs[0])
    assert docs[1]["solver"] == docs[0]["solver"]
    assert files[1] == files[0]


@pytest.mark.parametrize("argv,item", [
    (["sa", "--sharded"], "A15"), (["sa", "--shards", "2"], "A15"),
    (["sa", "--checkpoint", "x"], "A16"),
    # the layouts run since the power-law slice; with a flag that is not
    # ported they still refuse, naming that flag's item
    (["sa", "--layout", "bucketed", "--checkpoint", "x"], "A16"),
    (["sa", "--layout", "streamed", "--shards", "2"], "A15"),
    (["temper", "--lane-shards", "2"], "A15"),
    (["temper", "--checkpoint", "x"], "A16"),
], ids=["sharded", "shards", "sa_checkpoint", "bucketed", "streamed",
        "lane_shards", "temper_checkpoint"])
def test_cli_refuses_what_is_not_ported(argv, item):
    from graphdyn_torch.cli import main as tmain

    with pytest.raises(SystemExit, match=item):
        tmain(argv + ["--n", "30", "--device", "cpu"])
