"""The port's replica-exchange ladder (``graphdyn_torch/search/tempering.py``)
against the JAX package's ``graphdyn/search/tempering.py`` and against the
port's own serial chain.

The reference draws lane steps and swaps from ``jax.random`` with no
injected mode, so the cross-package check replays its draws: the lanes'
proposals and uniforms as injected streams, and the swap uniforms through
the port's ``swap_uniforms``. The port's own structure is held too: with
swaps off the ladder is ``simulated_annealing`` on the same seeds, and an
equal-β ladder accepts every swap. One RRG(64, 3), p = c = 1."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.config import DynamicsConfig as JDyn, SAConfig as JSA
from graphdyn.models import sa as jsa
from graphdyn.search import tempering as jt
from graphdyn_torch.config import DynamicsConfig, SAConfig
from graphdyn_torch.interop import graph_from_arrays, temper_state_from_jax
from graphdyn_torch.models import sa as tsa
from graphdyn_torch.search import tempering as tt

G = jg.random_regular_graph(64, 3, seed=0)
TG = graph_from_arrays(G.nbr, G.deg, G.edges)
CFG = SAConfig(dynamics=DynamicsConfig(p=1, c=1))
JCFG = JSA(dynamics=JDyn(p=1, c=1))


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


@pytest.mark.parametrize("args", [(1,), (2,), (8,), (5, 0.5, 20.0),
                                  (8, 1.0, 64.0)])
def test_ladder_betas_equal_jax(args):
    np.testing.assert_array_equal(tt.ladder_betas(*args),
                                  jt.ladder_betas(*args))


@lru_cache(maxsize=None)
def _jax_lane_draws(K, n, seed, steps):
    keys = jax.vmap(jax.random.PRNGKey)(
        np.arange(K, dtype=np.uint32) + np.uint32(seed))

    def at(t):
        return jsa.draw_sa_proposal(keys, jnp.full((K,), t, jnp.int32), None,
                                    None, injected=False, stream_len=1, n=n,
                                    dt=jnp.float32)

    i, u = jax.vmap(at)(jnp.arange(steps, dtype=jnp.int32))
    return np.array(i).T, np.array(u, np.float64).T


# the ladder of the cases that replay the JAX package's draws: they share
# its compiles (one lane count, budget and swap interval)
K, SEED, BUDGET, INTERVAL = 4, 3, 500, 100


def _replay_jax_swaps(monkeypatch):
    """The port's swap uniforms replaced by the reference's ``jax.random``
    draws of the ladder seeded by :data:`SEED`."""
    swap_key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(SEED)),
                                  np.uint32(0x53574150))

    def jax_swap_uniforms(seed_, swap_round, K, dt):
        u = jax.random.uniform(
            jax.random.fold_in(swap_key, np.uint32(int(swap_round))), (K,),
            jnp.float32)
        return torch.from_numpy(np.array(u)).to(dt)

    monkeypatch.setattr(tt, "swap_uniforms", jax_swap_uniforms)


@pytest.mark.parametrize("stop_on_first", [False, True],
                         ids=["to_budget", "stop_on_first"])
def test_replayed_jax_ladder_with_swaps_is_the_jax_ladder(monkeypatch,
                                                          stop_on_first):
    kw = dict(n_lanes=K, seed=SEED, max_steps=BUDGET, swap_interval=INTERVAL,
              m_target=0.6, beta_max=8.0, stop_on_first=stop_on_first)
    want = jt.temper_search(G, JCFG, **kw)
    _replay_jax_swaps(monkeypatch)
    proposals, uniforms = _jax_lane_draws(K, G.n, SEED, BUDGET + 1)
    got = tt.temper_search(TG, CFG, proposals=proposals, uniforms=uniforms,
                           device="cpu", **kw)
    assert want.swap_attempts > 0 and 0 < want.swap_accepts
    assert want.steps_to_target > 0           # a lane passes mid-chunk
    for name in ("s", "mag_reached", "num_steps", "m_final", "t_target",
                 "betas"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    for name in ("swap_attempts", "swap_accepts", "swap_acceptance_rate",
                 "steps_to_target", "target_lane"):
        assert getattr(got, name) == getattr(want, name), name
    assert int(got.pair_attempts.sum()) == got.swap_attempts
    assert int(got.pair_accepts.sum()) == got.swap_accepts


def test_no_swaps_is_the_serial_chain_of_the_same_seeds():
    K, n = 4, TG.n
    betas = np.ones(K)
    ref = tsa.simulated_annealing(TG, CFG, n_replicas=K, seed=3,
                                  a0=betas * CFG.a0_frac * n,
                                  b0=betas * CFG.b0_frac * n, max_steps=1500,
                                  device="cpu")
    got = tt.temper_search(TG, CFG, betas=betas, seed=3, max_steps=1500,
                           swap_moves=False, swap_interval=137, device="cpu")
    np.testing.assert_array_equal(ref.s, got.s)
    np.testing.assert_array_equal(ref.num_steps, got.num_steps)
    np.testing.assert_array_equal(ref.m_final, got.m_final)


def test_equal_betas_accept_every_swap_and_nosync_equals_sync():
    kw = dict(betas=np.ones(4), seed=0, max_steps=600, swap_interval=100,
              device="cpu")
    res = tt.temper_search(TG, CFG, **kw)
    assert res.swap_attempts > 0
    assert res.swap_accepts == res.swap_attempts
    assert res.swap_acceptance_rate == 1.0
    np.testing.assert_array_equal(res.pair_accepts, res.pair_attempts)
    synced = tt.temper_search(TG, CFG, sync_stop=True, **kw)
    for name in ("s", "num_steps", "t_target", "m_final"):
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(synced, name))
    assert synced.swap_accepts == res.swap_accepts


def test_assembly_equals_jax_and_a_chunk_resumes_a_jax_state(monkeypatch):
    """The ladder's initial state equals the reference's field by field;
    from the reference's state the port's chunk (its lane steps and the
    swap round at its end) under the reference's replayed draws gives the
    reference's chunk."""
    betas = jt.ladder_betas(K, 1.0, 8.0)
    nbr, jstate, jargs, jstatic, _, _ = jt._assemble_ladder(
        G, JCFG, betas, SEED, BUDGET, jnp.float32, None, "lane")
    idx, tstate, consts, streams, tstatic, _ = tt._assemble_ladder(
        TG, CFG, betas, SEED, BUDGET, "float32", "cpu")
    for name in ("s", "sum_end", "a", "b", "t", "m_final", "active",
                 "t_target"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    assert tstatic == jstatic
    target_sum = int(np.ceil(0.6 * G.n))
    start = temper_state_from_jax(jstate, seeds=SEED + np.arange(K))
    want = jt._temper_chunk(                     # donates the JAX state
        nbr, jstate, *jargs, swap_interval=INTERVAL, swap_moves=True,
        target_sum=target_sum, stop_on_first=False, **jstatic)
    _replay_jax_swaps(monkeypatch)
    proposals, uniforms = _jax_lane_draws(K, G.n, SEED, BUDGET + 1)
    got = tt._temper_chunk(
        idx, start, consts, SEED, torch.from_numpy(proposals),
        torch.from_numpy(uniforms.astype(np.float32)),
        swap_interval=INTERVAL, swap_moves=True, target_sum=target_sum,
        injected=True, stream_len=BUDGET + 1, **tstatic)
    assert int(want.swap_round) == 1
    for name in ("s", "sum_end", "a", "b", "t", "m_final", "active",
                 "t_target", "chunk_t", "swap_round"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


class _TwoLaneMesh:
    """Rank 0's view of a two-rank lane mesh (no process group: the lane
    split is refused before any collective)."""

    mesh_dim_names = ("lane",)
    shape = (2,)

    def get_local_rank(self, name):
        return 0


def test_validations_and_refusals():
    with pytest.raises(ValueError, match="m_target"):
        tt.temper_search(TG, CFG, n_lanes=2, m_target=0.0, device="cpu")
    with pytest.raises(ValueError, match="swap_interval"):
        tt.temper_search(TG, CFG, n_lanes=2, swap_interval=0, device="cpu")
    with pytest.raises(ValueError, match="n_lanes"):
        tt.ladder_betas(0)
    with pytest.raises(ValueError, match="stop_on_first"):
        tt.temper_search(TG, CFG, n_lanes=2, max_steps=100, sync_stop=False,
                         stop_on_first=True, device="cpu")
    with pytest.raises(ValueError, match="plannable"):
        tt.temper_search(TG, CFG, n_lanes=2, sync_stop=False,
                         max_steps=10**6, swap_interval=10, device="cpu")
    # mesh= runs since the lane shards (tests/test_torch_ensemble_mesh.py);
    # lanes that do not split over the mesh are refused
    with pytest.raises(ValueError, match="do not split"):
        tt.temper_search(TG, CFG, n_lanes=3, mesh=_TwoLaneMesh(),
                         device="cpu")
    with pytest.raises(ValueError, match="checkpoint_path"):
        tt.temper_search(TG, CFG, n_lanes=2, checkpoint_path="x",
                         sync_stop=False, device="cpu")
