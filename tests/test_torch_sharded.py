"""The port's gather-mode node sharding (``graphdyn_torch.parallel.sharded``),
``observe.consensus_fraction_psum`` and the word-sharded consensus on
spawned gloo ranks (one spawn per worker for the module):

- the sharded rollout on a 2 × 2 replica × node mesh at n = 256 and n = 253
  (pad rows) equals the JAX package's numpy oracle, and the pad rows stay
  frozen under tie=stay and tie=change (``tests/test_parallel.py:37-57``);
- one sharded SA step returns end sums equal to the rollout of the state
  it returns, leaves the pads untouched and reports no consensus;
- ``consensus_fraction_psum`` equals the fraction over the whole batch;
- ``consensus_curve(mesh=)`` over 4 ranks (word slabs, no per-step
  collective) equals the unsharded curve, row for row, on an ER graph and
  an RRG under two (rule, tie) pairs; the word-count refusal;
- the rank-local block helpers (``shard_batch``, ``replicate``,
  ``shard_stack``), ``device_pool`` and the one-host hybrid mesh."""

import numpy as np
import pytest

from graphdyn.ops.dynamics import run_dynamics
from graphdyn_torch import graphs as tg
from graphdyn_torch.models.consensus import consensus_curve

import torch_ranks


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_ranks"))
    return torch_ranks.run_ranks("sharded_worker", 4, root)


@pytest.fixture(scope="module")
def sharded(sharded_ranks):
    return sharded_ranks[0]


@pytest.mark.parametrize("n", [256, 253])
@pytest.mark.parametrize("tie", ["stay", "change"])
def test_sharded_rollout_matches_oracle_and_freezes_pads(sharded, n, tie):
    g = tg.random_regular_graph(n, 4, seed=0)
    s = sharded[f"s-{n}"]
    out = sharded[f"rollout-{n}-{tie}"]
    for r in range(s.shape[0]):
        want = run_dynamics(g, s[r, :n], 5, tie=tie, backend="cpu")
        np.testing.assert_array_equal(out[r, :n], want)
    np.testing.assert_array_equal(out[:, n:], s[:, n:])


def test_sharded_sa_step_pad_free_sums(sharded):
    st = sharded["step"]
    np.testing.assert_array_equal(st["sum_end_new"], st["want"])
    assert st["consensus"] == 0.0
    np.testing.assert_array_equal(st["s_new"][:, 253:], st["s0"][:, 253:])
    # each replica flipped at most its one proposed spin
    assert ((st["s_new"] != st["s0"]).sum(axis=1) <= 1).all()


def test_consensus_fraction_psum(sharded):
    assert sharded["psum"] == pytest.approx(5 / 8)


def test_mesh_helpers_give_each_rank_its_block(sharded_ranks):
    x = np.arange(16).reshape(8, 2)
    for rank, res in enumerate(sharded_ranks):
        h = res["helpers"]
        rep, node = divmod(rank, 2)        # the 2 x 2 mesh in rank order
        assert h["coords"] == (rep, node)
        np.testing.assert_array_equal(h["shard_batch"], x[4 * rep:4 * rep + 4])
        np.testing.assert_array_equal(h["shard_stack"],
                                      x[4 * node:4 * node + 4])
        np.testing.assert_array_equal(h["replicate"], x)
        assert h["scalar"] == 7
        assert h["hybrid"] == ((1, 4), ("replica", "node"), rank)
        assert h["pool"] == ["cpu"] * 3


CONS_CASES = [
    ("er-maj-stay", ("er", 400, 6.0, 0), 256, [0.0, 0.2, 0.5], 40, 10,
     "majority", "stay"),
    ("rrg-min-change", ("rrg", 300, 4, 1), 128, [0.1, 0.6], 30, 5,
     "minority", "change"),
]


@pytest.fixture(scope="module")
def sharded_consensus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("consensus_ranks"))
    res = torch_ranks.run_ranks("consensus_worker", 4, root, CONS_CASES)
    for r in res[1:]:
        assert r == res[0]             # every rank returns the same rows
    return res[0]


@pytest.mark.parametrize("case", CONS_CASES, ids=[c[0] for c in CONS_CASES])
def test_consensus_curve_mesh_equals_unsharded(sharded_consensus, case):
    key, gargs, R, m0s, max_steps, chunk, rule, tie = case
    g = torch_ranks._graph(*gargs)
    want = consensus_curve(g, R, m0s, max_steps, chunk, rule=rule, tie=tie,
                           device="cpu")
    assert sharded_consensus[key] == want


def test_consensus_mesh_refuses_a_split_word():
    from graphdyn_torch.models.consensus import _word_shard

    class Mesh:                      # a 1-D mesh of 3 ranks, rank 0
        mesh_dim_names = ("replica",)
        shape = (3,)

        def get_local_rank(self, name):
            return 0

    with pytest.raises(ValueError, match="must divide the packed word count"):
        _word_shard(Mesh(), 8, 256)
    assert _word_shard(Mesh(), 9, 288) == ("replica", slice(0, 3))


def test_init_distributed_noop_retry_and_fault_site(monkeypatch):
    import torch.distributed as dist

    from graphdyn_torch.parallel import mesh as pm
    from graphdyn_torch.resilience import faults

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pm.init_distributed(device="cpu") == 1      # one process: no-op
    assert not dist.is_initialized()
    # the rendezvous not up yet: two injected unavailabilities are retried
    # (jittered backoff under the deadline), the third attempt connects
    plan = faults.FaultPlan([faults.FaultSpec("multihost.init", "raise",
                                              count=2)])
    try:
        with plan:
            assert pm.init_distributed(world_size=1, rank=0, device="cpu",
                                       backend="gloo") == 1
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert plan.specs[0].fired == 2
        assert pm.init_distributed(device="cpu") == 1   # idempotent
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # past the deadline the injected failure surfaces
    with faults.FaultPlan([faults.FaultSpec("multihost.init", "raise",
                                            count=99)]):
        with pytest.raises(faults.InjectedUnavailable):
            pm.init_distributed(0.1, world_size=1, rank=0, device="cpu",
                                backend="gloo")
    assert not dist.is_initialized()
