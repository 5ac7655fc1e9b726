"""The port's sharded out-of-core stream (``graphdyn_torch.parallel.
stream``) against the JAX package's, bit for bit (packed words and integer
stats: no tolerance), after ``tests/test_stream_shard.py``.

- The shard plan: every array equal to the JAX package's, part-major
  ownership, budget mode per shard; ``build_stream_plan(partition=)``.
- ``sharded_streamed_rollout`` at P ∈ {1, 2, 4} on spawned gloo ranks (one
  spawn of 4 ranks for the module; P < 4 runs on a replica × node mesh),
  for the four (rule, tie) pairs, on an RRG and on a power-law graph with
  split hubs: equal to the JAX package's streamed engines and to the
  port's single-device ``streamed_rollout``.
- Churn with live repartition (promotion and demotion), and none without a
  threshold; the stats equal the JAX engine's.
- A run preempted at one shard count and requeued at another, and one
  resumed on the single-device stream, equal to the uninterrupted run;
  the journal carries ``stream.churn`` and ``stream.repartition``.
- Stats and the per-shard overlap gauges; the refusals.
- ``sa_sharded(layout='streamed')``: the chain of the JAX package's
  ``simulated_annealing`` under injected streams; its refusals."""

import json

import numpy as np
import pytest

from graphdyn import graphs as jg
from graphdyn.ops.streamed import ChurnBatch as JChurnBatch
from graphdyn.ops.streamed import streamed_rollout as j_streamed
from graphdyn.parallel import stream as js
from graphdyn_torch import graphs as tg
from graphdyn_torch.interop import words_to_numpy
from graphdyn_torch.ops.streamed import build_stream_plan, streamed_rollout
from graphdyn_torch.parallel import stream as ts

import torch_ranks
from torch_ranks import STREAM_THR as THR

RULE_TIE = [("majority", "stay"), ("majority", "change"),
            ("minority", "stay"), ("minority", "change")]
STEPS = 3


def _jgraph(kind, n=200, seed=5):
    if kind == "rrg":
        return jg.random_regular_graph(n, 3, seed=seed)
    return jg.powerlaw_graph(n, gamma=2.3, dmin=2, seed=seed)


def _j_churn(churn):
    return [JChurnBatch(step=b.step, adds=b.adds, drops=b.drops)
            for b in churn]


def _roll_cases():
    cases = []
    for P in (1, 2, 4):
        for rule, tie in RULE_TIE:
            for kind in ("rrg", "powerlaw"):
                cases.append(dict(
                    key=f"roll-{P}-{rule}-{tie}-{kind}", what="roll",
                    kind=kind, P=P, rule=rule, tie=tie, steps=STEPS,
                    n_chunks=3, seed=11,
                    hub=THR if kind == "powerlaw" else None))
    cases += [
        dict(key="budget", what="roll", kind="powerlaw", n=300, P=2,
             steps=2, budget=8_000, hub=THR, partition=True, seed=1, R=64),
        dict(key="churn-2", what="roll", kind="powerlaw", P=2, steps=5,
             n_chunks=3, hub=THR, churn="repart", seed=2),
        dict(key="churn-4", what="roll", kind="powerlaw", P=4, steps=5,
             n_chunks=3, hub=THR, churn="repart", seed=2),
        dict(key="churn-nothr", what="roll", kind="rrg", P=2, steps=4,
             n_chunks=3, churn="random", seed=2),
        dict(key="stats", what="roll", kind="rrg", P=2, steps=2,
             n_chunks=3, seed=1, record=True),
        dict(key="requeue-2-4", what="requeue", kind="powerlaw", steps=5,
             n_chunks=3, hub=THR, churn="repart", seed=2,
             legs=[(2, 4), (4, None)]),
        dict(key="requeue-4-2", what="requeue", kind="powerlaw", steps=5,
             n_chunks=3, hub=THR, churn="repart", seed=2,
             legs=[(4, 3), (2, None)]),
        dict(key="requeue-1dev", what="requeue", kind="rrg", steps=6,
             n_chunks=3, seed=6, legs=[(2, 5)]),
        dict(key="sa", what="sa", P=2),
        dict(key="sa-hub", what="sa", P=4, hub=4),
    ]
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stream_shard"))
    res = torch_ranks.run_ranks("stream_shard_worker", 4, root,
                                _roll_cases(), root)
    return res, root


@pytest.fixture
def one_world():
    """The one-process world a mesh makes in this process, torn down after
    the test (a later test in this worker expects none)."""
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _same_on_every_rank(res, key):
    first = res[0][key]
    for r in res[1:]:
        got = r[key]
        if isinstance(first, dict) and "words" in first:
            np.testing.assert_array_equal(got["words"], first["words"])
    return first


# ---------------------------------------------------------------------------
# the plan (host numpy)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,P,hub,nc,budget", [
    ("powerlaw", 2, None, 3, None), ("powerlaw", 3, THR, 2, None),
    ("powerlaw", 4, THR, None, 8_000), ("rrg", 4, None, 3, None)])
def test_shard_plan_matches_jax(kind, P, hub, nc, budget):
    n = 300 if kind == "powerlaw" else 200
    gj, gt = _jgraph(kind, n), torch_ranks.stream_graph(kind, n)
    pj = jg.partition_graph(gj, P, seed=0, hub_threshold=hub)
    pt = tg.partition_graph(gt, P, seed=0, hub_threshold=hub)
    a = js.build_shard_stream_plan(gj, W=2, partition=pj, n_chunks=nc,
                                   device_budget_bytes=budget)
    b = build_stream_plan(gt, W=2, partition=pt, n_chunks=nc,
                          device_budget_bytes=budget)
    assert isinstance(b, ts.ShardStreamPlan)
    assert (a.n, a.P, a.K) == (b.n, b.P, b.K)
    for ca, cb in zip(a.shard_chunks, b.shard_chunks):
        assert len(ca) == len(cb)
        for x, y in zip(ca, cb):
            for f in x._fields:
                u, v = getattr(x, f), getattr(y, f)
                assert u.dtype == v.dtype, f
                np.testing.assert_array_equal(u, v, err_msg=f)
    assert ts.shard_plan_device_bytes(b, 2) == js.shard_plan_device_bytes(
        a, 2)
    for f in a.tables._fields:                  # the halo tables too
        x, y = getattr(a.tables, f), getattr(b.tables, f)
        if f == "schedule":
            for (d1, s1, r1), (d2, s2, r2) in zip(x, y):
                assert d1 == d2
                np.testing.assert_array_equal(s1, s2)
                np.testing.assert_array_equal(r1, r2)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


def test_shard_plan_part_major_and_budget_per_shard():
    g = torch_ranks.stream_graph("powerlaw", n=300)
    part = tg.partition_graph(g, 4, seed=0, hub_threshold=THR)
    plan = build_stream_plan(g, W=2, n_chunks=3, partition=part)
    assert plan.P == 4 and plan.K >= 4
    hubs = set(part.hubs.tolist())
    seen = []
    for p, chunks in enumerate(plan.shard_chunks):
        owned = set(part.order[part.offsets[p]:part.offsets[p + 1]].tolist())
        mine = np.concatenate([c.nodes for c in chunks])
        assert set(mine.tolist()) == owned
        assert not hubs.intersection(mine.tolist())
        seen.append(mine)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.sort(part.order))
    part2 = tg.partition_graph(g, 2, seed=0, hub_threshold=THR)
    tight = ts.build_shard_stream_plan(g, W=2, partition=part2,
                                       device_budget_bytes=8_000)
    assert all(len(cs) >= 2 for cs in tight.shard_chunks)
    assert ts.shard_plan_device_bytes(tight, 2) <= 8_000


# ---------------------------------------------------------------------------
# the rollout on spawned ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rrg", "powerlaw"])
@pytest.mark.parametrize("rule,tie", RULE_TIE)
def test_sharded_streamed_matches_jax_and_port(ranks, rule, tie, kind):
    res, _ = ranks
    gt = torch_ranks.stream_graph(kind)
    sp = torch_ranks.stream_sp0(gt.n, 32, 11)
    ref_j = np.asarray(j_streamed(_jgraph(kind), sp, STEPS, rule=rule,
                                  tie=tie, n_chunks=3))
    ref_t = words_to_numpy(streamed_rollout(gt, sp, STEPS, rule=rule,
                                            tie=tie, n_chunks=3,
                                            device="cpu"))
    np.testing.assert_array_equal(ref_t, ref_j)
    for P in (1, 2, 4):
        got = _same_on_every_rank(res, f"roll-{P}-{rule}-{tie}-{kind}")
        np.testing.assert_array_equal(got["words"], ref_j, err_msg=str(P))


@pytest.mark.parametrize("P,kind", [(2, "powerlaw"), (4, "rrg")])
def test_sharded_streamed_equals_jax_sharded_engine(ranks, P, kind):
    res, _ = ranks
    gj = _jgraph(kind)
    sp = torch_ranks.stream_sp0(gj.n, 32, 11)
    stats_j = {}
    ref = js.sharded_streamed_rollout(
        gj, sp, STEPS, n_shards=P, n_chunks=3,
        hub_threshold=THR if kind == "powerlaw" else None,
        stats_out=stats_j)
    got = _same_on_every_rank(res, f"roll-{P}-majority-stay-{kind}")
    np.testing.assert_array_equal(got["words"], np.asarray(ref))
    for k in ("h2d_bytes", "d2h_bytes", "mutations", "repartitions",
              "chunks_rebuilt", "steps", "chunks", "shards"):
        assert got["stats"][k] == stats_j[k], k


def test_budget_mode_rollout(ranks):
    res, _ = ranks
    g = torch_ranks.stream_graph("powerlaw", n=300)
    sp = torch_ranks.stream_sp0(g.n, 64, 1)
    ref = words_to_numpy(streamed_rollout(g, sp, 2, n_chunks=2,
                                          device="cpu"))
    got = _same_on_every_rank(res, "budget")
    np.testing.assert_array_equal(got["words"], ref)


@pytest.mark.parametrize("P", [2, 4])
def test_churn_repartition_bit_exact(ranks, P):
    res, _ = ranks
    gt = torch_ranks.stream_graph("powerlaw")
    sp = torch_ranks.stream_sp0(gt.n, 32, 2)
    churn = torch_ranks.stream_churn(gt)
    ref_t = words_to_numpy(streamed_rollout(gt, sp, 5, n_chunks=3,
                                            churn=churn, device="cpu"))
    stats_j = {}
    ref_j = js.sharded_streamed_rollout(
        _jgraph("powerlaw"), sp, 5, n_shards=P, n_chunks=3,
        hub_threshold=THR, churn=_j_churn(churn), stats_out=stats_j)
    np.testing.assert_array_equal(ref_t, np.asarray(ref_j))
    got = _same_on_every_rank(res, f"churn-{P}")
    np.testing.assert_array_equal(got["words"], ref_t)
    st = got["stats"]
    assert st["repartitions"] >= 2 and st["mutations"] > 0
    assert st["chunks_rebuilt"] >= st["chunks"]
    for k in ("mutations", "repartitions", "chunks_rebuilt", "chunks",
              "h2d_bytes", "d2h_bytes"):
        assert st[k] == stats_j[k], k


def test_churn_without_threshold_never_repartitions(ranks):
    res, _ = ranks
    g = torch_ranks.stream_graph("rrg")
    sp = torch_ranks.stream_sp0(g.n, 32, 2)
    from graphdyn_torch.ops.streamed import seeded_churn

    ref = words_to_numpy(streamed_rollout(
        g, sp, 4, n_chunks=3, churn=seeded_churn(g.n, 4, rate=6.0, seed=9),
        device="cpu"))
    got = _same_on_every_rank(res, "churn-nothr")
    np.testing.assert_array_equal(got["words"], ref)
    assert got["stats"]["repartitions"] == 0
    assert got["stats"]["mutations"] > 0


@pytest.mark.parametrize("key", ["requeue-2-4", "requeue-4-2"])
def test_requeue_across_shard_count_bit_exact(ranks, key):
    from graphdyn_torch.resilience.store import validate_journal

    res, _ = ranks
    gt = torch_ranks.stream_graph("powerlaw")
    sp = torch_ranks.stream_sp0(gt.n, 32, 2)
    ref = words_to_numpy(streamed_rollout(
        gt, sp, 5, n_chunks=3, churn=torch_ranks.stream_churn(gt),
        device="cpu"))
    for r in res:
        legs = r[key]["legs"]
        assert [s for s, _ in legs] == ["preempted", "done"]
        np.testing.assert_array_equal(legs[1][1], ref)
    ops = res[0][key]["ops"]
    assert "stream.churn" in ops and "stream.repartition" in ops
    jp = res[0][key]["ckpt"].rsplit("/", 1)[0] + "/run_journal.jsonl"
    _, problems = validate_journal(jp)
    assert problems == []


def test_resume_onto_streamed_single_device(ranks):
    res, _ = ranks
    g = torch_ranks.stream_graph("rrg")
    sp = torch_ranks.stream_sp0(g.n, 32, 6)
    ref = words_to_numpy(streamed_rollout(g, sp, 6, n_chunks=3,
                                          device="cpu"))
    assert [s for s, _ in res[0]["requeue-1dev"]["legs"]] == ["preempted"]
    got = streamed_rollout(g, sp, 6, n_chunks=3, device="cpu",
                           checkpoint_path=res[0]["requeue-1dev"]["ckpt"])
    np.testing.assert_array_equal(words_to_numpy(got), ref)


def test_stats_and_per_shard_overlap(ranks):
    res, _ = ranks
    for rank, r in enumerate(res):
        st = r["stats"]["stats"]
        assert st["shards"] == 2 and st["steps"] == 2 and st["chunks"] == 6
        assert len(st["per_shard_overlap"]) == 2
        assert st["h2d_bytes"] > 0 and st["d2h_bytes"] > 0
        names = r["stats"]["gauges"]
        node = rank % 2        # the node coordinate on the 2 x 2 mesh
        assert ("stream.overlap_util", node) in names
        for n in ("stream.h2d_bytes", "stream.d2h_bytes",
                  "stream.exchange_bytes"):
            assert n in {a for a, _ in names}


# ---------------------------------------------------------------------------
# refusals (one process)
# ---------------------------------------------------------------------------


def test_driver_refusals(one_world):
    from graphdyn_torch.parallel.mesh import make_mesh

    g = torch_ranks.stream_graph("rrg", n=40)
    sp = torch_ranks.stream_sp0(g.n, 32, 1)
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        ts.sharded_streamed_rollout(g, sp, 1, n_shards=0, n_chunks=2, **kw)
    with pytest.raises(ValueError, match="sp must be"):
        ts.sharded_streamed_rollout(g, sp[:-1], 1, n_shards=2, n_chunks=2,
                                    **kw)
    part = tg.partition_graph(g, 2, seed=0)
    with pytest.raises(ValueError, match="P=2"):
        ts.sharded_streamed_rollout(g, sp, 1, n_shards=4, n_chunks=2,
                                    partition=part, **kw)
    mesh = make_mesh((1,), ("node",), device="cpu")
    with pytest.raises(ValueError, match="axis size 1 != n_shards 2"):
        ts.sharded_streamed_rollout(g, sp, 1, n_shards=2, n_chunks=2,
                                    mesh=mesh, **kw)
    with pytest.raises(ValueError, match="exactly one of"):
        ts.sharded_streamed_rollout(g, sp, 1, n_shards=1, mesh=mesh, **kw)


def test_exchange_requires_something_to_exchange(one_world):
    from graphdyn_torch.parallel.halo import build_halo_tables
    from graphdyn_torch.parallel.mesh import make_mesh

    g = torch_ranks.stream_graph("rrg", n=40)
    tables = build_halo_tables(g, tg.partition_graph(g, 1, seed=0))
    mesh = make_mesh((1,), ("node",), device="cpu")
    with pytest.raises(ValueError, match="nothing to exchange"):
        ts.make_stream_exchange(mesh, tables, device="cpu")


# ---------------------------------------------------------------------------
# sa_sharded(layout='streamed')
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["sa", "sa-hub"])
def test_sa_sharded_streamed_bit_parity(ranks, key):
    from graphdyn.config import SAConfig
    from graphdyn.models.sa import simulated_annealing

    res, _ = ranks
    g = jg.random_regular_graph(40, 3, seed=5)
    rng = np.random.default_rng(6)
    R, L = 4, 2000
    s0 = (2 * rng.integers(0, 2, size=(R, g.n)) - 1).astype(np.int8)
    proposals = rng.integers(0, g.n, size=(R, L)).astype(np.int32)
    uniforms = rng.random(size=(R, L))
    ref = simulated_annealing(g, SAConfig(), s0=s0, proposals=proposals,
                              uniforms=uniforms, max_steps=30)
    for r in res:
        got = r[key]
        np.testing.assert_array_equal(got["s"], ref.s)
        np.testing.assert_array_equal(got["num_steps"], ref.num_steps)
        np.testing.assert_array_equal(got["m_final"], ref.m_final)


def test_sa_sharded_streamed_refusals(tmp_path, one_world):
    from graphdyn_torch.config import SAConfig
    from graphdyn_torch.parallel.mesh import make_mesh
    from graphdyn_torch.parallel.sa_sharded import sa_sharded

    g = tg.random_regular_graph(40, 3, seed=5)
    mesh = make_mesh((1, 1), ("replica", "node"), device="cpu")
    kw = dict(mesh=mesh, n_replicas=2, seed=0, max_steps=5, device="cpu")
    with pytest.raises(ValueError, match="layout must be"):
        sa_sharded(g, SAConfig(), layout="bucketed", **kw)
    with pytest.raises(ValueError, match="chunked-chain resume"):
        sa_sharded(g, SAConfig(), layout="streamed",
                   checkpoint_path=str(tmp_path / "x.ckpt"), **kw)
    with pytest.raises(ValueError, match="rollout_mode='full'"):
        sa_sharded(g, SAConfig(), layout="streamed",
                   rollout_mode="lightcone", **kw)
    with pytest.raises(ValueError, match="halo composition"):
        sa_sharded(g, SAConfig(), layout="streamed", node_mode="halo", **kw)
    with pytest.raises(ValueError, match="partition has P=2"):
        sa_sharded(g, SAConfig(), layout="streamed",
                   partition=tg.partition_graph(g, 2, seed=0), **kw)


def test_journal_ops_are_json(ranks):
    """The journal the sharded runs wrote is the JAX package's schema: one
    JSON object a line."""
    res, _ = ranks
    jp = res[0]["requeue-2-4"]["ckpt"].rsplit("/", 1)[0]
    with open(jp + "/run_journal.jsonl") as f:
        for line in f:
            assert isinstance(json.loads(line), dict)
