"""The port's halo exchange (``graphdyn_torch.parallel.halo``) against the
JAX package's, bit for bit (packed words: no tolerance).

- ``build_halo_tables``: every table equal to the JAX package's, with and
  without hub splitting.
- The shard-layout plain step (the K1/K2′ launch's twin on the CPU), run
  on every shard and followed by the schedule's exchange done on the host,
  equals one step of the JAX ``make_halo_rollout`` on the 8-device CPU
  mesh, row for row (owned, pad, ghost, trash and zero rows).
- ``packed_rollout(partition=)`` at P ∈ {1, 2, 4} on spawned gloo ranks
  (one spawn of 4 ranks for the module; P = 2 runs on a 2 × 2 replica ×
  node mesh), for the four (rule, tie) pairs, on an RRG and an ER graph,
  and on a power-law graph with split hubs: equal to the JAX package's
  ``halo_rollout`` and to the port's unsharded rollout.
- ``python -m graphdyn_torch.scripts.halo_ranks`` on two gloo ranks."""

import numpy as np
import pytest
import torch

from graphdyn import graphs as jg
from graphdyn.ops.packed import packed_rollout as j_packed_rollout
from graphdyn.parallel import halo as jh
from graphdyn.parallel.mesh import device_pool, make_mesh
from graphdyn_torch import graphs as tg
from graphdyn_torch.interop import words_from_numpy, words_to_numpy
from graphdyn_torch.ops.packed import packed_rollout
from graphdyn_torch.parallel import halo as th

import torch_ranks

RULE_TIE = [("majority", "stay"), ("majority", "change"),
            ("minority", "stay"), ("minority", "change")]
GRAPHS = {
    "rrg": ("rrg", 120, 3, 1),
    "er": ("er", 150, 3.0, 2),
    "powerlaw": ("powerlaw", 220, 2.2, 3),
}
STEPS, W = 4, 2


def _jgraph(kind, *a):
    if kind == "rrg":
        return jg.random_regular_graph(a[0], a[1], seed=a[2])
    if kind == "er":
        return jg.erdos_renyi_graph(a[0], a[1] / (a[0] - 1), seed=a[2])
    return jg.powerlaw_graph(a[0], gamma=a[1], dmin=2, seed=a[2])


def _same_tables(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "schedule":
            assert len(x) == len(y)
            for (d1, s1, r1), (d2, s2, r2) in zip(x, y):
                assert d1 == d2
                np.testing.assert_array_equal(s1, s2)
                np.testing.assert_array_equal(r1, r2)
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("hub", [None, 8])
def test_build_halo_tables_match_jax(name, P, hub):
    gargs = GRAPHS[name]
    gj, gt = _jgraph(*gargs), torch_ranks._graph(*gargs)
    pj = jg.partition_graph(gj, P, seed=0, hub_threshold=hub)
    pt = tg.partition_graph(gt, P, seed=0, hub_threshold=hub)
    tj, tt = jh.build_halo_tables(gj, pj), th.build_halo_tables(gt, pt)
    _same_tables(tj, tt)
    assert tt.n_rows == tj.n_rows and tt.zero_row == tj.zero_row
    assert tt.halo_bytes_per_step(16) == tj.halo_bytes_per_step(16)
    assert th.exchange_perms(tt) == jh.exchange_perms(tj)
    sp = np.random.default_rng(P).integers(0, 2**32, size=(gt.n, 3),
                                           dtype=np.uint32)
    np.testing.assert_array_equal(th.scatter_state(tt, sp),
                                  jh.scatter_state(tj, sp))
    np.testing.assert_array_equal(
        th.gather_state(tt, th.scatter_state(tt, sp)), sp)
    s = (2 * np.random.default_rng(5).integers(0, 2, size=(4, gt.n)) - 1
         ).astype(np.int8)
    np.testing.assert_array_equal(th.sa_halo_cols(tt, s),
                                  jh.sa_halo_cols(tj, s))
    np.testing.assert_array_equal(th.sa_halo_uncols(tt, th.sa_halo_cols(tt, s)),
                                  s)


def _host_exchange(tables, shards):
    """The schedule's exchange done on the host: shard p's recv rows take
    shard (p - delta)'s send rows."""
    out = shards.copy()
    P = tables.P
    for delta, send, recv in tables.schedule:
        for p in range(P):
            q = (p - delta) % P
            out[p, recv[p]] = shards[q, send[q]]
    return out


@pytest.mark.parametrize("name", ["rrg", "er"])
@pytest.mark.parametrize("rule,tie", RULE_TIE)
def test_shard_step_plain_matches_jax_shard_step(name, rule, tie):
    gargs = GRAPHS[name]
    gj, gt = _jgraph(*gargs), torch_ranks._graph(*gargs)
    P = 4
    tj = jh.build_halo_tables(gj, jg.partition_graph(gj, P, seed=0))
    tt = th.build_halo_tables(gt, tg.partition_graph(gt, P, seed=0))
    sp = np.random.default_rng(11).integers(0, 2**32, size=(gt.n, W),
                                            dtype=np.uint32)
    prog = jh.HaloProgram(gj, None, steps=1, rule=rule, tie=tie, tables=tj,
                          mesh=make_mesh((P,), ("node",),
                                         devices=device_pool(P)))
    want = np.asarray(prog.advance(prog.place(sp)))
    shards = th.scatter_state(tt, sp)
    stepped = np.stack([
        words_to_numpy(th.shard_step_plain(
            torch.as_tensor(tt.nbr_loc[p]), torch.as_tensor(tt.deg_loc[p]),
            words_from_numpy(shards[p]), n_update=int(tt.counts[p]),
            rule=rule, tie=tie))
        for p in range(P)])
    np.testing.assert_array_equal(_host_exchange(tt, stepped), want)
    # the owned real rows are the unsharded step's words for those nodes
    one = words_to_numpy(packed_rollout(
        torch.as_tensor(gt.nbr, dtype=torch.int32),
        torch.as_tensor(gt.deg, dtype=torch.int32), words_from_numpy(sp), 1,
        rule, tie))
    for p in range(P):
        c = int(tt.counts[p])
        np.testing.assert_array_equal(stepped[p, :c],
                                      one[tt.owned_global[p, :c]])
        assert (stepped[p, tt.zero_row] == 0).all()
        # into a given buffer the step writes the real owned rows alone
        dst = torch.full((tt.n_rows, W), 0x5A5A5A5A, dtype=torch.int32)
        th.shard_step_plain(
            torch.as_tensor(tt.nbr_loc[p]), torch.as_tensor(tt.deg_loc[p]),
            words_from_numpy(shards[p]), dst, n_update=c, rule=rule, tie=tie)
        got = words_to_numpy(dst)
        np.testing.assert_array_equal(got[:c], stepped[p, :c])
        assert (got[c:] == 0x5A5A5A5A).all()


def _cases():
    cases = []
    for name in ("rrg", "er"):
        for P in (1, 2, 4):
            for rule, tie in RULE_TIE:
                cases.append((f"{name}-P{P}-{rule}-{tie}", GRAPHS[name], P,
                              rule, tie, None, STEPS, W, 7))
    for P in (2, 4):
        for rule, tie in (RULE_TIE[0], RULE_TIE[3]):
            cases.append((f"powerlaw-hubs-P{P}-{rule}-{tie}",
                          GRAPHS["powerlaw"], P, rule, tie, 8, STEPS, W, 7))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("halo_ranks"))
    res = torch_ranks.run_ranks("halo_worker", 4, root, CASES)
    for r in res[1:]:                      # every rank holds the result
        assert r.keys() == res[0].keys()
        for k in r:
            np.testing.assert_array_equal(r[k], res[0][k])
    return res[0]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_packed_rollout_partition_matches_jax_and_unsharded(rank_results,
                                                            case):
    key, gargs, P, rule, tie, hub, steps, w, seed = case
    gj, gt = _jgraph(*gargs), torch_ranks._graph(*gargs)
    sp = np.random.default_rng(seed).integers(0, 2**32, size=(gt.n, w),
                                              dtype=np.uint32)
    got = rank_results[key]
    unsharded = words_to_numpy(packed_rollout(
        torch.as_tensor(gt.nbr, dtype=torch.int32),
        torch.as_tensor(gt.deg, dtype=torch.int32), words_from_numpy(sp),
        steps, rule, tie))
    np.testing.assert_array_equal(got, unsharded)
    pj = jg.partition_graph(gj, P, seed=0, hub_threshold=hub)
    want = np.asarray(j_packed_rollout(
        np.asarray(gj.nbr), np.asarray(gj.deg), sp, steps, rule, tie,
        partition=pj))
    np.testing.assert_array_equal(got, want)


def test_halo_ranks_script_on_gloo_ranks(capsys):
    """``python -m graphdyn_torch.scripts.halo_ranks`` on the CPU: spawned
    gloo ranks, the partitioned rollout equal to the unsharded one on every
    rank, one JSON line per (shape, P) and the last line ok."""
    import json

    from graphdyn_torch.scripts import halo_ranks

    assert halo_ranks.main(["--device", "cpu", "--ranks", "2", "--P", "2",
                            "--shapes", "small", "--steps", "2",
                            "--timed", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[-1]["ok"] and lines[-1]["device"] == "cpu"
    (leg,) = [x for x in lines if "equal_on_every_rank" in x]
    assert leg["equal_on_every_rank"] and leg["backend"] == "gloo"
    assert leg["halo_bytes_per_step"] > 0 and len(leg["step_ms"]) == 2
