"""The port's out-of-core streamed rollout against the JAX package's, on
the matrix of ``tests/test_stream.py:60-182``: RRG and power-law graphs,
rule × tie, 1 and 3 chunks, budget mode, prefetch depth 0 and 2, live
churn, and the ``stream`` CLI. Every comparison is bit for bit (packed
integer words, no tolerance). The port's chunks step on the CPU here
(``device='cpu'``, the plain version of KB); on the card the chip smoke test
holds the CUDA path to the same words."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import graphdyn.graphs as jg
from graphdyn.ops.packed import pack_spins as jax_pack
from graphdyn.ops.streamed import build_stream_plan as jax_plan
from graphdyn.ops.streamed import seeded_churn as jax_churn
from graphdyn.ops.streamed import streamed_rollout as jax_streamed
import graphdyn_torch.graphs as tg
from graphdyn_torch.interop import stream_plan_from_jax, words_to_numpy
from graphdyn_torch.ops import streamed as ts
from graphdyn_torch.ops.bucketed import (
    bucketed_rollout_global,
    bucketed_state_bytes,
    bucketed_table_entries_bound,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULE_TIES = [("majority", "stay"), ("majority", "change"),
             ("minority", "stay"), ("minority", "change")]


def _graphs(kind, n, seed):
    if kind == "rrg":
        return (jg.random_regular_graph(n, 3, seed=seed),
                tg.random_regular_graph(n, 3, seed=seed))
    return (jg.powerlaw_graph(n, gamma=2.3, dmin=2, seed=seed),
            tg.powerlaw_graph(n, gamma=2.3, dmin=2, seed=seed))


def _sp0(n, R, seed):
    rng = np.random.default_rng(seed)
    s0 = (2 * rng.integers(0, 2, size=(R, n)) - 1).astype(np.int8)
    return np.asarray(jax_pack(s0))


def _port(g, sp, steps, **kw):
    return words_to_numpy(ts.streamed_rollout(g, sp, steps, device="cpu",
                                              **kw))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("rule,tie", RULE_TIES)
@pytest.mark.parametrize("kind", ["rrg", "powerlaw"])
def test_streamed_matches_jax_and_bucketed(kind, rule, tie, K):
    g_j, g_t = _graphs(kind, 80, seed=4)
    sp = _sp0(g_t.n, 32, seed=11)
    want = jax_streamed(g_j, sp, 3, rule=rule, tie=tie, n_chunks=K)
    got = _port(g_t, sp, 3, rule=rule, tie=tie, n_chunks=K)
    np.testing.assert_array_equal(got, want)
    ref_b = bucketed_rollout_global(
        g_t, torch.from_numpy(sp.view(np.int32)), 3, rule, tie)
    np.testing.assert_array_equal(got, words_to_numpy(ref_b))


def test_budget_mode_plan_equals_jax_and_modelled_peak():
    g_j = jg.powerlaw_graph(256, gamma=2.3, dmin=2, seed=7)
    g_t = tg.powerlaw_graph(256, gamma=2.3, dmin=2, seed=7)
    sp = _sp0(g_t.n, 64, seed=3)                 # W = 2
    W = sp.shape[1]
    budget = ts.chunk_device_bytes(g_t.n, g_t.n, g_t.dmax, W) // 3
    plan = ts.build_stream_plan(g_t, W=W, device_budget_bytes=budget)
    plan_j = stream_plan_from_jax(jax_plan(g_j, W=W,
                                           device_budget_bytes=budget))
    assert plan.K == plan_j.K >= 2
    np.testing.assert_array_equal(plan.chunk_of, plan_j.chunk_of)
    for a, b in zip(plan.chunks, plan_j.chunks):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    owned = np.sort(np.concatenate([c.nodes for c in plan.chunks]))
    np.testing.assert_array_equal(owned, np.arange(g_t.n))
    assert ts.plan_device_bytes(plan, W) <= budget
    want = jax_streamed(g_j, sp, 4, device_budget_bytes=budget)
    np.testing.assert_array_equal(_port(g_t, sp, 4, plan=plan), want)
    np.testing.assert_array_equal(
        _port(g_t, sp, 4, device_budget_bytes=budget), want)
    # the byte models: the JAX package's memband formulas
    from graphdyn.obs import memband

    b = tg.degree_buckets(g_t)
    for args in ((g_t.n, W, b.table_entries), (10**5, 32, 1_030_000)):
        assert bucketed_state_bytes(*args) == \
            memband.bucketed_state_bytes(*args)
    assert bucketed_table_entries_bound(256, 700) == \
        memband.bucketed_table_entries_bound(256, 700)
    for C, M, w in ((10, 40, 8), (1, 19_619, 32_768)):
        assert ts.streamed_chunk_bytes(C, M, w, 32) == \
            memband.streamed_chunk_bytes(C, M, w, 32)
    for dmax in (1, 2, 63, 19_617):
        assert ts.streamed_min_bytes(dmax, 32) == \
            memband.streamed_min_bytes(dmax, 32)


def test_prefetch_depth_is_parity_neutral_and_stats_report():
    g_j, g_t = _graphs("powerlaw", 160, seed=9)
    sp = _sp0(g_t.n, 32, seed=1)
    outs, stats = {}, {}
    for depth in (0, 2):
        stats[depth] = {}
        outs[depth] = _port(g_t, sp, 4, n_chunks=4, prefetch_depth=depth,
                            stats_out=stats[depth])
    want_stats = {}
    want = jax_streamed(g_j, sp, 4, n_chunks=4, stats_out=want_stats)
    for depth in (0, 2):
        np.testing.assert_array_equal(outs[depth], want)
        st = stats[depth]
        assert st["steps"] == 4 and st["chunks"] == 4
        for k in ("h2d_bytes", "d2h_bytes", "mutations"):
            assert st[k] == want_stats[k], k
        assert st["h2d_bytes"] > 0 and st["d2h_bytes"] > 0
        assert 0.0 <= st["overlap_frac"] <= 1.0
    assert stats[0]["overlap_frac"] == 0.0      # synchronous: nothing hidden


def test_churn_equals_jax_churned_run():
    for kind, n, K in (("rrg", 64, 3), ("powerlaw", 120, 2)):
        g_j, g_t = _graphs(kind, n, seed=2)
        sp = _sp0(n, 32, seed=5)
        sched_j = jax_churn(n, 6, rate=8.0, seed=13)
        sched_t = ts.seeded_churn(n, 6, rate=8.0, seed=13)
        assert sched_t
        st_j, st_t = {}, {}
        want = jax_streamed(g_j, sp, 6, n_chunks=K, churn=sched_j,
                            stats_out=st_j)
        got = _port(g_t, sp, 6, n_chunks=K, churn=sched_t, stats_out=st_t)
        np.testing.assert_array_equal(got, want)
        assert st_t["mutations"] == st_j["mutations"] > 0


def test_seeded_churn_equals_jax_and_is_pure():
    for args in ((50, 5, 4.0, 3), (4096, 12, 8.0, 0), (10, 3, 0.5, 9)):
        n, steps, rate, seed = args
        a = ts.seeded_churn(n, steps, rate=rate, seed=seed)
        b = ts.seeded_churn(n, steps, rate=rate, seed=seed)
        j = jax_churn(n, steps, rate=rate, seed=seed)
        assert len(a) == len(b) == len(j)
        for x, y, z in zip(a, b, j):
            assert x.step == y.step == z.step
            for f in ("adds", "drops"):
                np.testing.assert_array_equal(getattr(x, f), getattr(z, f))
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_stream_plan_refusals_and_not_ported():
    g = tg.random_regular_graph(32, 3, seed=0)
    with pytest.raises(ValueError, match="exactly one"):
        ts.build_stream_plan(g, W=1)
    with pytest.raises(ValueError, match="exactly one"):
        ts.build_stream_plan(g, W=1, n_chunks=2, device_budget_bytes=10**6)
    with pytest.raises(ValueError, match="n_chunks"):
        ts.build_stream_plan(g, W=1, n_chunks=0)
    with pytest.raises(ValueError, match="n_chunks"):
        ts.build_stream_plan(g, W=1, n_chunks=g.n + 1)
    with pytest.raises(ValueError, match="cannot be streamed"):
        ts.build_stream_plan(g, W=1, device_budget_bytes=64)
    with pytest.raises(NotImplementedError, match="A15"):
        ts.build_stream_plan(g, W=1, n_chunks=2, partition=object())
    sp = np.zeros((g.n, 1), np.uint32)
    with pytest.raises(NotImplementedError, match="A16"):
        ts.streamed_rollout(g, sp, 1, n_chunks=2, checkpoint_path="x",
                            device="cpu")
    with pytest.raises(ValueError, match="int32"):
        ts.streamed_rollout(g, np.zeros((g.n + 1, 1), np.uint32), 1,
                            n_chunks=2, device="cpu")
    got = ts.streamed_rollout(g, sp, 0, n_chunks=2, device="cpu")
    assert got.dtype == torch.int32 and not got.any()


CLI_ARGS = ["stream", "--n", "96", "--gamma", "2.5", "--steps", "4",
            "--replicas", "40", "--chunks", "3", "--churn-rate", "4.0",
            "--churn-seed", "2", "--seed", "3"]


def test_stream_cli_keys_and_npz_equal_jax_cli(tmp_path, capsys):
    from graphdyn.cli import main as jax_main

    assert jax_main(CLI_ARGS + ["--out", str(tmp_path / "j")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "graphdyn_torch", *CLI_ARGS, "--device", "cpu",
         "--out", str(tmp_path / "t")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(got) == list(want)
    for k in ("solver", "n", "steps", "shards", "chunks", "h2d_bytes",
              "d2h_bytes", "mutations", "repartitions", "m_end_mean"):
        assert got[k] == want[k], k
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(a.files) == sorted(b.files) == ["conf", "m_end"]
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("extra,item", [
    (["--shards", "2"], "A15"), (["--hub-threshold", "5"], "A15"),
    (["--checkpoint", "x"], "A16")])
def test_stream_cli_refusals_name_the_roadmap_item(extra, item):
    from graphdyn_torch.cli import main

    with pytest.raises(SystemExit, match=item):
        main(["stream", "--n", "40", "--steps", "1", "--device", "cpu",
              *extra])
