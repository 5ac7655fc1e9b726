"""Exact resume across the port, and the checkpoint formats it shares with
the JAX package.

- Every resumable driver, preempted (once or twice) and resumed, equals
  the same run left alone, bit for bit on the CPU: the SA chain and
  ``sa_ensemble`` (serial and grouped, across group sizes), tempering,
  HPr (chain, batch, ensemble; float32 and float64), the entropy ladders
  (sweep, grid serial and grouped, congruent ensemble, union), the streamed
  rollout with churn, and the graceful exits of ``fused`` and
  ``chromatic``.
- Resumed port runs equal the JAX package's uninterrupted runs under the
  repo's parity rules: the injected-stream SA chain and the streamed
  rollout bit for bit, float64 HPr and the float64 entropy grid within the
  present tolerances.
- The store's files are shared: ``run_fingerprint`` gives one hex, each
  package verifies the other's manifests and validates the other's
  journals, a JAX-package streamed snapshot (no RNG state) resumes in the
  port, and a JAX-package snapshot whose RNG state means something else
  here is refused with ``ValueError``.
- ``run-supervised`` restarts a crashed run to the uninterrupted result and
  quarantines a crash loop (exit 86); a real SIGTERM exits 75.
"""

import contextlib
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn import resilience as jres
from graphdyn.config import DynamicsConfig as JDyn
from graphdyn.config import EntropyConfig as JEnt
from graphdyn.config import HPRConfig as JHPR
from graphdyn.config import SAConfig as JSA
from graphdyn.models import entropy as jem
from graphdyn.models import hpr as jh
from graphdyn.models import sa as jsa
from graphdyn.ops import streamed as jst
from graphdyn.resilience import store as jstore
from graphdyn.search import tempering as jtemp
from graphdyn.utils import io as jio
from graphdyn_torch import interop
from graphdyn_torch import resilience as tres
from graphdyn_torch.config import DynamicsConfig, EntropyConfig, HPRConfig
from graphdyn_torch.config import SAConfig
from graphdyn_torch.graphs import erdos_renyi_graph
from graphdyn_torch.graphs import random_regular_graph
from graphdyn_torch.models import entropy as tem
from graphdyn_torch.models import hpr as th
from graphdyn_torch.models import sa as tsa
from graphdyn_torch.ops import streamed as tss
from graphdyn_torch.ops.packed import pack_spins
from graphdyn_torch.resilience import store as tstore
from graphdyn_torch.resilience import supervisor as tsup
from graphdyn_torch.search import chromatic as tsc
from graphdyn_torch.search import fused as tsf
from graphdyn_torch.search import tempering as ttemp
from graphdyn_torch.utils import io as tio

pytestmark = pytest.mark.faultinject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DYN11 = DynamicsConfig(p=1, c=1)


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


def _tg(g):
    return interop.graph_from_arrays(g.nbr, g.deg, g.edges)


def _preempt(site, at, fn, *, plan=tres.FaultPlan, spec=tres.FaultSpec,
             exc=tres.InjectedPreemption):
    """Run ``fn`` under a plan that preempts at the ``at``-th hit of
    ``site``; the preemption must fire."""
    with plan([spec(site, "preempt", at=at)]):
        with pytest.raises(exc):
            fn()


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def jax_stream(seed: int, n: int, sweeps: int, dtype) -> np.ndarray:
    """The reference HPr chain's uniforms ``[sweeps, n]`` (the helper of
    tests/test_torch_hpr.py)."""
    def body(k, _):
        ks = jax.random.split(k)
        return ks[0], jax.random.uniform(ks[1], (n,), dtype)

    run = jax.jit(lambda key: jax.lax.scan(body, key, None, length=sweeps)[1])
    return np.asarray(run(jax.random.PRNGKey(np.uint32(seed))))


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


# ---------------------------------------------------------------------------
# the shared formats
# ---------------------------------------------------------------------------


def test_run_fingerprint_same_hex_in_both_packages():
    parts = (np.arange(12, dtype=np.int32).reshape(3, 4),
             np.ones((2, 5), np.int8), np.float64(0.25), "majority", 7,
             None, (1, 2), np.zeros(0))
    assert tio.run_fingerprint(*parts) == jio.run_fingerprint(*parts)
    assert tio.run_fingerprint(*parts[:-1]) != tio.run_fingerprint(*parts)


@pytest.mark.parametrize("writer,reader", [(jstore, tstore), (tstore, jstore)],
                         ids=["jax-to-port", "port-to-jax"])
def test_manifests_and_journals_cross_accept(tmp_path, writer, reader):
    """One package writes three versions (keep 2); the other loads the
    snapshot verified, verifies every retained manifest and validates the
    journal, which then holds both packages' events."""
    path = str(tmp_path / "ck")
    ck = writer.DurableCheckpoint(path, keep=2)
    for i in range(3):
        ck.save({"s": np.arange(8, dtype=np.int8) + i,
                 "chi": np.full((2, 4, 4), 0.5 + i)}, {"kind": "x", "t": i})
    arrays, meta = reader.DurableCheckpoint(path, keep=2).load()
    assert meta == {"kind": "x", "t": 2}
    np.testing.assert_array_equal(arrays["s"], np.arange(8) + 2)
    for v in (2, 3):
        f = f"{path}.v{v}"
        a, m = reader.DurableCheckpoint(path)._read_npz(f + ".npz")
        reader.verify_manifest(a, m, reader._read_manifest(f + ".manifest.json"))
    jpath = writer.journal_path_for(path)
    events, problems = reader.validate_journal(jpath)
    assert problems == []
    loads = [e for e in events if e.get("op") == "load"]
    assert loads and loads[-1]["verified"] is True
    _, problems = writer.validate_journal(jpath)
    assert problems == []


def _jax_chain_snapshot(tmp_path, g, jcfg):
    ck = str(tmp_path / "ck")
    _preempt("chunk.boundary", 2, lambda: jsa.simulated_annealing(
        g, jcfg, n_replicas=2, seed=1, max_steps=3000, backend="jax",
        checkpoint_path=ck, chunk_steps=50, checkpoint_interval_s=0.0),
        plan=jres.FaultPlan, spec=jres.FaultSpec, exc=jres.InjectedPreemption)
    assert os.path.exists(ck + ".npz")
    return ck


def test_jax_sa_chain_snapshot_refused(tmp_path):
    g = jg.random_regular_graph(40, 3, seed=0)
    ck = _jax_chain_snapshot(tmp_path, g, JSA(dynamics=JDyn(p=1, c=1)))
    with pytest.raises(ValueError, match="refusing to resume"):
        tsa.simulated_annealing(_tg(g), SAConfig(dynamics=DYN11),
                                n_replicas=2, seed=1, max_steps=3000,
                                checkpoint_path=ck, chunk_steps=50,
                                device=CPU)


def test_jax_ensemble_and_ladder_snapshots_refused(tmp_path):
    """The JAX package's sa_ensemble and hpr_solve snapshots (their chains
    draw from jax.random) and its temper ladder are refused by identity."""
    jcfg = JSA(dynamics=JDyn(p=1, c=1))
    ck = str(tmp_path / "sa")
    _preempt("rep.boundary", 1, lambda: jsa.sa_ensemble(
        40, 3, jcfg, n_stat=2, seed=0, max_steps=2000, backend="jax",
        group_size=0, checkpoint_path=ck, checkpoint_interval_s=0.0),
        plan=jres.FaultPlan, spec=jres.FaultSpec, exc=jres.InjectedPreemption)
    with pytest.raises(ValueError, match="different run"):
        tsa.sa_ensemble(40, 3, SAConfig(dynamics=DYN11), n_stat=2, seed=0,
                        max_steps=2000, group_size=0, checkpoint_path=ck,
                        device=CPU)
    g = jg.random_regular_graph(30, 3, seed=1)
    ck = str(tmp_path / "hpr")
    _preempt("chunk.boundary", 2, lambda: jh.hpr_solve(
        g, JHPR(max_sweeps=300), seed=0, kernel="xla", checkpoint_path=ck,
        chunk_sweeps=5, checkpoint_interval_s=0.0),
        plan=jres.FaultPlan, spec=jres.FaultSpec, exc=jres.InjectedPreemption)
    with pytest.raises(ValueError, match="refusing to resume"):
        th.hpr_solve(_tg(g), HPRConfig(max_sweeps=300), seed=0,
                     checkpoint_path=ck, chunk_sweeps=5, device=CPU)
    ck = str(tmp_path / "temper")
    _preempt("chunk.boundary", 2, lambda: jtemp.temper_search(
        g, jcfg, n_lanes=2, max_steps=600, swap_interval=100,
        checkpoint_path=ck, checkpoint_interval_s=0.0),
        plan=jres.FaultPlan, spec=jres.FaultSpec, exc=jres.InjectedPreemption)
    with pytest.raises(ValueError, match="refusing to resume"):
        ttemp.temper_search(_tg(g), SAConfig(dynamics=DYN11), n_lanes=2,
                            max_steps=600, swap_interval=100,
                            checkpoint_path=ck, device=CPU)


def test_port_snapshot_of_another_run_refused(tmp_path):
    g = random_regular_graph(40, 3, seed=0)
    cfg = SAConfig(dynamics=DYN11)
    ck = str(tmp_path / "ck")
    _preempt("chunk.boundary", 2, lambda: tsa.simulated_annealing(
        g, cfg, n_replicas=2, seed=1, max_steps=3000, checkpoint_path=ck,
        chunk_steps=50, checkpoint_interval_s=0.0, device=CPU))
    for kw in (dict(seed=2), dict(max_steps=2000), dict(dtype="float64")):
        args = dict(n_replicas=2, seed=1, max_steps=3000, checkpoint_path=ck,
                    chunk_steps=50, device=CPU)
        args.update(kw)
        with pytest.raises(ValueError, match="refusing to resume"):
            tsa.simulated_annealing(g, cfg, **args)


# ---------------------------------------------------------------------------
# resumed port runs against the JAX package's uninterrupted runs
# ---------------------------------------------------------------------------


def test_resumed_injected_sa_chain_equals_jax(tmp_path):
    g = jg.erdos_renyi_graph(60, 3.0 / 60, seed=3)
    rng = np.random.default_rng(4)
    L = 900
    kw = dict(s0=(2 * rng.integers(0, 2, (3, g.n)) - 1).astype(np.int8),
              proposals=rng.integers(0, g.n, (3, L)).astype(np.int32),
              uniforms=rng.random((3, L)), max_steps=800)
    want = jsa.simulated_annealing(g, JSA(dynamics=JDyn(p=2, c=1)),
                                   backend="jax", **kw)
    cfg = SAConfig(dynamics=DynamicsConfig(p=2, c=1))
    ckw = dict(checkpoint_path=str(tmp_path / "ck"), chunk_steps=64,
               checkpoint_interval_s=0.0, device=CPU)
    for at in (3, 2):                     # preempted twice, then resumed
        _preempt("chunk.boundary", at, lambda: tsa.simulated_annealing(
            _tg(g), cfg, **kw, **ckw))
    got = tsa.simulated_annealing(_tg(g), cfg, **kw, **ckw)
    _equal((got.s, got.num_steps, got.m_final),
           (want.s, want.num_steps, want.m_final))
    np.testing.assert_allclose(got.mag_reached, want.mag_reached, atol=1e-6)


def test_resumed_streamed_rollout_with_churn_equals_jax(tmp_path):
    g = jg.powerlaw_graph(150, gamma=2.3, dmin=2, seed=3)
    s0 = (2 * np.random.default_rng(0).integers(0, 2, (40, g.n)) - 1
          ).astype(np.int8)
    sp = pack_spins(s0)
    churn = tss.seeded_churn(g.n, 7, rate=4.0, seed=5)
    jchurn = jst.seeded_churn(g.n, 7, rate=4.0, seed=5)
    want = jst.streamed_rollout(g, interop.words_to_numpy(sp), 7, n_chunks=3,
                                churn=jchurn)
    ckw = dict(n_chunks=3, churn=churn, checkpoint_interval_s=0.0,
               device=CPU, checkpoint_path=str(tmp_path / "port" / "ck"))
    for at in (2, 3):
        _preempt("chunk.boundary", at,
                 lambda: tss.streamed_rollout(_tg(g), sp, 7, **ckw))
    got = tss.streamed_rollout(_tg(g), sp, 7, **ckw)
    np.testing.assert_array_equal(interop.words_to_numpy(got), want)
    # a JAX-package snapshot carries no RNG state: the port resumes it,
    # churn replayed from the JAX package's journal
    jck = str(tmp_path / "jax" / "ck")
    _preempt("chunk.boundary", 4, lambda: jst.streamed_rollout(
        g, interop.words_to_numpy(sp), 7, n_chunks=3, churn=jchurn,
        checkpoint_path=jck, checkpoint_interval_s=0.0),
        plan=jres.FaultPlan, spec=jres.FaultSpec, exc=jres.InjectedPreemption)
    got = tss.streamed_rollout(_tg(g), sp, 7, n_chunks=3, churn=churn,
                               checkpoint_path=jck, device=CPU)
    np.testing.assert_array_equal(interop.words_to_numpy(got), want)
    _, problems = jstore.validate_journal(jstore.journal_path_for(jck))
    assert problems == []


def test_resumed_f64_hpr_chain_equals_jax(tmp_path):
    """float64 HPr under the reference's uniforms: the resumed port chain
    equals the JAX package's uninterrupted one (the chain case of
    tests/test_torch_hpr.py that agrees exactly)."""
    TT = 3000
    g = jg.random_regular_graph(60, 4, seed=1)
    with x64():
        want = jh.hpr_solve(g, JHPR(dtype="float64", max_sweeps=TT), seed=0,
                            kernel="xla")
        U = jax_stream(0, g.n, TT + 2, jnp.float64)
    cfg = HPRConfig(dtype="float64", max_sweeps=TT)
    ckw = dict(checkpoint_path=str(tmp_path / "ck"), chunk_sweeps=7,
               checkpoint_interval_s=0.0, uniforms=lambda t: U[t][None],
               device=CPU)
    _preempt("chunk.boundary", 3,
             lambda: th.hpr_solve(_tg(g), cfg, seed=0, **ckw))
    got = th.hpr_solve(_tg(g), cfg, seed=0, **ckw)
    assert got.num_steps > 21
    np.testing.assert_array_equal(got.s, want.s)
    assert (got.num_steps, got.m_final) == (want.num_steps, want.m_final)


def test_resumed_f64_entropy_grid_holds_to_jax(tmp_path):
    """float64 entropy grid, grouped, preempted at a λ boundary and
    resumed: the JAX package's uninterrupted grid within its float64
    bound, and every visited λ the same."""
    jcfg = JEnt(dynamics=JDyn(p=1, c=1), lmbd_max=0.4, lmbd_step=0.2,
                max_sweeps=300, num_rep=2, dtype="float64")
    deg = np.array([1.5])
    with x64():
        want = jem.entropy_grid(60, deg, jcfg, seed=3, kernel="xla")
    cfg = EntropyConfig(dynamics=DYN11, lmbd_max=0.4, lmbd_step=0.2,
                        max_sweeps=300, num_rep=2, dtype="float64")
    ckw = dict(seed=3, checkpoint_path=str(tmp_path / "ck"),
               checkpoint_interval_s=0.0, device=CPU)
    _preempt("lambda.boundary", 3,
             lambda: tem.entropy_grid(60, deg, cfg, **ckw))
    got = tem.entropy_grid(60, deg, cfg, **ckw)
    np.testing.assert_array_equal(got.n_lambda, want.n_lambda)
    np.testing.assert_array_equal(got.counts, want.counts)
    for f in ("ent", "m_init", "ent1"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=1e-9, err_msg=f)


# ---------------------------------------------------------------------------
# every resumable driver: preempted and resumed == left alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first,second", [(2, 0), (0, 3)],
                         ids=["grouped-then-serial", "serial-then-grouped"])
def test_sa_ensemble_resumes_across_paths_and_group_sizes(tmp_path, first,
                                                          second):
    cfg = SAConfig(dynamics=DYN11)
    kw = dict(n_stat=4, seed=2, max_steps=1500, chunk_steps=64, device=CPU)
    want = tsa.sa_ensemble(50, 3, cfg, **kw)
    ckw = dict(checkpoint_path=str(tmp_path / "ck"), checkpoint_interval_s=0)
    _preempt("rep.boundary", 2, lambda: tsa.sa_ensemble(
        50, 3, cfg, group_size=first, **kw, **ckw))
    got = tsa.sa_ensemble(50, 3, cfg, group_size=second, **kw, **ckw)
    _equal(got, want)
    assert not os.path.exists(ckw["checkpoint_path"] + ".npz")


def test_sa_grouped_shutdown_mid_group_reruns_the_group(tmp_path):
    """A graceful shutdown between chunks of a group snapshots the
    completed prefix and exits; the resumed run equals the uninterrupted
    one."""
    cfg = SAConfig(dynamics=DYN11)
    kw = dict(n_stat=3, seed=5, max_steps=1500, chunk_steps=32,
              group_size=2, device=CPU)
    want = tsa.sa_ensemble(50, 3, cfg, **kw)
    ck = str(tmp_path / "ck")
    with tres.graceful_shutdown():
        tres.request_shutdown(signal.SIGTERM)
        with pytest.raises(tres.ShutdownRequested):
            tsa.sa_ensemble(50, 3, cfg, checkpoint_path=ck,
                            checkpoint_interval_s=1e9, **kw)
    assert tio.Checkpoint(ck).load()[1]["next_rep"] == 0
    got = tsa.sa_ensemble(50, 3, cfg, checkpoint_path=ck, **kw)
    _equal(got, want)


def test_temper_ladder_resumes_bit_exact(tmp_path):
    g = random_regular_graph(64, 3, seed=0)
    cfg = SAConfig(dynamics=DYN11)
    kw = dict(n_lanes=4, max_steps=1500, swap_interval=100, seed=3,
              device=CPU)
    want = ttemp.temper_search(g, cfg, **kw)
    ckw = dict(checkpoint_path=str(tmp_path / "ck"), checkpoint_interval_s=0)
    for at in (4, 3):
        _preempt("chunk.boundary", at,
                 lambda: ttemp.temper_search(g, cfg, **kw, **ckw))
    got = ttemp.temper_search(g, cfg, **kw, **ckw)
    for name in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    assert not os.path.exists(ckw["checkpoint_path"] + ".npz")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hpr_batch_and_ensemble_resume_bit_exact(tmp_path, dtype):
    g = random_regular_graph(40, 4, seed=2)
    cfg = HPRConfig(max_sweeps=60, dtype=dtype)
    want = th.hpr_solve_batch(g, cfg, n_replicas=3, seed=4, chunk_sweeps=6,
                              device=CPU)
    ckw = dict(checkpoint_path=str(tmp_path / "b"), chunk_sweeps=6,
               checkpoint_interval_s=0.0, device=CPU)
    _preempt("chunk.boundary", 3, lambda: th.hpr_solve_batch(
        g, cfg, n_replicas=3, seed=4, **ckw))
    got = th.hpr_solve_batch(g, cfg, n_replicas=3, seed=4, **ckw)
    _equal(got[:4], want[:4])
    kw = dict(n_rep=3, seed=1, device=CPU)
    want = th.hpr_ensemble(40, 4, cfg, group_size=2, **kw)
    ck = dict(checkpoint_path=str(tmp_path / "e"), checkpoint_interval_s=0)
    _preempt("rep.boundary", 1, lambda: th.hpr_ensemble(
        40, 4, cfg, group_size=0, **kw, **ck))
    got = th.hpr_ensemble(40, 4, cfg, group_size=2, **kw, **ck)
    _equal(got[:4], want[:4])


def test_hpr_serial_ensemble_resumes_mid_chain(tmp_path):
    """The serial path's chain in flight resumes from <path>_chain<k>."""
    cfg = HPRConfig(max_sweeps=150)
    kw = dict(n_rep=2, seed=3, group_size=0, device=CPU)
    want = th.hpr_ensemble(40, 4, cfg, **kw)
    ck = str(tmp_path / "ck")
    with tres.graceful_shutdown():
        with tres.FaultPlan([tres.FaultSpec("rep.boundary", "signal")]):
            with pytest.raises(tres.ShutdownRequested):
                th.hpr_ensemble(40, 4, cfg, checkpoint_path=ck,
                                checkpoint_interval_s=1e9, **kw)
    assert tio.Checkpoint(ck).load()[1]["next_rep"] == 1
    got = th.hpr_ensemble(40, 4, cfg, checkpoint_path=ck, **kw)
    _equal(got[:4], want[:4])


@pytest.mark.parametrize("group_size", [0, 3])
def test_entropy_grid_twice_interrupted_resumes(tmp_path, group_size):
    cfg = EntropyConfig(dynamics=DYN11, lmbd_max=0.5, num_rep=2, eps=1e-5,
                        max_sweeps=200, plateau_eps=1e-3, plateau_patience=2)
    deg = np.array([1.0, 1.5])
    kw = dict(seed=1, device=CPU)
    want = tem.entropy_grid(60, deg, cfg, **kw)
    ckw = dict(checkpoint_path=str(tmp_path / "ck"), checkpoint_interval_s=0)
    _preempt("lambda.boundary", 3, lambda: tem.entropy_grid(
        60, deg, cfg, group_size=group_size, **kw, **ckw))
    _preempt("lambda.boundary", 4, lambda: tem.entropy_grid(
        60, deg, cfg, group_size=3 - group_size, **kw, **ckw))
    got = tem.entropy_grid(60, deg, cfg, group_size=group_size, **kw, **ckw)
    for f in ("ent", "m_init", "ent1", "counts", "n_lambda"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert not os.path.exists(ckw["checkpoint_path"] + ".npz")


def test_entropy_ensembles_resume_bit_exact(tmp_path):
    cfg = EntropyConfig(dynamics=DYN11, lmbd_max=0.6, max_sweeps=300,
                        eps=1e-5)
    members = [erdos_renyi_graph(50, 2.0 / 49, seed=s) for s in range(3)]
    want = tem.entropy_ensemble_union(members, cfg, seed=2, device=CPU)
    ckw = dict(checkpoint_path=str(tmp_path / "u"), checkpoint_interval_s=0,
               device=CPU)
    for at in (2, 2):
        _preempt("lambda.boundary", at, lambda: tem.entropy_ensemble_union(
            members, cfg, seed=2, **ckw))
    got = tem.entropy_ensemble_union(members, cfg, seed=2, **ckw)
    _equal(got[:6], want[:6])
    np.testing.assert_array_equal(got.chi, want.chi)
    rr = [random_regular_graph(30, 3, seed=s) for s in range(2)]
    want = tem.entropy_ensemble(rr, cfg, seed=2, device=CPU)
    ckw["checkpoint_path"] = str(tmp_path / "e")
    _preempt("lambda.boundary", 2,
             lambda: tem.entropy_ensemble(rr, cfg, seed=2, **ckw))
    got = tem.entropy_ensemble(rr, cfg, seed=2, **ckw)
    _equal(got[:6], want[:6])


def test_entropy_sweep_checkpointer_resume(tmp_path):
    """``entropy_sweep``'s caller-managed checkpointer: resume from the
    saved chi at the first unvisited λ gives the uninterrupted rows."""
    g = erdos_renyi_graph(60, 1.5 / 59, seed=0)
    cfg = EntropyConfig(dynamics=DYN11, lmbd_max=0.6, max_sweeps=300)
    want = tem.entropy_sweep(g, cfg, seed=0, device=CPU)
    pc = tio.PeriodicCheckpointer(str(tmp_path / "ck"), interval_s=0.0)
    _preempt("lambda.boundary", 3, lambda: tem.entropy_sweep(
        g, cfg, seed=0, checkpointer=pc, device=CPU))
    arrays, meta = pc.ckpt.load()
    k = arrays["lambdas"].size
    rest = tem.entropy_sweep(g, cfg, seed=0, chi0=arrays["chi"],
                             lambdas=tem.lambda_ladder(cfg)[k:], device=CPU)
    np.testing.assert_array_equal(
        np.concatenate([arrays["ent1"], rest.ent1]), want.ent1)
    np.testing.assert_array_equal(rest.chi, want.chi)


def test_fused_and_chromatic_exit_at_a_chunk_on_shutdown():
    """Without a checkpoint, a pending shutdown ends ``fused_anneal`` and
    ``chromatic_anneal`` at their next chunk (exit 75 in the CLI); a rerun
    is the uninterrupted run (the chains re-derive from the seed)."""
    g = random_regular_graph(90, 3, seed=1)
    cfg = SAConfig(dynamics=DYN11)
    kw = dict(n_replicas=8, seed=2, max_sweeps=40, chunk_sweeps=8,
              device=CPU)
    for run in (tsf.fused_anneal, tsc.chromatic_anneal):
        want = run(g, cfg, **kw)
        with tres.graceful_shutdown():
            tres.request_shutdown(signal.SIGTERM)
            with pytest.raises(tres.ShutdownRequested) as e:
                run(g, cfg, **kw)
        assert e.value.where == "chunk"
        got = run(g, cfg, **kw)
        np.testing.assert_array_equal(got.s, want.s)
        assert got.accepted == want.accepted


# ---------------------------------------------------------------------------
# the CLI: real signals, deadlines and the supervisor
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("GRAPHDYN_FAULT_PLAN", None)
    return env


SA_ARGS = ["sa", "--device", "cpu", "--n", "60", "--d", "3", "--p", "1",
           "--c", "1", "--n-stat", "3", "--max-steps", "1500",
           "--chunk-steps", "64", "--group-size", "0"]


def test_cli_deadline_exits_75(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "graphdyn_torch", "--deadline", "0.5", "fused",
         "--device", "cpu", "--n", "300", "--replicas", "32",
         "--max-sweeps", "100000", "--chunk-sweeps", "1"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 75, proc.stderr[-2000:]
    assert "exiting 75" in proc.stderr


def test_cli_real_sigterm_saves_exits_75_and_resumes(tmp_path):
    ref = str(tmp_path / "ref")
    subprocess.run([sys.executable, "-m", "graphdyn_torch", *SA_ARGS,
                    "--out", ref], cwd=tmp_path, env=_env(), check=True,
                   capture_output=True, timeout=120)
    ck = tmp_path / "ck" / "run"
    args = [sys.executable, "-m", "graphdyn_torch", *SA_ARGS,
            "--max-steps", "200000", "--checkpoint", str(ck),
            "--checkpoint-interval", "0"]
    proc = subprocess.Popen(args, cwd=tmp_path, env=_env(),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.monotonic() + 60.0
        while not os.path.exists(str(ck) + "_chain0.npz"):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, err[-2000:]
    arrays, meta = tio.open_checkpoint(str(ck) + "_chain0").load()
    assert meta["kind"] == "sa_chain" and int(arrays["t"][0]) > 0


def test_supervised_crash_restarts_to_the_result_and_loop_quarantines(
        tmp_path, monkeypatch):
    """In-process episodes under one fault plan: a crash after the second
    repetition restarts from the snapshot and ends with the uninterrupted
    result; a crash at every first chunk boundary is a loop, exit 86."""
    monkeypatch.chdir(tmp_path)
    ref = str(tmp_path / "ref")
    from graphdyn_torch.cli import main

    assert main(SA_ARGS + ["--out", ref]) == 0
    pol = tsup.RestartPolicy(backoff=tres.RetryPolicy(
        tries=4, base_delay_s=0.001, max_delay_s=0.002, jitter=True))
    args = SA_ARGS + ["--out", "sup", "--checkpoint", "ck/run",
                      "--checkpoint-interval", "0"]
    with tres.FaultPlan([tres.FaultSpec("rep.boundary", "preempt", at=2)]):
        report = tsup.supervise(args, workdir="w", policy=pol,
                                runner=tsup.run_inprocess)
    assert report["exit"] == 0 and [e["rc"] for e in report["episodes"]] == \
        [137, 0]
    a, b = np.load(ref + ".npz"), np.load(str(tmp_path / "sup.npz"))
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    _, problems = tstore.validate_journal(report["journal"])
    assert problems == []
    with tres.FaultPlan([tres.FaultSpec("chunk.boundary", "preempt",
                                        count=99)]):
        report = tsup.supervise(args[:-4] + ["--checkpoint", "ck2/run"],
                                workdir="w2", policy=pol,
                                runner=tsup.run_inprocess)
    assert report["exit"] == tsup.EX_QUARANTINE == 86
    assert report["quarantined"] and len(report["episodes"]) == 3
