"""The port's fault tolerance (``graphdyn_torch.resilience``, the
checkpoint layer of ``graphdyn_torch.utils.io``), as
``tests/test_resilience.py`` holds the JAX package's: every recovery path
has an injection test. Fault plans, checkpoint write failures (retry, then
skip-save), read corruption (quarantine), preemption at chunk, repetition
and λ boundaries (bit-exact resume), the ``pallas.lower`` site (the port
raises, never carries on in the plain version), a NaN in the sweep carry,
SIGTERM → snapshot → exit 75, the second signal → exit 130, and the retry
primitive. Everything runs on the CPU at small sizes.
"""

import functools
import logging
import os
import signal
import time

import numpy as np
import pytest
import torch

from graphdyn_torch.config import DynamicsConfig, EntropyConfig, HPRConfig, SAConfig
from graphdyn_torch.graphs import erdos_renyi_graph, random_regular_graph
from graphdyn_torch.models import entropy as _entropy
from graphdyn_torch.models import hpr as _hpr
from graphdyn_torch.models import sa as _sa
from graphdyn_torch.resilience import (
    FaultPlan,
    FaultSpec,
    InjectedPreemption,
    InjectedWriteError,
    RetryPolicy,
    ShutdownRequested,
    check_fault,
    graceful_shutdown,
    retry,
    shutdown_requested,
    truncate_file,
)
from graphdyn_torch.utils.io import Checkpoint, PeriodicCheckpointer

# the solvers, on the CPU
simulated_annealing = functools.partial(_sa.simulated_annealing, device="cpu")
sa_ensemble = functools.partial(_sa.sa_ensemble, device="cpu")
hpr_solve = functools.partial(_hpr.hpr_solve, device="cpu")
entropy_grid = functools.partial(_entropy.entropy_grid, device="cpu")
entropy_sweep = functools.partial(_entropy.entropy_sweep, device="cpu")


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

pytestmark = pytest.mark.faultinject

DYN11 = DynamicsConfig(p=1, c=1)


def _assert_sa_equal(a, b):
    np.testing.assert_array_equal(a.s, b.s)
    np.testing.assert_array_equal(a.mag_reached, b.mag_reached)
    np.testing.assert_array_equal(a.num_steps, b.num_steps)
    np.testing.assert_array_equal(a.m_final, b.m_final)


# ---------------------------------------------------------------------------
# FaultPlan mechanics
# ---------------------------------------------------------------------------


def test_fault_plan_at_count_match_and_reset():
    plan = FaultPlan([
        FaultSpec("s", at=2, count=2),
        FaultSpec("t", match="abc"),
    ])
    with plan:
        assert check_fault("s") is None          # hit 1 (< at)
        assert check_fault("s") is not None      # hit 2
        assert check_fault("s") is not None      # hit 3 (count=2 window)
        assert check_fault("s") is None          # hit 4 (spent)
        assert check_fault("t", key="xyz") is None
        assert check_fault("t", key="xx abc yy") is not None
    assert check_fault("s") is None              # no active plan: no-op
    with plan:                                   # re-entry resets counters
        assert check_fault("s") is None
        assert check_fault("s") is not None


def test_fault_plan_seeded_probability_is_deterministic():
    def pattern(seed):
        with FaultPlan([FaultSpec("s", count=100, p=0.5)], seed=seed):
            return [check_fault("s") is not None for _ in range(24)]

    a, b = pattern(7), pattern(7)
    assert a == b
    assert any(a) and not all(a)                 # actually probabilistic


def test_env_hook_fires_through_a_real_site(monkeypatch, tmp_path):
    """GRAPHDYN_FAULT_PLAN (JSON) drives injection with no in-process plan —
    the CLI-level hook."""
    from graphdyn_torch.resilience import faults

    monkeypatch.setenv(faults.ENV_VAR, '[{"site": "checkpoint.write"}]')
    monkeypatch.setattr(faults, "_env_plan_cache", [])
    ck = Checkpoint(str(tmp_path / "s"))
    with pytest.raises(InjectedWriteError):
        ck.save({"x": np.zeros(1)}, {})
    ck.save({"x": np.zeros(1)}, {"t": 1})        # one-shot spec: spent
    assert ck.load()[1] == {"t": 1}


def test_env_hook_malformed_plan_fails_loudly(monkeypatch):
    from graphdyn_torch.resilience import faults

    monkeypatch.setenv(faults.ENV_VAR, "{not json")
    with pytest.raises(ValueError):
        faults.FaultPlan.from_env()


# ---------------------------------------------------------------------------
# fault class 1: checkpoint write failure — retry, then degrade to skip-save
# ---------------------------------------------------------------------------


def test_write_failure_survived_by_retry(tmp_path, caplog):
    pc = PeriodicCheckpointer(str(tmp_path / "pc"), interval_s=0.0)
    with caplog.at_level(logging.WARNING, logger="graphdyn_torch.resilience"):
        with FaultPlan([FaultSpec("checkpoint.write", count=1)]):
            assert pc.maybe_save({"x": np.arange(3)}, {"t": 1})
    assert pc.ckpt.load()[1] == {"t": 1}
    assert "retrying" in caplog.text


def test_write_failure_exhausted_degrades_to_skip_save(tmp_path, caplog):
    pc = PeriodicCheckpointer(str(tmp_path / "pc"), interval_s=0.0)
    with caplog.at_level(logging.WARNING):
        with FaultPlan([FaultSpec("checkpoint.write", count=99)]):
            assert not pc.maybe_save({"x": np.arange(3)}, {"t": 1})
    assert pc.ckpt.load() is None
    assert "SKIPPING" in caplog.text             # the explicit logged decision


def test_torn_temp_file_never_corrupts_published_checkpoint(tmp_path):
    ck = Checkpoint(str(tmp_path / "st"))
    ck.save({"x": np.arange(4)}, {"t": 0})
    with FaultPlan([FaultSpec("checkpoint.write", action="torn")]):
        with pytest.raises(InjectedWriteError):
            ck.save({"x": np.arange(4) + 1}, {"t": 1})
    assert os.path.exists(str(tmp_path / "st.tmp.npz"))   # torn temp left
    arrays, meta = ck.load()                     # published file: old state
    np.testing.assert_array_equal(arrays["x"], np.arange(4))
    assert meta == {"t": 0}
    ck.remove()                                  # cleans snapshot AND temp
    assert not os.path.exists(str(tmp_path / "st.tmp.npz"))


def test_chain_survives_persistent_write_failure(tmp_path, caplog):
    """An hours-long chain with a dead disk keeps computing: every save
    degrades to skip-save, results identical to the no-checkpoint run."""
    g = random_regular_graph(24, 3, seed=0)
    cfg = SAConfig(dynamics=DYN11)
    base = simulated_annealing(g, cfg, n_replicas=1, seed=0, max_steps=4000)
    with caplog.at_level(logging.WARNING):
        with FaultPlan([FaultSpec("checkpoint.write", count=9999)]):
            res = simulated_annealing(
                g, cfg, n_replicas=1, seed=0, max_steps=4000,
                checkpoint_path=str(tmp_path / "ck"), chunk_steps=1500,
                checkpoint_interval_s=0.0,
            )
    _assert_sa_equal(base, res)
    assert "SKIPPING" in caplog.text


def test_injected_signal_does_not_outlive_its_plan(tmp_path):
    """A fired 'signal' spec outside any graceful_shutdown scope must not
    leave the process-global flag set — later solver calls would all die at
    their first boundary."""
    cfg = SAConfig(dynamics=DYN11)
    kw = dict(n_stat=2, seed=0, max_steps=3000)
    with FaultPlan([FaultSpec("rep.boundary", "signal", at=1)]):
        with pytest.raises(ShutdownRequested):
            sa_ensemble(40, 3, cfg, **kw,
                        checkpoint_path=str(tmp_path / "ck"),
                        checkpoint_interval_s=0.0)
    assert not shutdown_requested()              # plan exit cleared it
    sa_ensemble(40, 3, cfg, **kw)                # and the process still works


def test_preempt_is_honored_at_specialized_sites(tmp_path):
    """'preempt' at checkpoint.write must be a hard kill, never downgraded
    to the site's retryable ENOSPC error (which retry() would survive)."""
    ck = Checkpoint(str(tmp_path / "s"))
    with FaultPlan([FaultSpec("checkpoint.write", "preempt")]):
        with pytest.raises(InjectedPreemption):
            ck.save({"x": np.zeros(1)}, {})


def test_mismatched_action_at_transform_site_raises():
    """A plan naming a transform-only site with the wrong action must fail
    loudly, not silently no-op."""
    from graphdyn_torch.resilience import InjectedFault, transform_spec

    with FaultPlan([FaultSpec("sweep.nan", action="raise")]):
        with pytest.raises(InjectedFault):
            transform_spec("sweep.nan", "nan")


def test_transient_read_oserror_propagates_not_quarantined(tmp_path, monkeypatch):
    """A transient OSError (EIO / network blip) on a perfectly good
    checkpoint must NOT destroy it via quarantine — only structural
    corruption is quarantined."""
    import graphdyn_torch.utils.io as io_mod

    ck = Checkpoint(str(tmp_path / "s"))
    ck.save({"x": np.arange(4)}, {"t": 1})
    real_load = io_mod.np.load
    monkeypatch.setattr(io_mod.np, "load",
                        lambda *a, **k: (_ for _ in ()).throw(OSError(5, "EIO")))
    with pytest.raises(OSError):
        ck.load()
    monkeypatch.setattr(io_mod.np, "load", real_load)
    assert ck.load()[1] == {"t": 1}              # checkpoint intact
    assert not os.path.exists(str(tmp_path / "s.corrupt.npz"))


# ---------------------------------------------------------------------------
# fault class 2: checkpoint read corruption — quarantine + fresh start
# ---------------------------------------------------------------------------


def test_corrupt_checkpoint_quarantined_not_raised(tmp_path, caplog):
    ck = Checkpoint(str(tmp_path / "s"))
    ck.save({"x": np.arange(8.0)}, {"t": 3})
    with caplog.at_level(logging.WARNING, logger="graphdyn_torch.io"):
        with FaultPlan([FaultSpec("checkpoint.read", action="truncate")]):
            assert ck.load() is None             # never zipfile.BadZipFile
    assert os.path.exists(str(tmp_path / "s.corrupt.1.npz"))  # monotonic suffix
    assert "quarantined" in caplog.text
    assert ck.load() is None                     # bad file moved aside


def test_chain_resumes_fresh_after_corruption(tmp_path):
    """Preempt a chain, corrupt its snapshot on disk, rerun: the corrupt
    file is quarantined and the chain still lands on the uninterrupted
    result (since the durable store, via a retained-version fallback when
    one survives — the truncation travels through the promote hard link to
    the newest version — else a fresh start; both are bit-exact)."""
    g = random_regular_graph(24, 3, seed=0)
    cfg = SAConfig(dynamics=DYN11)
    kw = dict(n_replicas=1, seed=0, max_steps=4000)
    ckw = dict(checkpoint_path=str(tmp_path / "ck"), chunk_steps=50,
               checkpoint_interval_s=0.0)
    base = simulated_annealing(g, cfg, **kw)
    with FaultPlan([FaultSpec("chunk.boundary", "preempt", at=4)]):
        with pytest.raises(InjectedPreemption):
            simulated_annealing(g, cfg, **kw, **ckw)
    truncate_file(str(tmp_path / "ck.npz"), 0.4)
    res = simulated_annealing(g, cfg, **kw, **ckw)
    _assert_sa_equal(base, res)
    assert os.path.exists(str(tmp_path / "ck.corrupt.1.npz"))
    assert not os.path.exists(str(tmp_path / "ck.npz"))   # removed on success


# ---------------------------------------------------------------------------
# fault class 3: preemption at chunk/rep/λ boundaries — bit-exact resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("boundary", [1, 3])
def test_sa_chunk_preemption_resume_bit_exact(tmp_path, boundary):
    g = random_regular_graph(24, 3, seed=0)
    cfg = SAConfig(dynamics=DYN11)
    kw = dict(n_replicas=1, seed=0, max_steps=4000)
    ckw = dict(checkpoint_path=str(tmp_path / "ck"), chunk_steps=50,
               checkpoint_interval_s=0.0)
    base = simulated_annealing(g, cfg, **kw)
    with FaultPlan([FaultSpec("chunk.boundary", "preempt", at=boundary)]):
        with pytest.raises(InjectedPreemption):
            simulated_annealing(g, cfg, **kw, **ckw)
    res = simulated_annealing(g, cfg, **kw, **ckw)       # resume
    _assert_sa_equal(base, res)
    assert not os.path.exists(str(tmp_path / "ck.npz"))  # remove() ran


@pytest.mark.parametrize("boundary", [2, 4])
def test_hpr_chunk_preemption_resume_bit_exact(tmp_path, boundary):
    g = random_regular_graph(30, 3, seed=1)
    cfg = HPRConfig(dynamics=DYN11, max_sweeps=400)
    ckw = dict(checkpoint_path=str(tmp_path / "ck"), chunk_sweeps=20,
               checkpoint_interval_s=0.0)
    base = hpr_solve(g, cfg, seed=0)
    with FaultPlan([FaultSpec("chunk.boundary", "preempt", at=boundary)]):
        with pytest.raises(InjectedPreemption):
            hpr_solve(g, cfg, seed=0, **ckw)
    res = hpr_solve(g, cfg, seed=0, **ckw)               # resume
    np.testing.assert_array_equal(base.s, res.s)
    np.testing.assert_array_equal(base.biases, res.biases)
    np.testing.assert_array_equal(base.chi, res.chi)
    assert base.num_steps == res.num_steps
    assert base.m_final == res.m_final
    assert not os.path.exists(str(tmp_path / "ck.npz"))


def test_sa_ensemble_rep_preemption_resume_parity(tmp_path):
    cfg = SAConfig(dynamics=DYN11)
    kw = dict(n_stat=3, seed=0, max_steps=3000)
    base = sa_ensemble(40, 3, cfg, **kw)
    ck = str(tmp_path / "ck")
    with FaultPlan([FaultSpec("rep.boundary", "preempt", at=2)]):
        with pytest.raises(InjectedPreemption):
            sa_ensemble(40, 3, cfg, **kw, checkpoint_path=ck,
                        checkpoint_interval_s=0.0)
    res = sa_ensemble(40, 3, cfg, **kw, checkpoint_path=ck,
                      checkpoint_interval_s=0.0)
    np.testing.assert_array_equal(base.mag_reached, res.mag_reached)
    np.testing.assert_array_equal(base.num_steps, res.num_steps)
    np.testing.assert_array_equal(base.conf, res.conf)
    np.testing.assert_array_equal(base.graphs, res.graphs)
    np.testing.assert_array_equal(base.m_final, res.m_final)
    assert not os.path.exists(ck + ".npz")


def test_entropy_driver_lambda_preemption_resume_parity(tmp_path):
    cfg = EntropyConfig(
        dynamics=DYN11, lmbd_max=0.3, lmbd_step=0.1, max_sweeps=300,
        num_rep=1, eps=1e-5,
    )
    deg = np.array([1.5])
    kw = dict(seed=3, class_bucket=None)
    base = entropy_grid(60, deg, cfg, **kw)
    ck = str(tmp_path / "ck")
    with FaultPlan([FaultSpec("lambda.boundary", "preempt", at=2)]):
        with pytest.raises(InjectedPreemption):
            entropy_grid(60, deg, cfg, **kw, checkpoint_path=ck,
                         checkpoint_interval_s=0.0)
    res = entropy_grid(60, deg, cfg, **kw, checkpoint_path=ck,
                       checkpoint_interval_s=0.0)
    np.testing.assert_array_equal(base.ent, res.ent)
    np.testing.assert_array_equal(base.m_init, res.m_init)
    np.testing.assert_array_equal(base.ent1, res.ent1)
    np.testing.assert_array_equal(base.counts, res.counts)
    np.testing.assert_array_equal(base.n_lambda, res.n_lambda)
    assert not os.path.exists(ck + ".npz")


# ---------------------------------------------------------------------------
# fault class 4: a kernel build failure (pallas.lower) — the run raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("action,exc", [("raise", "InjectedLoweringError"),
                                        ("preempt", "InjectedPreemption")])
def test_pallas_lower_site_raises_never_plain_fallback(action, exc):
    """The JAX package degrades a class whose kernel does not lower to its
    XLA twin; the port raises at the site (where each class's program is
    chosen) and never carries on in the plain version."""
    from graphdyn_torch.ops.bdcm import BDCMData, make_sweep
    from graphdyn_torch.resilience import faults

    g = random_regular_graph(64, 4, seed=0)
    data = BDCMData(g, p=1, c=1)
    with FaultPlan([FaultSpec("pallas.lower", action)]):
        with pytest.raises(getattr(faults, exc)):
            make_sweep(data, damp=0.5, device="cpu")
    sweep = make_sweep(data, damp=0.5, device="cpu")   # plan spent: builds
    assert np.isfinite(sweep(data.init_messages(0), 0.25).numpy()).all()


def test_pallas_lower_site_fails_hpr_and_entropy_cli(tmp_path, capsys,
                                                    monkeypatch):
    """Through the CLI: an injected build failure of a sweep class ends the
    run with the exception (a non-zero exit) and no result file; its flight
    post-mortem lands in the working directory."""
    from graphdyn_torch.cli import main
    from graphdyn_torch.resilience import faults

    monkeypatch.chdir(tmp_path)

    for args in (["hpr", "--n", "40", "--max-sweeps", "20"],
                 ["entropy", "--n", "40", "--deg", "1.5", "--num-rep", "1",
                  "--lmbd-max", "0.2"]):
        out = str(tmp_path / f"{args[0]}.npz")
        with FaultPlan([FaultSpec("pallas.lower", count=99)]):
            with pytest.raises(faults.InjectedLoweringError):
                main(args + ["--device", "cpu", "--out", out])
        capsys.readouterr()
        assert not os.path.exists(out)
        assert os.path.exists(tmp_path / "obs_postmortem.jsonl")


def test_nan_in_sweep_carry_degrades_to_nonconvergence(caplog, tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    g = erdos_renyi_graph(60, 1.5 / 59, seed=0)
    cfg = EntropyConfig(
        dynamics=DYN11, lmbd_max=0.3, lmbd_step=0.1, max_sweeps=300, eps=1e-5,
    )
    base = entropy_sweep(g, cfg, seed=0)
    assert base.lambdas.size >= 3                # ladder normally runs on
    with caplog.at_level(logging.WARNING, logger="graphdyn_torch.models"):
        with FaultPlan([FaultSpec("sweep.nan", action="nan", at=2)]):
            res = entropy_sweep(g, cfg, seed=0)  # no XLA/numpy traceback
    assert res.lambdas.size == 2                 # stopped AT the poisoned λ
    assert res.nonconverged == pytest.approx(base.lambdas[1])
    assert "non-finite" in caplog.text           # the logged decision


# ---------------------------------------------------------------------------
# preemption-safe shutdown: SIGTERM → checkpoint at chunk boundary → exit 75
# ---------------------------------------------------------------------------


def test_real_sigterm_sets_flag_and_second_signal_aborts():
    with graceful_shutdown():
        assert not shutdown_requested()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not shutdown_requested() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert shutdown_requested()
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(1.0)
    assert not shutdown_requested()              # scope exit clears the flag


def test_sigterm_chain_checkpoints_and_exits_then_resumes(tmp_path):
    """SIGTERM during a checkpointed chain: snapshot at the next chunk
    boundary (no older than one chunk), ShutdownRequested out, bit-exact
    completion on requeue."""
    g = random_regular_graph(24, 3, seed=0)
    cfg = SAConfig(dynamics=DYN11)
    kw = dict(n_replicas=1, seed=0, max_steps=4000)
    ckw = dict(checkpoint_path=str(tmp_path / "ck"), chunk_steps=50,
               checkpoint_interval_s=1e9)       # interval never due: the
    base = simulated_annealing(g, cfg, **kw)    # shutdown save must force
    with graceful_shutdown():
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not shutdown_requested() and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(ShutdownRequested):
            simulated_annealing(g, cfg, **kw, **ckw)
    loaded = Checkpoint(str(tmp_path / "ck")).load()
    assert loaded is not None                    # loadable checkpoint…
    arrays, meta = loaded
    assert meta["kind"] == "sa_chain"
    assert int(np.asarray(arrays["t"])[0]) == 50  # …exactly one chunk old
    res = simulated_annealing(g, cfg, **kw, **ckw)
    _assert_sa_equal(base, res)
    assert not os.path.exists(str(tmp_path / "ck.npz"))


def test_sa_ensemble_shutdown_snapshots_prefix(tmp_path):
    cfg = SAConfig(dynamics=DYN11)
    kw = dict(n_stat=3, seed=0, max_steps=3000)
    base = sa_ensemble(40, 3, cfg, **kw)
    ck = str(tmp_path / "ck")
    with graceful_shutdown():
        # the 'signal' action delivers a shutdown request exactly as the
        # SIGTERM handler would — deterministically, at rep boundary 1
        with FaultPlan([FaultSpec("rep.boundary", "signal", at=1)]):
            with pytest.raises(ShutdownRequested):
                sa_ensemble(40, 3, cfg, **kw, checkpoint_path=ck,
                            checkpoint_interval_s=1e9)
    arrays, meta = Checkpoint(ck).load()
    assert meta["next_rep"] == 1                 # rep 0 persisted
    res = sa_ensemble(40, 3, cfg, **kw, checkpoint_path=ck,
                      checkpoint_interval_s=0.0)
    np.testing.assert_array_equal(base.conf, res.conf)
    np.testing.assert_array_equal(base.num_steps, res.num_steps)
    assert not os.path.exists(ck + ".npz")


def test_cli_preemption_exits_75_and_resumes(tmp_path, capsys, monkeypatch):
    """End to end through the CLI: a shutdown request mid-λ-ladder exits
    EX_TEMPFAIL (75) with a loadable checkpoint; rerunning the same command
    resumes, completes with exit 0, and cleans the checkpoint up."""
    from graphdyn_torch.cli import main

    monkeypatch.chdir(tmp_path)

    ck = str(tmp_path / "ck")
    out = str(tmp_path / "res.npz")
    args = [
        "entropy", "--n", "50", "--deg", "1.5", "--num-rep", "1",
        "--lmbd-max", "0.3", "--lmbd-step", "0.1", "--max-sweeps", "200",
        "--eps", "1e-5", "--seed", "1", "--device", "cpu",
        "--checkpoint", ck, "--checkpoint-interval", "0", "--out", out,
    ]
    with FaultPlan([FaultSpec("lambda.boundary", "signal", at=2)]):
        rc = main(args)
    capsys.readouterr()
    assert rc == 75
    loaded = Checkpoint(ck).load()
    assert loaded is not None and "grid_id" in loaded[1]
    rc2 = main(args)                             # requeue
    capsys.readouterr()
    assert rc2 == 0
    assert os.path.exists(out)
    assert not os.path.exists(ck + ".npz")


# ---------------------------------------------------------------------------
# the retry primitive
# ---------------------------------------------------------------------------


def test_retry_backs_off_then_succeeds():
    calls = {"n": 0}
    slept = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    out = retry(flaky, policy=RetryPolicy(tries=4, base_delay_s=0.01),
                sleep=slept.append)
    assert out == "ok" and calls["n"] == 3
    assert slept == [0.01, 0.02]                 # exponential backoff


def test_retry_exhaustion_reraises():
    with pytest.raises(OSError):
        retry(lambda: (_ for _ in ()).throw(OSError("dead")),
              policy=RetryPolicy(tries=2, base_delay_s=0.0),
              sleep=lambda s: None)


def test_retry_if_surfaces_deterministic_failures_immediately():
    calls = {"n": 0}

    def deterministic():
        calls["n"] += 1
        raise OSError("config error, retrying cannot help")

    with pytest.raises(OSError):
        retry(deterministic, policy=RetryPolicy(tries=5, base_delay_s=0.0),
              retry_if=lambda e: "transient" in str(e), sleep=lambda s: None)
    assert calls["n"] == 1                       # no pointless backoff


def test_retry_jitter_deterministic_per_key_and_spread_across_ranks():
    """Seeded full-jitter (RetryPolicy.jitter): the same site key replays
    the same schedule (tests stay deterministic), distinct rank keys draw
    de-correlated schedules (no retry storms against a shared coordinator
    or filesystem), and every delay stays within (0, exponential bound]."""
    pol = RetryPolicy(tries=6, base_delay_s=0.5, max_delay_s=8.0, jitter=True)
    a1 = list(pol.delays(key="torch.distributed init (rank 0)"))
    a2 = list(pol.delays(key="torch.distributed init (rank 0)"))
    b = list(pol.delays(key="torch.distributed init (rank 1)"))
    assert a1 == a2                              # deterministic per key
    assert a1 != b                               # spread across ranks
    bounds = [0.5, 1.0, 2.0, 4.0, 8.0]
    for seq in (a1, b):
        assert len(seq) == 5
        assert all(0.0 < d <= hi for d, hi in zip(seq, bounds))
    # jitter off (the default) keeps the exact exponential schedule
    assert list(RetryPolicy(tries=4, base_delay_s=0.5).delays(key="x")) == \
        [0.5, 1.0, 2.0]


def test_retry_passes_site_key_to_jittered_policy():
    """retry() seeds the jitter from its `what` site string — two sites
    with the same policy sleep different schedules."""
    slept = {}
    for what in ("site-a", "site-b"):
        seq = []
        with pytest.raises(OSError):
            retry(lambda: (_ for _ in ()).throw(OSError("dead")),
                  policy=RetryPolicy(tries=4, base_delay_s=0.01, jitter=True),
                  what=what, sleep=seq.append)
        slept[what] = seq
    assert len(slept["site-a"]) == 3
    assert slept["site-a"] != slept["site-b"]


def test_second_signal_hard_abort_exit_code_no_snapshot(
        tmp_path, monkeypatch, capsys):
    """The second-SIGTERM hard-abort path end to end through the CLI: the
    first signal sets the flag, the second aborts immediately — exit 130
    (EX_ABORT, never 75: schedulers must NOT requeue an operator abort), and
    no snapshot written by the abort."""
    import threading

    import graphdyn_torch.cli as cli_mod
    from graphdyn_torch.resilience import EX_ABORT

    monkeypatch.chdir(tmp_path)
    ck = str(tmp_path / "ck")

    def fake_run(args):
        # a long chunk that never reaches a save boundary: the abort, not
        # the driver, decides how this ends
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            time.sleep(0.005)
        raise AssertionError("signals never arrived")

    monkeypatch.setattr(cli_mod, "_run", fake_run)

    # the graceful handler is installed inside main(); firing before that
    # would hit pytest's default SIGTERM disposition and kill the whole
    # test process — wait until the handler visibly changes
    before = signal.getsignal(signal.SIGTERM)

    def killer():
        deadline = time.monotonic() + 5.0
        while (signal.getsignal(signal.SIGTERM) is before
               and time.monotonic() < deadline):
            time.sleep(0.005)
        os.kill(os.getpid(), signal.SIGTERM)     # 1st: flag
        while not shutdown_requested() and time.monotonic() < deadline:
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGTERM)     # 2nd: immediate abort

    t = threading.Thread(target=killer)
    t.start()
    rc = cli_mod.main(["sa", "--n", "40", "--device", "cpu",
                       "--checkpoint", ck])
    t.join()
    capsys.readouterr()
    assert rc == EX_ABORT == 130
    assert not os.path.exists(ck + ".npz")       # nothing saved by the abort


