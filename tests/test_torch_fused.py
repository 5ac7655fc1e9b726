"""The port's fused annealer against the JAX package's, bit for bit: the
counter stream, the tables, the plain class step and chunk loop against
``fused_chunk_xla`` (and one case against the Pallas kernel in interpret
mode), ``fused_anneal`` end to end, the ``fused`` CLI, and the config-1
record ``fused_config1_ref.json``.

The CUDA kernel runs only on a GPU; ``chip_smoke.py`` holds it against the
same plain version there. Run this file as a script to rewrite the record:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fused.py --write
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.config import DynamicsConfig as JDyn, SAConfig as JSA
from graphdyn.ops import pallas_anneal as jpa
from graphdyn.search import fused as jsf
from graphdyn_torch import interop
from graphdyn_torch.config import DynamicsConfig, SAConfig
from graphdyn_torch.graphs import random_regular_graph
from graphdyn_torch.ops.lut import lut_one_step
from graphdyn_torch.ops import fused as tf
from graphdyn_torch.search import fused as tsf
from graphdyn_torch.search.reference import (
    hold_to_record,
    near_tie_replay,
    result_record,
    run_record,
    state_digest,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PATH = os.path.join(REPO, "fused_config1_ref.json")
CPU = torch.device("cpu")

GRAPHS = {
    "rrg3": jg.random_regular_graph(96, 3, seed=0),
    "rrg4": jg.random_regular_graph(80, 4, seed=1),            # ties exist
    "er": jg.erdos_renyi_graph(90, 3.0 / 90, seed=3),   # ragged, isolates
}


def _cfgs(rule="majority", tie="stay"):
    return (JSA(dynamics=JDyn(p=1, c=1, rule=rule, tie=tie)),
            SAConfig(dynamics=DynamicsConfig(p=1, c=1, rule=rule, tie=tie)))


def _tg(g):
    return interop.graph_from_arrays(g.nbr, g.deg, g.edges)


# ---------------------------------------------------------------------------
# counter stream
# ---------------------------------------------------------------------------


def test_counter_uniforms_equal_numpy_oracle_and_digest():
    for seed, step, n, Rp in [(7, 3, 50, 64), (0, 2**32 - 1, 9, 32),
                              (2**32 - 1, 12345, 17, 96)]:
        want = jpa.counter_uniforms_np(seed, step, n, Rp)
        got = tf.counter_uniforms(seed, step, n, Rp)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tf.counter_uniforms_np(seed, step, n, Rp),
                                      want)
        nodes = torch.tensor([n - 1, 0, 3])
        np.testing.assert_array_equal(
            tf.counter_uniforms(seed, step, n, Rp, nodes=nodes).numpy(),
            want[[n - 1, 0, 3]])
    # the committed restart anchor of tests/test_fused.py
    for u0, u1 in [(tf.counter_uniforms_np(0, 0, 4, 32),
                    tf.counter_uniforms_np(0, 1, 4, 32)),
                   (tf.counter_uniforms(0, 0, 4, 32).numpy(),
                    tf.counter_uniforms(0, 1, 4, 32).numpy())]:
        digest = hashlib.sha256(u0.tobytes() + u1.tobytes()).hexdigest()[:16]
        assert digest == "1c9f5e3926cbffd2"
    with pytest.raises(ValueError, match="uint32"):
        tf.counter_uniforms(-1, 0, 4, 32)


def test_threefry_equal_reference_cipher():
    rng = np.random.default_rng(0)
    k0, k1, c0, c1 = rng.integers(0, 2**32, size=(4, 1000), dtype=np.uint64)
    with np.errstate(over="ignore"):
        want = jpa.threefry2x32(*(x.astype(np.uint32) for x in (k0, k1, c0, c1)))
    got = tf.threefry2x32(*(torch.from_numpy(x.astype(np.int64))
                            for x in (k0, k1, c0, c1)))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy().astype(np.uint32), w_)


# ---------------------------------------------------------------------------
# tables, class step, chunk loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule,tie", [("majority", "stay"),
                                      ("minority", "change")])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_build_fused_tables_equal(gname, rule, tie):
    jcfg, tcfg = _cfgs(rule, tie)
    want = jpa.build_fused_tables(GRAPHS[gname], jcfg, seed=2)
    got = tf.build_fused_tables(_tg(GRAPHS[gname]), tcfg, seed=2)
    conv = interop.fused_tables_from_jax(want)
    for t in (got, conv):
        for name in ("masks_ext", "lut_masks", "fac_a", "fac_b"):
            a, b = getattr(t, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        for name in want.chrom._fields:
            np.testing.assert_array_equal(getattr(t.chrom, name),
                                          getattr(want.chrom, name))
    assert (got.chi, got.n, got.dmax) == (want.chi, want.n, want.dmax)


def _assert_state_equal(got: tf.FusedState, want):
    g = interop.fused_state_to_numpy(got)
    for name in want._fields:
        np.testing.assert_array_equal(g[name], np.asarray(getattr(want, name)),
                                      err_msg=name)


# (graph, rule, tie, R, chunk_steps as (multiple of chi, offset),
#  stop_on_first, betas ladder, m_target)
CHUNK_CASES = [
    ("rrg3", "majority", "stay", 5, (0, 1), False, False, 1.0),
    ("rrg3", "minority", "change", 64, (1, 0), False, False, 1.0),
    ("rrg3", "majority", "stay", 64, (2, 3), False, True, 0.7),
    ("er", "majority", "stay", 64, (2, 3), True, False, 0.7),
    ("er", "minority", "change", 5, (1, 0), False, True, 1.0),
    ("rrg4", "majority", "stay", 5, (2, 3), False, False, 0.6),
    ("rrg4", "majority", "change", 64, (1, 0), False, False, 1.0),
    ("rrg4", "minority", "stay", 5, (0, 1), True, False, 0.5),
    ("rrg4", "minority", "change", 64, (2, 3), False, True, 1.0),
]


@pytest.mark.parametrize("case", CHUNK_CASES,
                         ids=["-".join(map(str, c[:5])) for c in CHUNK_CASES])
def test_plain_chunk_equal_xla(case):
    """Two chunks in a row of the plain loop against ``fused_chunk_xla`` in
    every ``FusedState`` field (the second chunk starts from the first's
    output, so the loop's start and stop conditions are exercised twice)."""
    gname, rule, tie, R, (mult, off), stop, ladder, m_target = case
    g = GRAPHS[gname]
    jcfg, _ = _cfgs(rule, tie)
    betas = np.geomspace(1.0, 8.0, R) if ladder else None
    state, tdev, static, tables, _, _, _ = jsf._assemble_fused(
        g, jcfg, n_replicas=R, seed=3, m_target=m_target, betas=betas,
        tables=None)
    chunk_steps = mult * tables.chi + off
    st_t = interop.fused_state_from_jax(state)
    td = interop.fused_device_tables_from_jax(tdev)
    assert st_t.active.any()
    for _ in range(2):
        state = jpa.fused_chunk_xla(state, jnp.uint32(3), *tdev,
                                    chunk_steps=chunk_steps,
                                    stop_on_first=stop, **static)
        st_t = tf.fused_chunk(st_t, 3, td, kernel="auto",
                              chunk_steps=chunk_steps, stop_on_first=stop,
                              **static)
        _assert_state_equal(st_t, state)
    assert int(st_t.accepted) > 0


@pytest.mark.pallas_interpret
def test_plain_chunk_equal_pallas_interpret():
    g = jg.random_regular_graph(48, 3, seed=2)
    jcfg, _ = _cfgs()
    state, tdev, static, tables, _, _, _ = jsf._assemble_fused(
        g, jcfg, n_replicas=8, seed=1, m_target=0.9, betas=None, tables=None)
    st_t = interop.fused_state_from_jax(state)
    td = interop.fused_device_tables_from_jax(tdev)
    kw = dict(chunk_steps=tables.chi + 2, stop_on_first=False, **static)
    want = jpa.fused_chunk_pallas(state, jnp.uint32(1), *tdev, interpret=True,
                                  **kw)
    _assert_state_equal(tf.fused_chunk(st_t, 1, td, kernel="plain", **kw),
                        want)


# ---------------------------------------------------------------------------
# fused_anneal end to end, and the CLI
# ---------------------------------------------------------------------------


def _assert_result_equal(got, want):
    for name in want._fields:
        if name == "kernel_used":
            continue
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize("kw", [
    dict(gname="rrg3", n_replicas=8, seed=4, m_target=0.9, max_sweeps=300,
         chunk_sweeps=64),
    dict(gname="er", n_replicas=40, seed=1, m_target=0.8, max_sweeps=90,
         chunk_sweeps=7, stop_on_first=True, rule="minority", tie="change"),
    dict(gname="rrg4", n_replicas=33, seed=2, m_target=1.0, max_sweeps=40,
         chunk_sweeps=16, ladder=True, tie="change"),
], ids=["rrg3", "er-stop", "rrg4-ladder-tail"])
def test_fused_anneal_equal_xla(kw):
    kw = dict(kw)
    g = GRAPHS[kw.pop("gname")]
    jcfg, tcfg = _cfgs(kw.pop("rule", "majority"), kw.pop("tie", "stay"))
    if kw.pop("ladder", False):
        kw["betas"] = np.geomspace(1.0, 16.0, kw["n_replicas"])
    want = jsf.fused_anneal(g, jcfg, kernel="xla", **kw)
    got = tsf.fused_anneal(_tg(g), tcfg, device="cpu", **kw)
    assert got.kernel_used == "plain" and want.kernel_used == "xla"
    _assert_result_equal(got, want)


def test_fused_anneal_chunk_split_invariant():
    """The RNG counter is the global class step, so chunk boundaries and
    the synced plan (more than 4096 chunks) cannot change the chain."""
    g = _tg(GRAPHS["rrg3"])
    _, tcfg = _cfgs()
    kw = dict(n_replicas=8, seed=0, m_target=0.9, max_sweeps=5000,
              device="cpu")
    a = tsf.fused_anneal(g, tcfg, chunk_sweeps=256, **kw)
    assert (a.steps_to_target >= 0).all()
    for cs in (37, 1):
        _assert_result_equal(tsf.fused_anneal(g, tcfg, chunk_sweeps=cs, **kw),
                             a)


def test_fused_anneal_refusals():
    g = _tg(GRAPHS["rrg3"])
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="p = c = 1"):
        tsf.fused_anneal(g, SAConfig(), n_replicas=2, device="cpu")
    with pytest.raises(ValueError, match="m_target"):
        tsf.fused_anneal(g, tcfg, n_replicas=2, m_target=1.5, device="cpu")
    with pytest.raises(ValueError, match="chunk_sweeps"):
        tsf.fused_anneal(g, tcfg, n_replicas=2, chunk_sweeps=0, device="cpu")
    with pytest.raises(ValueError, match="max_sweeps"):
        tsf.fused_anneal(g, tcfg, n_replicas=2, max_sweeps=0, device="cpu")
    with pytest.raises(ValueError, match="betas"):
        tsf.fused_anneal(g, tcfg, n_replicas=4, betas=np.ones(3),
                         device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        tsf.fused_anneal(g, tcfg, n_replicas=2, kernel="xla", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        tsf.fused_anneal(g, tcfg, n_replicas=2, layout="csr", device="cpu")
    # the bucketed layout runs since the power-law slice; what it refuses is
    # a prebuilt table set, which pins the caller's labeling
    tables = tsf.build_fused_tables(g, tcfg)
    with pytest.raises(ValueError, match="tables"):
        tsf.fused_anneal(g, tcfg, n_replicas=2, layout="bucketed",
                         tables=tables, device="cpu")


def test_cli_fused_equal_jax_cli(tmp_path, capsys):
    from graphdyn.cli import main as jax_main

    args = ["fused", "--n", "300", "--d", "3", "--replicas", "40",
            "--m-target", "0.9", "--max-sweeps", "300", "--chunk-sweeps", "7",
            "--seed", "5", "--ladder-beta-max", "4"]
    assert jax_main(args + ["--kernel", "xla", "--out",
                            str(tmp_path / "j.npz")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "graphdyn_torch", *args, "--device", "cpu",
         "--out", str(tmp_path / "t.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got.keys() == want.keys()
    assert (got.pop("kernel"), want.pop("kernel")) == ("plain", "xla")
    got.pop("out"), want.pop("out")
    assert got == want
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# config 1: the committed record of the JAX package's runs
# ---------------------------------------------------------------------------

CONFIG1 = dict(n=10_000, d=3, graph_seed=0, replicas=32, seed=0,
               rule="majority", tie="stay")
CONFIG1_RUNS = {
    "a": dict(m_target=0.9, max_sweeps=5000, chunk_sweeps=256),
    "b": dict(m_target=1.0, max_sweeps=200, chunk_sweeps=256),
}


def config1_reference() -> dict:
    """The record of config 1 (BASELINE.md config 1: SA on a d=3 RRG,
    N=10⁴, 32 replicas, p=c=1, majority/stay, seed 0), written from the JAX
    package's ``fused_anneal(kernel="xla")`` on the CPU: each run's
    ``FusedResult``, its final state, and the digest of the state before
    the first and after every class step (from ``fused_chunk_xla`` stepped
    one class step at a time)."""
    g = jg.random_regular_graph(CONFIG1["n"], CONFIG1["d"],
                                seed=CONFIG1["graph_seed"])
    jcfg, _ = _cfgs(CONFIG1["rule"], CONFIG1["tie"])
    R, seed = CONFIG1["replicas"], CONFIG1["seed"]
    tables = jpa.build_fused_tables(g, jcfg, seed=seed)
    doc = {"config": CONFIG1, "source": "graphdyn.search.fused.fused_anneal("
           "kernel='xla'), JAX on the CPU; regenerate with "
           "tests/test_torch_fused.py --write", "runs": {}}
    for name, kw in CONFIG1_RUNS.items():
        res = jsf.fused_anneal(g, jcfg, n_replicas=R, seed=seed, kernel="xla",
                               tables=tables, **kw)
        state, tdev, static, _, _, _, _ = jsf._assemble_fused(
            g, jcfg, n_replicas=R, seed=seed, m_target=kw["m_target"],
            betas=None, tables=tables)
        initial = state_digest(interop.fused_state_from_jax(state))
        digests = []
        for _ in range(res.device_steps):
            state = jpa.fused_chunk_xla(state, jnp.uint32(seed), *tdev,
                                        chunk_steps=1, stop_on_first=False,
                                        **static)
            digests.append(state_digest(interop.fused_state_from_jax(state)))
        final = run_record(interop.fused_state_from_jax(state),
                           tables.chrom.class_sizes)
        result = result_record(res)
        assert final["steps"] == result["device_steps"]
        assert final["accepted"] == result["accepted"]
        doc["runs"][name] = {**kw, "result": result, "final_state": final,
                             "initial_digest": initial,
                             "step_digests": digests}
    return doc


def test_config1_record_regenerates_from_jax():
    with open(REF_PATH) as f:
        committed = json.load(f)
    assert json.loads(json.dumps(config1_reference())) == committed


@pytest.mark.parametrize("run", list(CONFIG1_RUNS))
def test_config1_port_holds_to_record(run):
    """The port's CPU run of config 1 against the committed record, under
    the near-tie rule (graphdyn_torch.search.reference)."""
    with open(REF_PATH) as f:
        ref = json.load(f)["runs"][run]
    kw = CONFIG1_RUNS[run]
    g = random_regular_graph(CONFIG1["n"], CONFIG1["d"],
                             seed=CONFIG1["graph_seed"])
    _, tcfg = _cfgs(CONFIG1["rule"], CONFIG1["tie"])
    R, seed = CONFIG1["replicas"], CONFIG1["seed"]
    tables = tf.build_fused_tables(g, tcfg, seed=seed)
    res = tsf.fused_anneal(g, tcfg, n_replicas=R, seed=seed, tables=tables,
                           device="cpu", **kw)
    assert res.chi == ref["final_state"]["chi"]
    assert list(np.bincount(tables.chrom.colors)) == \
        ref["final_state"]["class_sizes"]
    state0, td, static, _, _, _, _ = tsf._assemble_fused(
        g, tcfg, n_replicas=R, seed=seed, m_target=kw["m_target"], betas=None,
        tables=tables, device=CPU)

    def step(st):
        return tf.fused_chunk_plain(st, seed, td, chunk_steps=1, **static)

    verdict = hold_to_record(result_record(res), ref, step, state0, seed, td,
                             **static)
    assert verdict["how"] in ("bit-exact", "near-tie")


def test_near_tie_replay_inverts_only_near_ties(monkeypatch):
    """A recorded step that differs from the port's by one decision whose
    ``u`` sits on ``exp(−ΔE)`` (injected into the stream) passes the replay;
    a difference in a decision far from its threshold does not."""
    g = _tg(GRAPHS["rrg3"])
    _, tcfg = _cfgs()
    st, td, static, _, _, _, _ = tsf._assemble_fused(
        g, tcfg, n_replicas=32, seed=2, m_target=1.0, betas=None,
        tables=None, device=CPU)
    n, chi = static["n"], static["chi"]
    c = int(st.steps) % chi
    rows = tf._class_rows(td, c)
    end = lut_one_step(st.sp_ext, td.nbr_ext, td.lut_masks, n=n,
                       dmax=static["dmax"])
    end_all = lut_one_step(st.sp_ext ^ td.masks_ext[c][:, None], td.nbr_ext,
                           td.lut_masks, n=n, dmax=static["dmax"])
    _, u, de, _ = tf.class_decisions(st, 2, td, rows, end, end_all, n=n)
    e32 = np.exp(-de.numpy().astype(np.float64)).astype(np.float32)
    i, r = np.argwhere(e32 < 1.0)[0]
    tie_node = int(rows[i])
    stream = tf.counter_uniforms

    def injected(seed, step, n_, Rp, *, nodes=None):
        out = stream(seed, step, n_, Rp, nodes=nodes)
        hit = (nodes == tie_node).nonzero().flatten()
        out[hit, r] = float(e32[i, r])
        return out

    monkeypatch.setattr(tf, "counter_uniforms", injected)
    port = tf._fused_class_step(st, 2, td, **static)
    one = torch.zeros((rows.numel(), 32), dtype=torch.bool)
    one[i, r] = True
    near = tf._fused_class_step(st, 2, td, invert=one, **static)
    verdict = near_tie_replay(st, 2, td, state_digest(near), **static)
    assert verdict["passed"]
    assert [v[:2] for v in verdict["inverted"]] == [(tie_node, int(r))]
    assert state_digest(port) != state_digest(near)
    # a decision far from its threshold: no near tie explains it
    far = np.argwhere(np.abs(u.numpy() - e32) > 0.05)
    far = far[(far[:, 0] != i) | (far[:, 1] != r)][0]
    other = torch.zeros_like(one)
    other[tuple(far)] = True
    bad = tf._fused_class_step(st, 2, td, invert=other, **static)
    assert not near_tie_replay(st, 2, td, state_digest(bad),
                               **static)["passed"]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: JAX_PLATFORMS=cpu PYTHONPATH=. python "
                 "tests/test_torch_fused.py --write")
    with open(REF_PATH, "w") as f:
        json.dump(config1_reference(), f, indent=1)
        f.write("\n")
