"""The port's HPr drivers against the JAX package's.

- Whole chains in float64 with the reference's own reinforcement draws
  injected (``uniforms=``; the helper :func:`jax_stream` replays the
  ``jax.random`` key splits of ``graphdyn/pipeline/hpr_group.py:248-251``):
  ``hpr_solve`` and the grouped executor (G=3 with a pad row) equal the JAX
  chains in ``s``, ``num_steps`` and ``m_final``, under the near-tie rule of
  :mod:`graphdyn_torch.models.hpr_reference`.
- float32: one sweep, its marginals and its reinforcement from the same
  state, at rtol 1e-5.
- Inside the port: grouped == serial bit for bit, the Threefry stream's
  layout, the batched solver's checks (``tests/test_hpr.py:70-88``), the npz
  keys, the CLI's JSON keys, and ``hpr_ref.json``.

Run this file as a script to rewrite the record:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_hpr.py --write
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.config import DynamicsConfig as jg_dyn
from graphdyn.config import HPRConfig as JCfg
from graphdyn.models import hpr as jh
from graphdyn.ops import bdcm as jb
from graphdyn.pipeline import hpr_group as jhg
from graphdyn_torch import interop
from graphdyn_torch.config import DynamicsConfig, HPRConfig
from graphdyn_torch.graphs import random_regular_graph
from graphdyn_torch.models import hpr as th
from graphdyn_torch.models import hpr_reference as tr
from graphdyn_torch.ops.dynamics import end_state
from graphdyn_torch.ops.fused import threefry2x32
from graphdyn_torch.pipeline import hpr_group as thg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PATH = os.path.join(REPO, "hpr_ref.json")
CPU = torch.device("cpu")


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


@contextlib.contextmanager
def x64():
    """float64 on the JAX side, switched back afterwards (the pattern of
    tests/test_hpr.py:465-470)."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def jax_stream(seed: int, n: int, sweeps: int, dtype) -> np.ndarray:
    """The reference chain's uniforms ``[sweeps, n]``: ``key =
    PRNGKey(seed)``, and each sweep ``key, ku = split(key)``, ``u =
    uniform(ku, (n,), dtype)``."""
    def body(k, _):
        ks = jax.random.split(k)
        return ks[0], jax.random.uniform(ks[1], (n,), dtype)

    run = jax.jit(lambda key: jax.lax.scan(body, key, None, length=sweeps)[1])
    return np.asarray(run(jax.random.PRNGKey(np.uint32(seed))))


def _tgraph(g):
    return interop.graph_from_arrays(g.nbr, g.deg, g.edges)


def _near_tie_walk(port_ex, port_st, jax_ex, jax_st, replay_ex, uniforms, TT):
    """Walk the port chain and the JAX chain sweep by sweep to their first
    difference and hold it to the near-tie rule (raises on a fault)."""
    def jfields(st):
        return (int(st.t), np.asarray(st.biases), np.asarray(st.s),
                np.asarray(st.active))

    hit = tr.walk_to_divergence(
        lambda st: port_ex.advance(st, st.t + 1),
        lambda st: jax_ex.advance(st, int(st.t) + 1),
        tr.port_fields, jfields, port_st, jax_st, TT + 2)
    assert hit is not None, "final results differ but no sweep differs"
    prev, _, jst = hit
    _, jb_, js_, _ = jfields(jst)
    return tr.near_tie_replay(replay_ex, prev, uniforms(prev.t), jb_, js_,
                              eps_dtype=np.float64)


CHAIN_CASES = [(40, 4, 3, 5), (60, 4, 1, 0), (60, 3, 2, 7)]


@pytest.mark.parametrize("n,d,gseed,seed", CHAIN_CASES)
def test_hpr_solve_chain_equals_jax_f64_injected(n, d, gseed, seed):
    """Over the full horizon (TT=3000): ``hpr_solve`` in float64 with the
    reference's draws equals ``graphdyn.models.hpr.hpr_solve(kernel='xla')``
    in ``s``, ``num_steps`` and ``m_final`` (a divergence would have to pass
    the near-tie rule)."""
    TT = 3000
    g = jg.random_regular_graph(n, d, seed=gseed)
    with x64():
        want = jh.hpr_solve(g, JCfg(dtype="float64", max_sweeps=TT), seed=seed,
                            kernel="xla")
        U = jax_stream(seed, n, TT + 2, jnp.float64)
    got = th.hpr_solve(_tgraph(g), HPRConfig(dtype="float64", max_sweeps=TT),
                       seed=seed, uniforms=lambda t: U[t][None], device=CPU)
    assert got.biases.dtype == got.chi.dtype == np.float64
    assert want.m_final == 1.0
    if not (np.array_equal(got.s, want.s) and got.num_steps == want.num_steps
            and got.m_final == want.m_final):
        # hold the first divergence to the near-tie rule (raises on a fault)
        verdict = _walk_hpr_solve(g, seed, TT, U)
        print(f"near-tie pass, to record in PERF.md and ROADMAP C: {verdict}")
        return
    assert got.num_steps >= 1 and np.float32(got.mag_reached) == want.mag_reached


def test_hpr_solve_chain_at_T5_equals_jax_f64_injected():
    """HPr at p=4, c=1 (T = 5: K = 32, M = 4^5 on the d=3 class of an
    RRG(12, 3)) in float64 with the reference's draws, 24 sweeps: the port's
    chain equals ``graphdyn.models.hpr.hpr_solve(kernel='xla')`` in ``s``,
    ``num_steps`` and ``m_final``, its biases and messages within 1e-9.
    (A T = 5 sweep of RRG(40, 4) costs ~2.4 s on one CPU thread in the
    port and ~2 s in the JAX package, so the chain is cut to a small graph
    and 24 sweeps; on the card ``chip_smoke.py`` runs the ``hpr`` CLI at
    p=4, c=1 on RRG(10^4, 4).)"""
    TT, n, seed = 24, 12, 5
    g = jg.random_regular_graph(n, 3, seed=0)
    dyn = dict(p=4, c=1)
    with x64():
        want = jh.hpr_solve(g, JCfg(dynamics=jg_dyn(**dyn), dtype="float64",
                                    max_sweeps=TT), seed=seed, kernel="xla")
        U = jax_stream(seed, n, TT + 2, jnp.float64)
    got = th.hpr_solve(_tgraph(g), HPRConfig(dynamics=DynamicsConfig(**dyn),
                                             dtype="float64", max_sweeps=TT),
                       seed=seed, uniforms=lambda t: U[t][None], device=CPU)
    np.testing.assert_array_equal(got.s, want.s)
    assert got.num_steps == want.num_steps and got.m_final == want.m_final
    np.testing.assert_allclose(got.biases, np.asarray(want.biases), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.chi, np.asarray(want.chi), rtol=0,
                               atol=1e-9)


def _walk_hpr_solve(g, seed, TT, U):
    """Both packages' G=1 executors from hpr_solve's init, walked to the
    first differing sweep and held to the near-tie rule there."""
    n = g.n
    cfg_j = JCfg(dtype="float64", max_sweeps=TT)
    cfg_t = HPRConfig(dtype="float64", max_sweeps=TT)
    gt = _tgraph(g)
    data_t = th.BDCMData(gt, dtype="float64")
    chi0, b0, s0 = thg.host_init(np.random.default_rng(seed),
                                 data_t.num_directed, data_t.K, n, np.float64)

    def uniforms(t):
        return U[t][None]

    ex_t = thg.HPRGroupExec([(gt, data_t)], cfg_t, device=CPU,
                            uniforms=uniforms)
    st_t = ex_t.init_state([chi0], [b0], [s0], [seed])
    with x64():
        data_j = jb.BDCMData(g, dtype=jnp.float64)
        ex_j = jhg.HPRGroupExec([(g, data_j)], cfg_j, kernel="xla")
        st_j = ex_j.init_state([chi0], [b0], [s0], [seed])
        return _near_tie_walk(ex_t, st_t, ex_j, st_j, ex_t, uniforms, TT)


def test_grouped_exec_with_pad_row_equals_jax_f64_injected():
    """``HPRGroupExec`` at G=3 with two members and one pad row equals the
    JAX executor at the same group shape, member by member."""
    TT, n, seeds = 3000, 60, [11, 12]
    cfg_j = JCfg(dtype="float64", max_sweeps=TT)
    cfg_t = HPRConfig(dtype="float64", max_sweeps=TT)
    with x64():
        items_j = [jhg._build_rep(n, 4, cfg_j, s, "pairing") for s in seeds]
        want = jhg.run_hpr_group(items_j, seeds, cfg_j, group_size=3,
                                 kernel="xla")
        U = np.stack([jax_stream(s, n, TT + 2, jnp.float64) for s in seeds],
                     axis=1)
    items_t = [thg._build_rep(n, 4, cfg_t, s, "pairing") for s in seeds]
    for a, b in zip(items_t, items_j):
        for x, y in zip(a[2:], b[2:]):
            np.testing.assert_array_equal(x, y)
    got = thg.run_hpr_group(items_t, seeds, cfg_t, group_size=3,
                            device=CPU, uniforms=lambda t: U[t])
    np.testing.assert_array_equal(got.s, want.s)
    np.testing.assert_array_equal(got.num_steps, want.num_steps)
    np.testing.assert_array_equal(got.m_final, want.m_final)


def test_near_tie_rule_passes_a_tie_and_refuses_a_fault():
    """The near-tie replay: a decision flipped where ``u`` equals the
    threshold passes (and is inverted back); the same flip at a node far
    from any tie is a fault."""
    g = random_regular_graph(30, 4, seed=1)
    cfg = HPRConfig(dtype="float64", max_sweeps=50)
    data = th.BDCMData(g, dtype="float64")
    ex = thg.HPRGroupExec([(g, data)], cfg, device=CPU, kernel="plain")
    chi0, b0, s0 = thg.host_init(np.random.default_rng(0), data.num_directed,
                                 data.K, 30, np.float64)
    st = ex.init_state([chi0], [b0], [s0], [3])
    thr = thg.reinforce_threshold(st.t, cfg.gamma, torch.float64)
    u = np.full((1, 30), 0.99)
    u[0, 4] = thr                           # an exact tie at node 4
    terms = ex.sweep_terms(st, torch.from_numpy(u))
    b_other = terms["biases"].numpy().copy()
    marg = terms["marg"].numpy()[0, 4]
    winner = ex.pm_minus.numpy() if marg[1] >= marg[0] else ex.pm_plus.numpy()
    b_other[0, 4] = winner                  # the other chain reinforced it
    s_other = np.where(b_other[..., 0] > b_other[..., 1], 1, -1).astype(np.int8)
    v = tr.near_tie_replay(ex, st, u, b_other, s_other, eps_dtype=np.float64)
    assert v["nodes"] == [(0, 4)] and v["u_ties"] == 1
    u_far = u.copy()
    u_far[0, 4] = 0.99                      # no tie: the same flip is a fault
    with pytest.raises(AssertionError, match="no near tie"):
        tr.near_tie_replay(ex, st, u_far, b_other, s_other,
                           eps_dtype=np.float64)


def test_first_sweep_and_reinforcement_f32_match_jax():
    """float32 from the same state: the first sweep's chi and marginals and
    the first reinforcement's biases, at rtol 1e-5."""
    n, seed = 60, 4
    cfg_j, cfg_t = JCfg(max_sweeps=10), HPRConfig(max_sweeps=10)
    item_j = jhg._build_rep(n, 4, cfg_j, seed, "pairing")
    ex_j = jhg.HPRGroupExec([item_j], cfg_j, kernel="xla")
    st_j = ex_j.init_state([item_j[2]], [item_j[3]], [item_j[4]], [seed])
    st_j1 = ex_j.advance(st_j, 1)
    U = jax_stream(seed, n, 2, jnp.float32)
    item_t = thg._build_rep(n, 4, cfg_t, seed, "pairing")
    ex_t = thg.HPRGroupExec([item_t], cfg_t, device=CPU,
                            uniforms=lambda t: U[t][None])
    st_t = ex_t.init_state([item_t[2]], [item_t[3]], [item_t[4]], [seed])
    st_t1 = ex_t.advance(st_t, 1)
    tol = dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(st_t1.chi.numpy(), np.asarray(st_j1.chi), **tol)
    m_j = jb.make_marginals(item_j[1])(st_j1.chi[0])
    m_t = ex_t.sweep_terms(st_t, torch.from_numpy(U[0][None]))["marg"][0]
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), **tol)
    np.testing.assert_allclose(st_t1.biases.numpy(), np.asarray(st_j1.biases),
                               **tol)
    np.testing.assert_array_equal(st_t1.s.numpy(), np.asarray(st_j1.s))
    assert st_t1.t == int(st_j1.t) == 1
    st_back = interop.hpr_group_state_from_jax(st_j1, [seed])
    assert torch.equal(st_back.s, st_t1.s)
    assert interop.hpr_group_state_to_numpy(st_back)["t"] == 1


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------


def test_grouped_equals_serial_bit_for_bit():
    """``hpr_ensemble`` with n_rep=5 at group sizes 0 (serial), 1, 2 and 3,
    with the port's own stream, element by element (the grouped == serial
    contract of ``graphdyn/pipeline/hpr_group.py``); prefetch on and off."""
    cfg = HPRConfig(max_sweeps=400)
    runs = {gs: th.hpr_ensemble(30, 4, cfg, n_rep=5, seed=3, group_size=gs,
                                prefetch=gs % 2 * 2, device=CPU)
            for gs in (0, 1, 2, 3)}
    base = runs[0]
    assert len(set(base.num_steps.tolist())) > 1   # chains stop apart
    for gs, out in runs.items():
        np.testing.assert_array_equal(out.conf, base.conf, err_msg=str(gs))
        np.testing.assert_array_equal(out.num_steps, base.num_steps)
        np.testing.assert_array_equal(out.mag_reached, base.mag_reached)
        np.testing.assert_array_equal(out.graphs, base.graphs)


def test_stream_layout_group_and_union_invariant():
    """The Threefry stream: key (seed, HPR_STREAM_TAG), counter (t, node);
    f32 from 24 bits, f64 from 53; the rows of a group equal the chains'
    own draws, and a batch's chain r draws hpr_solve(seed + r)'s stream."""
    seeds = torch.tensor([5, 0, 2**32 - 1], dtype=torch.int64)
    n, t0, t1 = 37, 3, 6
    for dt in (torch.float32, torch.float64):
        u = thg.hpr_uniforms(seeds, t0, t1, n, dt)
        assert u.shape == (t1 - t0, 3, n) and u.dtype == dt
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        for g in range(3):
            alone = thg.hpr_uniforms(seeds[g:g + 1], t0, t1, n, dt)
            assert torch.equal(alone[:, 0], u[:, g])
            one_t = thg.hpr_uniforms(seeds[g:g + 1], t0 + 1, t0 + 2, n, dt)
            assert torch.equal(one_t[0, 0], u[1, g])
        y0, y1 = threefry2x32(np.int64(5), thg.HPR_STREAM_TAG, np.int64(t0),
                              np.arange(n, dtype=np.int64))
        want = ((y0 >> 8) * 2.0**-24 if dt == torch.float32
                else ((y0 << 21) | (y1 >> 11)) * 2.0**-53)
        np.testing.assert_array_equal(u[0, 0].numpy(), want.astype(
            np.float32 if dt == torch.float32 else np.float64))
    # the batch keys chain r by seed + r: its rows are the lone chains'
    R, seed = 4, 9
    batch = thg.hpr_uniforms(torch.arange(seed, seed + R), 0, 2, n,
                             torch.float32)
    for r in range(R):
        lone = thg.hpr_uniforms(torch.tensor([seed + r]), 0, 2, n,
                                torch.float32)
        assert torch.equal(batch[:, r], lone[:, 0])


def test_hpr_solve_batch_chains_converge():
    """``tests/test_hpr.py:70-88`` against the port: per-chain sentinels,
    converged chains flow to all +1 under the port's ``end_state``,
    independent chains."""
    g = random_regular_graph(40, 4, seed=5)
    res = th.hpr_solve_batch(g, HPRConfig(max_sweeps=3000), n_replicas=4,
                             seed=2, device=CPU)
    assert res.s.shape == (4, 40)
    assert np.all((res.m_final == 1.0) | (res.m_final == 2.0))
    assert (res.m_final == 1.0).sum() >= 3
    for r in range(4):
        if res.m_final[r] == 1.0:
            out = end_state(g, res.s[r], 1, 1, device=CPU).numpy()
            assert np.all(out == 1)
    assert len(set(res.num_steps.tolist())) > 1
    np.testing.assert_array_equal(
        res.mag_reached, res.s.astype(np.float64).mean(axis=1).astype(np.float32))


def test_hpr_ensemble_writes_reference_npz_keys(tmp_path):
    """The npz keys of ``tests/test_hpr.py:56-67`` (`HPR:377`)."""
    p = str(tmp_path / "hpr.npz")
    out = th.hpr_ensemble(40, 4, HPRConfig(max_sweeps=2000), n_rep=2, seed=0,
                          save_path=p, device=CPU)
    assert out.conf.shape == (2, 40) and out.graphs.shape == (2, 40, 4)
    assert np.all(out.time > 0)
    with np.load(p) as saved:
        assert set(saved.files) == {"mag_reached", "conf", "num_steps",
                                    "graphs", "time"}


CLI_FORMS = {
    "default": [],
    "batch": ["--batch-replicas", "3"],
    "float64": ["--dtype", "float64"],
}


def test_cli_prints_the_reference_keys(tmp_path):
    """``python -m graphdyn_torch hpr --device cpu`` prints the JSON keys of
    ``python -m graphdyn hpr`` under the same flags, in the default,
    ``--batch-replicas`` and ``--dtype float64`` forms, and its ``--out``
    npz holds the same keys."""
    from graphdyn_torch.cli import main

    base = ["hpr", "--n", "60", "--max-sweeps", "50"]
    code = (
        "import contextlib, io, json, sys\n"
        "from graphdyn.cli import main\n"
        "out = {}\n"
        f"for name, extra in {CLI_FORMS!r}.items():\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        f"        main({base!r} + extra + ['--out', sys.argv[1] + name])\n"
        "    out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])\n"
        "print(json.dumps(out))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "j_")],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, extra in CLI_FORMS.items():
        buf = io.StringIO()
        out = str(tmp_path / f"t_{name}")
        with contextlib.redirect_stdout(buf):
            assert main(base + extra + ["--device", "cpu", "--out", out]) == 0
        doc = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert list(doc) == list(want[name]), name
        assert doc["solver"] == want[name]["solver"]
        with np.load(out + ".npz") as got, \
                np.load(str(tmp_path / f"j_{name}.npz")) as ref:
            assert sorted(got.files) == sorted(ref.files), name
    for extra, exc in ((["--checkpoint", "x"], NotImplementedError),
                       (["--batch-replicas", "2", "--device-init"],
                        NotImplementedError),
                       (["--device-init"], SystemExit)):
        with pytest.raises(exc):
            main(base + extra + ["--device", "cpu"])


def test_refused_arguments_name_the_roadmap():
    g = random_regular_graph(20, 3, seed=0)
    with pytest.raises(NotImplementedError, match="A16"):
        th.hpr_solve(g, checkpoint_path="x", device=CPU)
    with pytest.raises(NotImplementedError, match="A15"):
        th.hpr_solve_batch(g, n_replicas=2, mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="A11"):
        th.hpr_solve_batch(g, n_replicas=2, device_init=True, device=CPU)
    with pytest.raises(NotImplementedError, match="A16"):
        th.hpr_ensemble(20, 3, n_rep=2, checkpoint_path="x", device=CPU)


# ---------------------------------------------------------------------------
# the stream-free record at the reference shape
# ---------------------------------------------------------------------------


def jax_ref_record(dtype: str) -> dict:
    """The JAX package's run of the record (one dtype): RRG(10⁴, 4, seed 0),
    the default HPRConfig, hpr_solve's numpy init with seed 0, 3 sweeps of
    ``make_sweep(with_bias=True, mask_invalid_src=False)`` (XLA) with the
    initial biases held fixed, summarised after sweeps 1 and 3."""
    gp = tr.REF_GRAPH
    g = jg.random_regular_graph(gp["n"], gp["d"], seed=gp["seed"])
    js = jh._prep(g, JCfg(dtype=dtype), use_pallas=False)
    data = js.data
    chi, biases, _ = tr.ref_init(g.n, data.num_directed, data.K,
                                 np.dtype(dtype).type)
    edge_ids, node_ids = tr.ref_ids(data.num_directed, g.n)
    chi = jnp.asarray(chi)
    bias_edge = js.bias_to_edge(jnp.asarray(biases))
    out = {}
    for k in range(1, max(tr.REF_SWEEPS) + 1):
        chi = js.sweep(chi, js.lmbd, bias_edge)
        if k in tr.REF_SWEEPS:
            out[str(k)] = tr.ref_summary(np.asarray(chi),
                                         np.asarray(js.marginals(chi)),
                                         edge_ids, node_ids)
    return out


def jax_ref_doc() -> dict:
    doc = {"writer": "JAX_PLATFORMS=cpu PYTHONPATH=. python "
                     "tests/test_torch_hpr.py --write",
           "graph": tr.REF_GRAPH, "init_seed": tr.REF_INIT_SEED,
           "sweeps": list(tr.REF_SWEEPS), "config": "HPRConfig()",
           "records": {"float32": jax_ref_record("float32")}}
    with x64():
        doc["records"]["float64"] = jax_ref_record("float64")
    return doc


def _load_ref() -> dict:
    with open(REF_PATH) as f:
        return json.load(f)


def test_hpr_ref_record_regenerates_from_jax():
    assert jax_ref_doc() == _load_ref()


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-5, 1e-7),
                                             ("float64", 1e-12, 1e-15)])
def test_port_holds_to_hpr_ref_record(dtype, rtol, atol):
    want = _load_ref()["records"][dtype]
    got = tr.port_ref_record(dtype, device=CPU)
    tr.hold_to_ref_record(got, want, rtol, atol)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: JAX_PLATFORMS=cpu PYTHONPATH=. python "
                 "tests/test_torch_hpr.py --write")
    with open(REF_PATH, "w") as f:
        json.dump(jax_ref_doc(), f)
        f.write("\n")
    print(f"wrote {REF_PATH}")
