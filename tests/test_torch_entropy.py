"""The port's BDCM entropy λ-ladders against the JAX package's: the leaf
setter, the edge and node partition functions, φ and m_init on the same
tables and messages; one masked sweep; whole curves in float64 (against the
JAX package's XLA path) and float32; the golden instance and the reduced
config-4 union of the record ``entropy_ref.json``; the ``entropy`` CLI.
``tests/test_torch_entropy_group.py`` holds the grouped grid, the unions,
the congruent ensemble and the exits.

Tolerances, each with its reason:

- one evaluation (partitions, φ, m_init, one sweep): float64 rtol 1e-12,
  float32 rtol 1e-5 (atol 1e-15 / 1e-7): the port sums in another order and
  its sweep multiplies by 1/z where XLA divides;
- whole float64 curves: φ, m_init and ent1 within 1e-9, sweep counts equal
  except at a near tie (``graphdyn_torch.models.entropy_reference``): a
  fixed point iterated ~150 times keeps the rounding difference near 1e-13;
- whole float32 curves: within 1e-4 and sweep counts within 2 — the f32
  delta itself carries a rounding error of about 1% of eps, so a fixed
  point may stop a sweep earlier or later.

Run this file as a script to rewrite the record:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_entropy.py --write
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from graphdyn import cli as jcli
from graphdyn import graphs as jg
from graphdyn.config import DynamicsConfig as JDyn
from graphdyn.config import EntropyConfig as JCfg
from graphdyn.models import entropy as jem
from graphdyn.ops import bdcm as jb
from graphdyn.pipeline import entropy_group as jeg
from graphdyn_torch import cli as tcli
from graphdyn_torch import interop
from graphdyn_torch.config import DynamicsConfig, EntropyConfig
from graphdyn_torch.graphs import graph_from_edges
from graphdyn_torch.models import entropy as tem
from graphdyn_torch.models import entropy_reference as er
from graphdyn_torch.ops import bdcm as tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PATH = os.path.join(REPO, "entropy_ref.json")
CPU = torch.device("cpu")
TOL = {"float32": dict(rtol=1e-5, atol=1e-7),
       "float64": dict(rtol=1e-12, atol=1e-15)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the tensors are small and the
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def x64():
    """float64 on the JAX side, switched back afterwards."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _x64_if(dtype):
    return x64() if dtype == "float64" else contextlib.nullcontext()


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **TOL[dtype])


def _pcfg(**kw):
    dyn = kw.pop("dynamics", None)
    return EntropyConfig(**kw, **({"dynamics": DynamicsConfig(**dyn)}
                                  if dyn else {}))


def _jcfg(**kw):
    dyn = kw.pop("dynamics", None)
    return JCfg(**kw, **({"dynamics": JDyn(**dyn)} if dyn else {}))


# ---------------------------------------------------------------------------
# the JAX package's curves, with the final delta of each λ
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _jax_deltas():
    """Record the final delta of every fixed point the JAX package's
    ladders run (the cell executor's and the union's)."""
    deltas = []
    fp1 = jeg.EntropyCellExec.fixed_point1
    make_fp = jem.make_fixed_point

    def fixed_point1(self, chi, lmbd):
        out = fp1(self, chi, lmbd)
        deltas.append(float(out[2]))
        return out

    def make_fixed_point(data, config):
        fp = make_fp(data, config)

        def wrapped(chi, lmbd):
            out = fp(chi, lmbd)
            deltas.append(float(out[2]))
            return out

        return wrapped

    jeg.EntropyCellExec.fixed_point1 = fixed_point1
    jem.make_fixed_point = make_fixed_point
    try:
        yield deltas
    finally:
        jeg.EntropyCellExec.fixed_point1 = fp1
        jem.make_fixed_point = make_fp


def jax_curve(run) -> dict:
    """``run()`` (a JAX-package ladder) as a record curve with deltas."""
    with _jax_deltas() as deltas:
        res = run()
    return er.curve_record(res, deltas)


def jax_golden_graph():
    g = jg.erdos_renyi_graph(1000, 1.0 / 999, seed=9425, method="networkx")
    assert int((g.deg == 0).sum()) == 370 and g.edges.shape[0] == 485
    return g


def jax_ref_doc() -> dict:
    """The record: the golden instance and its float64 curve, and the
    reduced config-4 union in float32 and float64 (the module docstring of
    ``graphdyn_torch.models.entropy_reference``)."""
    g = jax_golden_graph()
    gold_cfg = _jcfg(lmbd_max=0.9, lmbd_step=0.1, dtype="float64")
    with x64():
        gold = jax_curve(lambda: jem.entropy_sweep(g, gold_cfg,
                                                   seed=er.GOLDEN_SEED))
    union = {}
    graphs = er.union_graphs(jg.erdos_renyi_graph)
    for dtype in ("float32", "float64"):
        cfg = _jcfg(max_sweeps=er.UNION_SHAPE["max_sweeps"], dtype=dtype)
        with _x64_if(dtype):
            union[dtype] = jax_curve(lambda cfg=cfg: jem.entropy_ensemble_union(
                graphs, cfg, seed=er.UNION_SHAPE["seed"],
                lambdas=er.union_lambdas()))
    return {
        "writer": "JAX_PLATFORMS=cpu PYTHONPATH=. python "
                  "tests/test_torch_entropy.py --write",
        "golden": {"source": "erdos_renyi_graph(1000, 1/999, seed=9425, "
                             "method='networkx'); EntropyConfig(lmbd_max=0.9,"
                             " lmbd_step=0.1, dtype='float64'), seed 0",
                   "n": int(g.n), "edges": g.edges.astype(int).tolist(),
                   "float64": gold},
        "union": {"source": "entropy_ensemble_union(4 x erdos_renyi_graph("
                            "300, 1.5/299, seed=k), EntropyConfig(max_sweeps="
                            "400), seed=0, lambdas=linspace(0, 3.1, 8))",
                  **union},
    }


def _load_ref() -> dict:
    with open(REF_PATH) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# observables and one sweep on the same tables
# ---------------------------------------------------------------------------


def _datas(T, dtype, bucket=None, n=60, c=2.0, seed=1):
    """A JAX ER graph with isolates, its isolate-free core's BDCMData in both
    packages, and (n_total, n_iso)."""
    g = jg.erdos_renyi_graph(n, c / (n - 1), seed=seed)
    assert (g.deg == 0).any()
    sub, n_iso = jg.remove_isolates(g)
    jd = jb.BDCMData(sub, p=T - 1, c=1, class_bucket=bucket, dtype=dtype)
    return jd, interop.bdcm_data_from_jax(jd), g.n, n_iso


@pytest.mark.parametrize("bucket", [None, 16])
@pytest.mark.parametrize("T", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_leaves_partitions_phi_minit_match_jax(dtype, T, bucket):
    lmbd = 0.3
    with _x64_if(dtype):
        jd, pd, n_total, n_iso = _datas(T, dtype, bucket)
        chi = np.asarray(jd.init_messages(4))
        lm = jax.numpy.asarray(lmbd, jd.dtype)
        want = {
            "leaves": jb.make_leaf_setter(jd)(chi, lm),
            "zij": jb.make_edge_partition(jd)(chi),
            "zi": jb.make_node_partition(jd)(chi, lm),
            "phi": jb.make_free_entropy(jd, n_total=n_total,
                                        n_iso=n_iso)(chi, lm),
            "terms": jb.make_m_init_edge_terms(jd)(chi),
            "m_init": jb.make_mean_m_init(jd, n_total=n_total,
                                          n_iso=n_iso)(chi),
        }
    c = interop.chi_from_jax(chi)
    got = {
        "leaves": tb.make_leaf_setter(pd, device=CPU)(c, lmbd),
        "zij": tb.make_edge_partition(pd, device=CPU)(c),
        "zi": tb.make_node_partition(pd, device=CPU)(c, lmbd),
        "phi": tb.make_free_entropy(pd, n_total=n_total, n_iso=n_iso,
                                    device=CPU)(c, lmbd),
        "terms": tb.make_m_init_edge_terms(pd, device=CPU)(c),
        "m_init": tb.make_mean_m_init(pd, n_total=n_total, n_iso=n_iso,
                                      device=CPU)(c),
    }
    assert pd.leaf_idx.size > 0
    for k in want:
        assert got[k].dtype == c.dtype, k
        _close(interop.chi_to_numpy(got[k]), want[k], dtype)


def test_empty_attractor_set_gives_minus_inf_not_nan():
    """Minority dynamics with a c=1 homogeneous endpoint has no valid
    configuration: φ = −inf and ent1 = −inf with a finite m_init (no NaN),
    in both packages."""
    gj = jg.remove_isolates(jg.erdos_renyi_graph(80, 1.2 / 79, seed=2))[0]
    gt = interop.graph_from_arrays(gj.nbr, gj.deg, gj.edges)
    dyn = dict(p=1, c=1, rule="minority", attr_value=-1)
    lambdas = np.array([0.0])
    want = jem.entropy_sweep(gj, _jcfg(dynamics=dyn), seed=0, lambdas=lambdas)
    got = tem.entropy_sweep(gt, _pcfg(dynamics=dyn), seed=0, lambdas=lambdas,
                            device=CPU)
    for r in (want, got):
        assert np.isneginf(r.ent[-1]) and np.isneginf(r.ent1[-1])
        assert np.isfinite(r.m_init[-1])
    assert got.sweeps.tolist() == want.sweeps.tolist()


@pytest.mark.parametrize("T", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_masked_sweep_matches_jax(dtype, T):
    """One entropy sweep (invalid sources masked, padded classes) against
    the JAX package's XLA sweep on the same tables and chi."""
    lmbd = 0.4
    with _x64_if(dtype):
        jd, pd, _, _ = _datas(T, dtype, bucket=16)
        chi = np.asarray(jd.init_messages(7))
        want = jb.make_sweep(jd, damp=0.1, mask_invalid_src=True,
                             use_pallas=False)(
            chi, jax.numpy.asarray(lmbd, jd.dtype))
    sweep = tb.make_sweep(pd, damp=0.1, mask_invalid_src=True, device=CPU)
    got = sweep(interop.chi_from_jax(chi), lmbd)
    _close(interop.chi_to_numpy(got), want, dtype)
    fp = tb.make_fixed_point(pd, _pcfg(dtype=dtype, max_sweeps=1), device=CPU)
    one, t, _ = fp(interop.chi_from_jax(chi), lmbd)
    assert t == 1 and torch.equal(one, got)


# ---------------------------------------------------------------------------
# whole curves
# ---------------------------------------------------------------------------


def _port_curve(run) -> dict:
    return er.curve_record(run())


def test_f64_curve_matches_jax_xla():
    g = jg.erdos_renyi_graph(80, 1.5 / 79, seed=5)
    cfg = dict(lmbd_max=0.6, lmbd_step=0.2, dtype="float64")
    with x64():
        want = jax_curve(lambda: jem.entropy_sweep(g, _jcfg(**cfg), seed=5,
                                                   kernel="xla"))
    gp = interop.graph_from_arrays(g.nbr, g.deg, g.edges)
    got = _port_curve(lambda: tem.entropy_sweep(gp, _pcfg(**cfg), seed=5,
                                                device=CPU))
    v = er.hold_curve(got, want, atol=1e-9, eps=1e-6)
    assert v["near_tie"] is None and v["rows"] == 4


def test_f32_curve_matches_jax():
    g = jg.erdos_renyi_graph(80, 1.5 / 79, seed=5)
    cfg = dict(lmbd_max=0.6, lmbd_step=0.2)
    want = jax_curve(lambda: jem.entropy_sweep(g, _jcfg(**cfg), seed=5,
                                               class_bucket=16))
    gp = interop.graph_from_arrays(g.nbr, g.deg, g.edges)
    got = _port_curve(lambda: tem.entropy_sweep(gp, _pcfg(**cfg), seed=5,
                                                class_bucket=16, device=CPU))
    assert got["lambdas"] == want["lambdas"]
    assert np.all(np.abs(np.subtract(got["sweeps"], want["sweeps"])) <= 2)
    for f in er.CURVE_FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-4)


def test_golden_instance_against_triples_and_record():
    """The seed-9425 networkx instance, built by the JAX package and passed
    to the port as edges (the record holds the same edges): within 5e-3 of
    the ten notebook triples, and within the float64 bound of the JAX
    package's curve."""
    ref = _load_ref()
    g = jax_golden_graph()
    assert ref["golden"]["n"] == g.n
    assert np.array_equal(np.asarray(ref["golden"]["edges"]), g.edges)
    gp = graph_from_edges(g.n, g.edges)
    res = tem.entropy_sweep(gp, er.golden_config(), seed=er.GOLDEN_SEED,
                            device=CPU)
    assert res.chi.dtype == np.float64
    assert er.hold_golden_triples(res) <= er.GOLDEN_TOL
    v = er.hold_curve(er.curve_record(res), ref["golden"]["float64"],
                      atol=1e-9, eps=1e-6)
    assert v["rows"] == 10
    assert np.all((res.sweeps >= 100) & (res.sweeps <= 200))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("float64", 1e-9)])
def test_reduced_config4_union_holds_to_record(dtype, atol):
    want = _load_ref()["union"][dtype]
    res = tem.entropy_ensemble_union(er.union_graphs(), er.union_config(dtype),
                                     seed=er.UNION_SHAPE["seed"],
                                     lambdas=er.union_lambdas(), device=CPU)
    got = er.curve_record(res)
    if dtype == "float64":
        er.hold_curve(got, want, atol=atol, eps=1e-6)
    else:
        assert got["lambdas"] == want["lambdas"]
        assert got["nonconverged"] == want["nonconverged"]
        assert np.all(np.abs(np.subtract(got["sweeps"], want["sweeps"])) <= 2)
        for f in er.CURVE_FIELDS:
            np.testing.assert_allclose(got[f], want[f], rtol=0, atol=atol)


def test_entropy_ref_record_matches_the_jax_graphs():
    """The record's inputs are the JAX package's: the union members are the
    same numpy samples in both packages."""
    for gj, gt in zip(er.union_graphs(jg.erdos_renyi_graph), er.union_graphs()):
        assert np.array_equal(gj.edges, gt.edges)
        assert np.array_equal(gj.nbr, gt.nbr)
    ref = _load_ref()
    assert ref["writer"].endswith("tests/test_torch_entropy.py --write")
    for curve in (ref["golden"]["float64"], ref["union"]["float32"],
                  ref["union"]["float64"]):
        assert len(curve["delta"]) == len(curve["lambdas"])


# ---------------------------------------------------------------------------
# the entropy CLI
# ---------------------------------------------------------------------------


def _run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc in (0, None)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [[], ["--union", "2"]],
                         ids=["grid", "union"])
def test_entropy_cli_keys_match_jax(extra, tmp_path):
    argv = ["entropy", "--n", "30", "--deg", "1.2", "1.6", "--num-rep", "1",
            "--lmbd-max", "0.1", *extra]
    jout, tout = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    want = _run_cli(jcli.main, argv + ["--out", jout])
    got = _run_cli(tcli.main, argv + ["--device", "cpu", "--out", tout])
    assert set(got) == set(want)
    assert got["solver"] == want["solver"]
    for k in ("counts", "nonconverged", "deg", "members", "plot"):
        assert got.get(k) == want.get(k), k
    first = got["ent1_first_lambda"]
    np.testing.assert_allclose(
        np.asarray(list(first.values()) if extra else first, float),
        np.asarray(list(want["ent1_first_lambda"].values()) if extra
                   else want["ent1_first_lambda"], float), atol=1e-4)
    with np.load(jout) as fj, np.load(tout) as ft:
        assert set(fj.files) == set(ft.files)


def test_entropy_cli_refuses_unported_flags(tmp_path, capsys, monkeypatch):
    # --plot draws since the telemetry slice (the figures are held to the
    # JAX package's by tests/test_torch_plotting.py); without matplotlib it
    # is refused before the run, as the JAX package refuses it
    import importlib.util

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a:
                        None if name == "matplotlib" else find_spec(name, *a))
    with pytest.raises(SystemExit, match="requires matplotlib"):
        tcli.main(["entropy", "--n", "20", "--device", "cpu", "--plot",
                   str(tmp_path / "x.png")])
    monkeypatch.undo()
    # --checkpoint runs since the durability slice (its resume is held by
    # tests/test_torch_resume.py); a finished run removes its snapshot
    ck = str(tmp_path / "ck")
    assert tcli.main(["entropy", "--n", "20", "--device", "cpu", "--deg",
                      "1.5", "--num-rep", "1", "--lmbd-max", "0.2",
                      "--checkpoint", ck]) == 0
    capsys.readouterr()
    assert not os.path.exists(ck + ".npz")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: JAX_PLATFORMS=cpu PYTHONPATH=. python "
                 "tests/test_torch_entropy.py --write")
    with open(REF_PATH, "w") as f:
        json.dump(jax_ref_doc(), f)
        f.write("\n")
