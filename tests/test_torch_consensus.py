"""The port's consensus experiment against the JAX package's: seeds, the
m_half observable, the ensemble aggregation, the point statistics from the
same initial state, the document schemas, and the CLI."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from graphdyn.models import consensus as jc
from graphdyn.ops import packed as jp
from graphdyn_torch.interop import graph_from_arrays, words_from_numpy
from graphdyn_torch.models import consensus as tc
from graphdyn_torch.ops import packed as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_draw_seed_equal():
    for gs in (0, 1, 7, 123456):
        for k in range(12):
            assert tc.draw_seed(gs, k) == jc.draw_seed(gs, k)


@pytest.mark.parametrize("fractions", [
    [0.0, 0.2, 0.6, 1.0],          # crosses between the 2nd and 3rd point
    [0.5, 0.9],                    # starts at 0.5: below the grid
    [0.0, 0.1, 0.3],               # never crosses
    [0.1, 0.5],                    # lands exactly on 0.5
    [],
])
def test_m_half_equal(fractions):
    agg = [{"m0": 0.01 * j, "consensus_fraction_mean": f}
           for j, f in enumerate(fractions)]
    assert tc.m_half(agg) == jc.m_half(agg)


@pytest.mark.parametrize("graph", ["er", "rrg"])
def test_ensemble_graphs_identical(graph):
    if graph == "er":
        g_j, iso_j, nbr_j, deg_j = jc.er_consensus_ensemble(400, c=3.0, seed=2)
        g_t, iso_t, nbr_t, deg_t = tc.er_consensus_ensemble(400, c=3.0, seed=2,
                                                            device="cpu")
    else:
        g_j, iso_j, nbr_j, deg_j = jc.rrg_consensus_ensemble(200, d=4, seed=2)
        g_t, iso_t, nbr_t, deg_t = tc.rrg_consensus_ensemble(200, d=4, seed=2,
                                                             device="cpu")
    assert iso_j == iso_t
    for a, b in zip(g_j, g_t):
        np.testing.assert_array_equal(a, b)
    assert nbr_t.dtype == deg_t.dtype == torch.int32
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))
    np.testing.assert_array_equal(deg_t.numpy(), np.asarray(deg_j))


POINT_CASES = {
    "er_majority": ("er", 64, 0.05, 60, 10, "majority", "stay"),
    "er_low_bias": ("er", 96, 0.0, 40, 5, "majority", "change"),
    "rrg_pad_replicas": ("rrg", 40, 0.2, 30, 10, "minority", "change"),
}


@pytest.mark.parametrize("case", list(POINT_CASES))
def test_consensus_point_matches_jax_from_same_draw(case, monkeypatch):
    """The port's consensus_point, fed the JAX package's own initial draw
    (the two packages' generators differ), returns the JAX row exactly."""
    kind, R, m0, max_steps, chunk, rule, tie = POINT_CASES[case]
    if kind == "er":
        g, _, _, _ = jc.er_consensus_ensemble(300, c=6.0, seed=1)
    else:
        g, _, _, _ = jc.rrg_consensus_ensemble(120, d=4, seed=1)
    drawn = []

    def jax_draw(seed, n, W, m0, device=None):
        drawn.append((seed, n, W, m0))
        return words_from_numpy(np.asarray(jp.draw_packed_biased(seed, n, W, m0)))

    monkeypatch.setattr(tp, "draw_packed_biased", jax_draw)
    ref = jc.consensus_point(g, R, m0, max_steps, chunk, seed=77, rule=rule,
                             tie=tie)
    out = tc.consensus_point(graph_from_arrays(*g), R, m0, max_steps, chunk,
                             seed=77, rule=rule, tie=tie, device="cpu")
    assert drawn == [(77, g.n, -(-R // 32), m0)]
    assert out == ref


def test_consensus_curve_ensemble_aggregates_equal(monkeypatch):
    """Given the same per-point rows, the ensemble aggregation (means,
    spreads, first-passage means, None handling) is identical."""
    def fake_curve(g, R, m0_list, max_steps, chunk=10, *, graph_seed=0,
                   progress=None, **_):
        rng = np.random.default_rng(graph_seed)
        rows = []
        for m0 in m0_list:
            frac = float(rng.integers(0, R + 1)) / R
            rows.append({"m0": float(m0), "consensus_fraction": frac,
                         "mean_steps_to_consensus":
                             None if frac == 0 or m0 == 0.0 else
                             float(rng.integers(1, 20) * chunk)})
            if progress is not None:
                progress(rows[-1])
        return rows

    monkeypatch.setattr(jc, "consensus_curve", fake_curve)
    monkeypatch.setattr(tc, "consensus_curve", fake_curve)
    m0s = [0.0, 0.05, 0.1]
    for graph, seeds in (("er", (0, 1, 2)), ("rrg", (4,))):
        seen_j, seen_t = [], []
        ref = jc.consensus_curve_ensemble(
            120, 64, m0s, 20, graph=graph, graph_seeds=seeds,
            progress=lambda s, pt: seen_j.append((s, pt["m0"])))
        out = tc.consensus_curve_ensemble(
            120, 64, m0s, 20, graph=graph, graph_seeds=seeds, device="cpu",
            progress=lambda s, pt: seen_t.append((s, pt["m0"])))
        assert out == ref
        assert seen_t == seen_j and len(seen_t) == len(seeds) * len(m0s)
    with pytest.raises(ValueError, match="graph must be"):
        tc.consensus_curve_ensemble(50, 32, m0s, 10, graph="ba", device="cpu")


def _keys(doc):
    return {k: (_keys(v) if isinstance(v, dict) else None) for k, v in doc.items()}


def test_docs_equal_jax_docs():
    g, n_iso, _, _ = jc.er_consensus_ensemble(200, c=4.0, seed=0)
    rows = [{"m0": 0.1, "consensus_fraction": 0.5}]
    for kind, d in (("erdos_renyi", None), ("random_regular", 4)):
        ref = jc.consensus_doc(g, n_iso, rows, c=4.0, seed=0, kind=kind, d=d,
                               solver="consensus")
        out = tc.consensus_doc(graph_from_arrays(*g), n_iso, rows, c=4.0,
                               seed=0, kind=kind, d=d, solver="consensus",
                               device="cpu")
        assert _keys(out) == _keys(ref)
        assert out == ref       # backend: 'cpu' in both on this host
        per_seed = [{"graph_seed": 0, "n": g.n, "isolates_removed": n_iso,
                     "rows": rows}]
        ref = jc.consensus_ensemble_doc(200, per_seed, rows, c=4.0, kind=kind,
                                        d=d, elapsed_s=1.5)
        out = tc.consensus_ensemble_doc(200, per_seed, rows, c=4.0, kind=kind,
                                        d=d, elapsed_s=1.5, device="cpu")
        assert _keys(out) == _keys(ref)
        assert out == ref


def test_curve_is_deterministic_and_refuses_mesh():
    g, _, nbr, deg = tc.er_consensus_ensemble(200, c=6.0, seed=3, device="cpu")
    seen = []
    a = tc.consensus_curve(g, 32, [0.0, 0.2], 20, nbr_dev=nbr, deg_dev=deg,
                           graph_seed=3, progress=seen.append, device="cpu")
    b = tc.consensus_curve(g, 32, [0.0, 0.2], 20, graph_seed=3, device="cpu")
    assert a == b and seen == a
    assert [r["m0"] for r in a] == [0.0, 0.2]
    for fn, args in ((tc.consensus_point, (g, 32, 0.1, 10)),
                     (tc.consensus_curve, (g, 32, [0.1], 10))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(*args, mesh=object(), device="cpu")


def test_cli_consensus_prints_the_doc(tmp_path):
    out_path = tmp_path / "curve.json"
    proc = subprocess.run(
        [sys.executable, "-m", "graphdyn_torch", "consensus", "--device", "cpu",
         "--n", "500", "--replicas", "64", "--m0", "0.0", "0.3",
         "--max-steps", "40", "--out", str(out_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert json.loads(out_path.read_text()) == doc
    g, n_iso, _, _ = jc.er_consensus_ensemble(500, c=6.0, seed=0)
    ref = jc.consensus_doc(g, n_iso, doc["rows"], c=6.0, seed=0,
                           solver="consensus", kind="erdos_renyi", d=4)
    assert _keys(doc) == _keys(ref)
    assert doc["graph"] == ref["graph"] and doc["backend"] == "cpu"
    assert [r["m0"] for r in doc["rows"]] == [0.0, 0.3]
    row_keys = {"m0", "consensus_fraction", "strict_fraction",
                "mean_steps_to_consensus", "mean_abs_m_final", "max_steps",
                "step_resolution", "replicas"}
    for row in doc["rows"]:
        assert set(row) == row_keys
        assert row["replicas"] == 64 and row["max_steps"] == 40
        assert 0.0 <= row["consensus_fraction"] <= 1.0
