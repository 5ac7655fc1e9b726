"""The solvers' layouts in the port, the structural checks of
``tests/test_bucketed.py:100-200`` and ``tests/test_stream.py:309-354``:
``auto_layout`` routing equal to the JAX package's; ``layout='bucketed'``
equal to ``layout='padded'`` on the relabeled graph, mapped back (SA chain
and fused annealer); the refusals; ``layout='streamed'`` equal to padded
under injected streams (and to the JAX package's padded chain); the ``sa``
CLI's bucketed and streamed layouts. Spins and step counts compare bit for
bit; ``m_final`` is exact here (1.0 or the 2.0 sentinel)."""

import json

import numpy as np
import pytest

import graphdyn.graphs as jg
from graphdyn.config import DynamicsConfig as JDyn
from graphdyn.config import SAConfig as JSA
from graphdyn.models.sa import simulated_annealing as jax_sa
from graphdyn.ops.bucketed import auto_layout as jax_auto
import graphdyn_torch.graphs as tg
from graphdyn_torch.config import DynamicsConfig, SAConfig
from graphdyn_torch.models import sa as tsa
from graphdyn_torch.ops.bucketed import BUCKETED_CV_THRESHOLD, auto_layout
from graphdyn_torch.ops.lightcone import build_lightcone_tables
from graphdyn_torch.search.fused import fused_anneal


def _cfg(p=1, c=1):
    return SAConfig(dynamics=DynamicsConfig(p=p, c=c))


def _same_result(a, b):
    for f in ("s", "mag_reached", "num_steps", "m_final"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_auto_layout_routing_equals_jax():
    rrg_j, rrg_t = (jg.random_regular_graph(64, 3, seed=0),
                    tg.random_regular_graph(64, 3, seed=0))
    pl_j, pl_t = (jg.powerlaw_graph(2000, gamma=2.3, dmin=2, seed=1),
                  tg.powerlaw_graph(2000, gamma=2.3, dmin=2, seed=1))
    assert tg.degree_cv(pl_t.deg) >= BUCKETED_CV_THRESHOLD
    for g_j, g_t, want in ((rrg_j, rrg_t, "padded"),
                           (pl_j, pl_t, "bucketed")):
        assert auto_layout(g_t.deg) == jax_auto(g_j.deg) == want
    assert auto_layout(rrg_t.deg, threshold=0.0) == "bucketed"
    assert auto_layout(pl_t.deg, threshold=float("inf")) == "padded"


def test_sa_bucketed_equals_padded_on_relabeled_graph():
    g = tg.powerlaw_graph(150, gamma=2.3, dmin=2, seed=5)
    assert auto_layout(g.deg) == "bucketed"
    kw = dict(n_replicas=3, seed=0, max_steps=40, device="cpu")
    a = tsa.simulated_annealing(g, _cfg(), layout="auto", **kw)
    b = tsa.simulated_annealing(g, _cfg(), layout="bucketed", **kw)
    _same_result(a, b)
    order = tg.degree_buckets(g).order
    g_b, inv = tg.permute_nodes(g, order)
    p = tsa.simulated_annealing(g_b, _cfg(), layout="padded", **kw)
    _same_result(b, p._replace(s=p.s[..., inv]))
    # a given s0 follows the relabeling
    s0 = np.random.default_rng(2).choice(
        np.array([-1, 1], np.int8), size=(3, g.n))
    b = tsa.simulated_annealing(g, _cfg(2, 1), layout="bucketed", s0=s0, **kw)
    p = tsa.simulated_annealing(g_b, _cfg(2, 1), layout="padded",
                                s0=s0[..., order], **kw)
    _same_result(b, p._replace(s=p.s[..., inv]))
    assert set(np.unique(b.s)) <= {-1, 1}


def test_sa_layout_refusals():
    g = tg.powerlaw_graph(80, gamma=2.3, dmin=2, seed=5)
    props = np.zeros((1, 2), np.int32)
    with pytest.raises(ValueError, match="layout"):
        tsa.simulated_annealing(g, _cfg(), layout="nope", device="cpu")
    with pytest.raises(ValueError, match="proposals"):
        tsa.simulated_annealing(g, _cfg(), layout="bucketed",
                                proposals=props, uniforms=np.zeros((1, 2)),
                                max_steps=2, device="cpu")
    with pytest.raises(ValueError, match="lightcone"):
        tsa.simulated_annealing(
            g, _cfg(), layout="bucketed", rollout_mode="lightcone",
            lc_tables=build_lightcone_tables(g, 1, device="cpu"), max_steps=2,
            device="cpu")
    with pytest.raises(ValueError, match="rollout_mode='full'"):
        tsa.simulated_annealing(g, _cfg(), layout="streamed",
                                rollout_mode="lightcone", device="cpu")
    for layout in ("auto", "bucketed", "streamed"):
        with pytest.raises(NotImplementedError, match="A16"):
            tsa.simulated_annealing(g, _cfg(), layout=layout,
                                    checkpoint_path="x", device="cpu")
    with pytest.raises(ValueError, match="group_size"):
        tsa.sa_ensemble(32, 3, _cfg(), n_stat=2, layout="streamed",
                        group_size=2, device="cpu")


def _sa_setup(n=48, d=3, R=3, L=300, seed=5):
    g_j = jg.random_regular_graph(n, d, seed=seed)
    g_t = tg.random_regular_graph(n, d, seed=seed)
    rng = np.random.default_rng(seed + 1)
    s0 = (2 * rng.integers(0, 2, size=(R, n)) - 1).astype(np.int8)
    proposals = rng.integers(0, n, size=(R, L)).astype(np.int32)
    uniforms = rng.random(size=(R, L))
    return g_j, g_t, s0, proposals, uniforms


def test_sa_streamed_equals_padded_under_injected_streams():
    g_j, g_t, s0, proposals, uniforms = _sa_setup()
    kw = dict(s0=s0, proposals=proposals, uniforms=uniforms)
    r_str = tsa.simulated_annealing(g_t, _cfg(2, 1), layout="streamed",
                                    stream_chunks=3, device="cpu", **kw)
    r_pad = tsa.simulated_annealing(g_t, _cfg(2, 1), layout="padded",
                                    device="cpu", **kw)
    _same_result(r_str, r_pad)
    r_jax = jax_sa(g_j, JSA(dynamics=JDyn(p=2, c=1)), layout="padded",
                   backend="jax", **kw)
    for f in ("s", "num_steps", "m_final"):
        np.testing.assert_array_equal(getattr(r_str, f), getattr(r_jax, f))


def test_sa_ensemble_streamed_and_bucketed_equal_padded_serial():
    kw = dict(n_stat=2, seed=4, max_steps=40, device="cpu")
    r_pad = tsa.sa_ensemble(32, 3, _cfg(), layout="padded", group_size=0,
                            **kw)
    for layout in ("streamed", "bucketed"):
        r = tsa.sa_ensemble(32, 3, _cfg(), layout=layout, stream_chunks=3,
                            **kw)
        for f in ("conf", "num_steps", "m_final", "graphs", "mag_reached"):
            np.testing.assert_array_equal(getattr(r, f), getattr(r_pad, f))


def test_fused_bucketed_equals_padded_on_relabeled_graph():
    from graphdyn_torch.ops.fused import build_fused_tables

    g = tg.powerlaw_graph(90, gamma=2.3, dmin=2, seed=5)
    assert auto_layout(g.deg) == "bucketed" and g.dmax <= 63
    kw = dict(n_replicas=32, seed=0, max_sweeps=3, chunk_sweeps=2,
              device="cpu")
    a = fused_anneal(g, _cfg(), layout="auto", **kw)
    b = fused_anneal(g, _cfg(), layout="bucketed", **kw)
    np.testing.assert_array_equal(a.s, b.s)
    g_b, inv = tg.permute_nodes(g, tg.degree_buckets(g).order)
    p = fused_anneal(g_b, _cfg(), layout="padded", **kw)
    np.testing.assert_array_equal(b.s, p.s[..., inv])
    for f in ("m_end", "steps_to_target", "device_steps", "accepted"):
        np.testing.assert_array_equal(getattr(b, f), getattr(p, f))
    tables = build_fused_tables(g, _cfg())
    with pytest.raises(ValueError, match="tables"):
        fused_anneal(g, _cfg(), layout="bucketed", tables=tables, **kw)
    # prebuilt tables pin the caller's labeling: auto stays padded
    q = fused_anneal(g, _cfg(), layout="auto", tables=tables, **kw)
    r = fused_anneal(g, _cfg(), layout="padded", **kw)
    np.testing.assert_array_equal(q.s, r.s)


@pytest.mark.parametrize("layout", ["bucketed", "streamed"])
def test_sa_cli_layouts_equal_padded(layout, capsys):
    from graphdyn_torch.cli import main

    argv = ["sa", "--n", "30", "--d", "3", "--n-stat", "2", "--max-steps",
            "30", "--device", "cpu"]
    main(argv + ["--layout", "padded", "--group-size", "0"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(argv + ["--layout", layout, "--stream-chunks", "2"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
