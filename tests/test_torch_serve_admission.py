"""The port's admission and bucketing (``graphdyn_torch.serve.admission``,
``graphdyn_torch.serve.bucketing``) against the JAX package's
(``graphdyn.serve``): equal decisions, reasons, model bytes and budgets
under a pinned ``GRAPHDYN_SERVE_HBM_BUDGET`` over fused, bucketed,
streamed, sharded, malformed and oversized specs and the ``serve.admit``
reject storm, with the two stated differences (the JAX package's ``'xla'``
label is the port's ``'auto'``: K4′ has no VMEM budget; a bucketed job is
priced at what the port's rollout holds); the budget on the
card and on the CPU; equal graph and shape keys, hit and miss counts,
eviction order, warm-up classes, and fused tables seeded by the graph."""

import numpy as np
import pytest
import torch

import jax

from graphdyn.graphs import powerlaw_graph as j_powerlaw
from graphdyn.ops import pallas_anneal as jpa
from graphdyn.resilience import faults as jfaults
from graphdyn.serve import admission as jadm
from graphdyn.serve import bucketing as jbkt
from graphdyn.serve.spool import normalize_spec
from graphdyn_torch.obs import memband
from graphdyn_torch.resilience import faults as tfaults
from graphdyn_torch.serve import admission as tadm
from graphdyn_torch.serve import bucketing as tbkt

import torch_serve

SMALL = torch_serve.SMALL
N_DEV = len(jax.devices())       # the JAX side's host devices (tests: 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def budget(monkeypatch):
    monkeypatch.setenv("GRAPHDYN_SERVE_HBM_BUDGET", str(torch_serve.BUDGET))
    return torch_serve.BUDGET


def _pl_shape(n=512):
    g = j_powerlaw(n, gamma=2.5, dmin=2, seed=0)
    return {"n": n, "d": 2, "gamma": 2.5, "edges": int(g.edges.shape[0]),
            "dmax": int(g.deg.max()), "replicas": 32, "max_sweeps": 4}


SPECS = {
    "fused_small": dict(SMALL),
    "fused_declared": {**SMALL, "edges": 36, "degree_cv": 2.0},
    "fused_xla_label": {"n": 1000, "d": 3, "replicas": 512},
    "fused_mid": {"n": 20000, "d": 3, "replicas": 512},
    "fused_oversized": {"n": 200000, "d": 3, "replicas": 4096},
    "fused_dense_oversized": {"n": 50_000, "d": 900, "replicas": 64},
    "fused_dense_declared": {"n": 50_000, "d": 900, "replicas": 64,
                             "edges": 120_000, "degree_cv": 3.2},
    "n1": {"n": 1, "d": 3}, "d0": {"n": 24, "d": 0}, "d_eq_n": {"n": 4, "d": 4},
    "r0": {**SMALL, "replicas": 0},
    "bucketed": {"solver": "bucketed", "n": 50_000, "d": 2, "replicas": 64,
                 "edges": 120_000},
    "bucketed_no_edges": {"solver": "bucketed", "n": 24, "d": 2},
    "bucketed_neg_edges": {"solver": "bucketed", "n": 24, "d": 2,
                           "edges": -5},
    "bucketed_too_many": {"solver": "bucketed", "n": 24, "d": 2,
                          "edges": 10_000},
    "bucketed_oversized": {"solver": "bucketed", "n": 10**7, "d": 2,
                           "replicas": 4096, "edges": 10**8},
    "streamed": {**_pl_shape(), "solver": "streamed"},
    "streamed_no_dmax": {**_pl_shape(), "solver": "streamed", "dmax": None},
    "streamed_bad_dmax": {**_pl_shape(), "solver": "streamed", "dmax": 9999},
    "streamed_shards2": {**_pl_shape(), "solver": "streamed", "shards": 2},
    "streamed_shards0": {**_pl_shape(), "solver": "streamed", "shards": 0},
    "streamed_shards_str": {**_pl_shape(), "solver": "streamed",
                            "shards": "many"},
    "streamed_shards99": {**_pl_shape(), "solver": "streamed", "shards": 99},
    "streamed_huge_hub": {"solver": "streamed", "n": 10**9, "d": 2,
                          "edges": 10**9, "dmax": 10**9 - 1,
                          "replicas": 2**20},
    "unknown_solver": {**SMALL, "solver": "bdcm"},
}


def _xla_to_auto(kernel: str) -> str:
    return "auto" if kernel == "xla" else kernel


def _as_the_port_decides(spec: dict, want):
    """The JAX package's decision with the port's two differences: its
    ``'xla'`` label is ``'auto'``, and a priced bucketed job costs what the
    port's rollout holds (``memband.bucketed_job_bytes``, above the JAX
    package's one resident copy), its refusal reason naming that price."""
    want = want._replace(kernel=_xla_to_auto(want.kernel))
    if spec.get("solver") != "bucketed" or not want.model_bytes:
        return want
    W = -(-int(spec["replicas"]) // 32)
    price = memband.bucketed_job_bytes(int(spec["n"]), W, int(spec["edges"]))
    assert price > want.model_bytes
    if want.admitted:
        assert price <= want.budget_bytes    # no shape here crosses it
        return want._replace(model_bytes=price)
    return want._replace(model_bytes=price, reason=want.reason.replace(
        f"{want.model_bytes} B", f"{price} B"))


@pytest.mark.parametrize("name", list(SPECS))
def test_admit_equal_under_pinned_budget(name, budget):
    spec = normalize_spec(SPECS[name])
    want = jadm.admit(spec)
    got = tadm.admit(spec, device="cpu", n_devices=N_DEV)
    assert got == _as_the_port_decides(spec, want)
    assert got.budget_bytes == budget
    if not got.admitted:
        assert got.reason and (got.model_bytes == 0
                               or str(got.model_bytes) in got.reason)


def test_xla_label_admitted_on_k4_and_fused_price_is_the_formula(budget):
    """Where the JAX package labels a fused job 'xla' (its formula past the
    10 MiB VMEM budget), the port admits it with kernel='auto' (K4′ works
    from global memory); the price is the same formula."""
    spec = normalize_spec(SPECS["fused_xla_label"])
    want, got = jadm.admit(spec), tadm.admit(spec, device="cpu")
    assert want.kernel == "xla" and got.kernel == "auto"
    assert jpa.FUSED_VMEM_BUDGET < got.model_bytes <= budget
    assert not hasattr(tadm, "FUSED_VMEM_BUDGET")


@pytest.mark.parametrize("n", [2, 24, 999, 10**4, 10**7])
@pytest.mark.parametrize("W", [1, 2, 16, 128])
@pytest.mark.parametrize("dmax", [1, 3, 4, 17, 900])
def test_fused_model_bytes_is_the_jax_formula(n, W, dmax):
    chi = tadm.chi_bound(dmax)
    assert chi == jadm.chi_bound(dmax)
    assert memband.fused_model_bytes(n, W, chi, dmax) == \
        jpa.fused_vmem_bytes(n, W, chi, dmax)


def test_oversized_refusal_at_config1_width_names_both_numbers():
    """The fused job ``chip_smoke.py`` refuses on the card: n = 10⁷ with
    4096 replicas prices at about 1.0 TB."""
    d = tadm.admit(normalize_spec({"n": 10**7, "d": 3, "replicas": 4096}),
                   device="cpu")
    assert not d.admitted and 1.0e12 < d.model_bytes < 1.1e12
    assert f"{d.model_bytes} B" in d.reason and f"{d.budget_bytes} B" in \
        d.reason


def test_reject_storm_equal():
    spec = normalize_spec(dict(SMALL))
    outs = {}
    for name, adm, fmod in (("jax", jadm.admit, jfaults),
                            ("port", lambda s: tadm.admit(s, device="cpu"),
                             tfaults)):
        with fmod.FaultPlan([fmod.FaultSpec("serve.admit", action="raise",
                                            at=1, count=2)]):
            outs[name] = [adm(spec), adm(spec)]
        outs[name].append(adm(spec))
    assert [d.admitted for d in outs["port"]] == [False, False, True]
    assert outs["port"] == [d._replace(kernel=_xla_to_auto(d.kernel))
                            for d in outs["jax"]]
    assert "injected reject storm" in outs["port"][0].reason


def test_budget_env_cpu_default_and_card(monkeypatch):
    monkeypatch.delenv("GRAPHDYN_SERVE_HBM_BUDGET", raising=False)
    assert tadm.device_budget_bytes("cpu") == tadm.DEFAULT_HBM_BUDGET \
        == jadm.DEFAULT_HBM_BUDGET
    for bad in ("", "abc", "-5", "0"):
        monkeypatch.setenv("GRAPHDYN_SERVE_HBM_BUDGET", bad)
        assert tadm.device_budget_bytes("cpu") == tadm.DEFAULT_HBM_BUDGET
    monkeypatch.setenv("GRAPHDYN_SERVE_HBM_BUDGET", "12345")
    assert tadm.device_budget_bytes("cpu") == 12345 == \
        jadm.device_budget_bytes()
    assert not tadm.admit(normalize_spec(dict(SMALL)), device="cpu").admitted
    # on the card: the card's total memory, and a failed read raises
    monkeypatch.delenv("GRAPHDYN_SERVE_HBM_BUDGET")
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (7 << 30, 80 << 30))
    assert tadm.device_budget_bytes("cuda:0") == 80 << 30

    def broken(dev=None):
        raise RuntimeError("CUDA error: no device")

    monkeypatch.setattr(torch.cuda, "mem_get_info", broken)
    with pytest.raises(RuntimeError, match="no device"):
        tadm.device_budget_bytes("cuda:0")
    with pytest.raises(RuntimeError, match="no device"):
        tadm.admit(normalize_spec(dict(SMALL)), device="cuda:0")


def test_device_count_on_cpu_and_card(monkeypatch):
    assert tadm.device_count("cpu") == 1
    assert tadm.device_count("cpu", 4) == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tadm.device_count("cuda:0", 4) == 1
    spec = normalize_spec(SPECS["streamed_shards2"])
    d = tadm.admit(spec, device="cpu")
    assert not d.admitted and "devices" in d.reason
    assert tadm.admit(spec, device="cpu", n_devices=2).admitted


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [k for k in SPECS
                                  if "bad" not in k and k not in (
                                      "n1", "d0", "d_eq_n", "r0")])
def test_graph_and_shape_keys_equal(name):
    spec = normalize_spec(SPECS[name])
    assert tbkt.graph_key(spec) == jbkt.graph_key(spec)
    assert tbkt.shape_key(spec) == jbkt.shape_key(spec)


def test_shape_key_packs_replicas_and_drops_seeds():
    a = normalize_spec({**SMALL, "replicas": 1, "seed": 1, "graph_seed": 7})
    b = normalize_spec({**SMALL, "replicas": 32, "seed": 2, "graph_seed": 9})
    c = normalize_spec({**SMALL, "replicas": 33})
    assert tbkt.shape_key(a) == tbkt.shape_key(b) != tbkt.shape_key(c)
    assert tbkt.graph_key(a) != tbkt.graph_key(b)


def test_cache_hits_misses_and_eviction_order_equal():
    specs = [normalize_spec({**SMALL, "graph_seed": g})
             for g in (0, 0, 1, 2, 0, 2, 1, 1)]
    tc, jc = tbkt.BucketCache(max_graphs=2), jbkt.BucketCache(max_graphs=2)
    got = [tc.tables_for(s) for s in specs]
    want = [jc.tables_for(s) for s in specs]
    assert tc.stats() == jc.stats()
    assert tc.stats() == {"hits": 3, "misses": 5, "hit_rate": 0.375,
                          "resident_graphs": 2}
    assert list(tc._graphs) == list(jc._graphs)
    # a hit is reuse, a rebuilt entry after eviction is a new object
    assert got[1] is got[0] and got[4] is not got[0]
    for (g, t), (jg, jt) in zip(got, want):
        np.testing.assert_array_equal(g.nbr, np.asarray(jg.nbr))
        np.testing.assert_array_equal(t.masks_ext, np.asarray(jt.masks_ext))


@pytest.mark.parametrize("graph_seed", [0, 3])
def test_fused_tables_seeded_by_the_graph_equal(graph_seed):
    spec = normalize_spec({**SMALL, "graph_seed": graph_seed, "seed": 11,
                           "rule": "minority", "tie": "change"})
    g, t = tbkt.BucketCache().tables_for(spec)
    jg, jt = jbkt.BucketCache().tables_for(spec)
    np.testing.assert_array_equal(g.edges, np.asarray(jg.edges))
    assert t.chi == jt.chi
    for f in ("masks_ext", "lut_masks", "fac_a", "fac_b"):
        np.testing.assert_array_equal(getattr(t, f),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    np.testing.assert_array_equal(t.chrom.colors, np.asarray(jt.chrom.colors))


@pytest.mark.parametrize("solver", ["bucketed", "streamed"])
def test_powerlaw_tables_equal(solver):
    spec = normalize_spec({"solver": solver, "n": 96, "d": 2, "gamma": 2.3,
                           "graph_seed": 5})
    g, b = tbkt.BucketCache().tables_for(spec)
    jg, jb = jbkt.BucketCache().tables_for(spec)
    np.testing.assert_array_equal(g.edges, np.asarray(jg.edges))
    if solver == "streamed":
        assert b is None and jb is None
        return
    assert b.widths == jb.widths and b.table_entries == jb.table_entries
    for x, y in zip(b.nbr, jb.nbr):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_warm_probes_the_hot_classes_alike():
    specs = [normalize_spec({**SMALL, "seed": i}) for i in range(3)]
    specs.append(normalize_spec({**SMALL, "n": 30, "seed": 9}))
    specs.append(normalize_spec({"solver": "bucketed", "n": 24, "d": 2,
                                 "edges": 40}))
    tc, jc = tbkt.BucketCache(), jbkt.BucketCache()
    got = tc.warm(specs, top_k=1, device="cpu")
    assert got == jc.warm(specs, top_k=1) == [tbkt.shape_key(specs[0])]
    assert tc.stats() == jc.stats() == {"hits": 0, "misses": 1,
                                        "hit_rate": 0.0,
                                        "resident_graphs": 1}
    assert tc.warm(specs, top_k=2, device="cpu") == jc.warm(specs, top_k=2)
    assert tc.stats() == jc.stats()
