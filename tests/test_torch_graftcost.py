"""The port's resident-peak cost models (``graphdyn_torch.analysis.
graftcost``), on the CPU: the affine fits and scaling exponents equal the
JAX package's on the same samples; the hand models (the serve admission
prices and the memband models) recompute on the CPU from the ledger's
calibration jobs as pure functions, equal to what admission decides; the
ledger logic fires GB102 (a drifted hand model, an admission price below
the derived peak or below the allocator's peak, a memband model out of
its band), GB101 (a serve outside its sample's range), GB103 (a missing
row) and GB104 (a departed exponent or residual) on planted ledgers; and
the committed ledger, measured on the card, reproduces its blessed
hand-model ratios and holds every price above what the card held."""

import copy
import statistics

import pytest
import torch

from graphdyn.analysis import graftcost as jcost
from graphdyn_torch.analysis import graftcost as gc
from graphdyn_torch.obs import memband
from graphdyn_torch.serve import admission


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


SAMPLES = [
    ([128, 256, 512], [1000.0, 1900.0, 3800.0]),
    ([32, 48, 64], [5.0, 5.0, 5.0]),
    ([10, 20, 40], [0.0, 3.0, 9.0]),
    ([5000, 10000, 20000], [4.1e6, 8.12e6, 1.61e7]),
]


@pytest.mark.parametrize("k", range(len(SAMPLES)))
def test_fits_equal_the_jax_package(k):
    xs, ys = SAMPLES[k]
    assert gc._fit_affine(xs, ys) == jcost._fit_affine(xs, ys)
    assert gc._scaling_exponent(xs, ys) == jcost._scaling_exponent(xs, ys)
    assert gc.EXPONENT_TOL == jcost.EXPONENT_TOL


@pytest.fixture(scope="module")
def jobs():
    return {name: {str(n): gc.calibration_job(name, n) for n in spec.points}
            for name, spec in gc.COST_ENTRIES.items()}


def _ledger(jobs, frac=0.5, power=1.0):
    """A ledger whose peaks are ``frac`` of each job's admission price
    (scaled to ``(n / n0) ** power``)."""
    live = {}
    for name, by_n in jobs.items():
        n0 = gc.COST_ENTRIES[name].points[0]
        p0 = gc._admission_price(by_n[str(n0)])
        live[name] = {n: {"peak_bytes": int(frac * p0 * (int(n) / n0)
                                             ** power), "job": job}
                      for n, job in by_n.items()}
    return gc.build_ledger(live)


def test_hand_models_are_what_admission_decides(jobs):
    for name, by_n in jobs.items():
        for n, job in by_n.items():
            spec = {k: v for k, v in job.items() if k != "budget"}
            price = gc._admission_price(job)
            if "budget" in job:
                # the streamed job's price is the chunked model that fits
                # its pinned budget, a quarter of its resident model
                assert price <= job["budget"]
                assert price == memband.streamed_state_bytes(
                    job["n"], 32, job["edges"], memband.streamed_chunk_count(
                        job["n"], 32, job["edges"], job["budget"]))
            else:
                dec = admission.admit(spec, device="cpu")
                assert dec.admitted and dec.model_bytes == price


def test_clean_ledger_has_no_findings(jobs):
    led = _ledger(jobs, frac=0.5)
    assert gc.check_ledger(led) == []
    assert set(led["hand_models"]) == {h.name for h in gc.HAND_MODELS}


def test_price_below_the_peak_is_a_finding(jobs):
    led = _ledger(jobs, frac=1.5)
    found = [f for f in gc.check_ledger(led) if f.code == "GB102"]
    # every job kind's price is held, none exempted
    assert {f.entry for f in found if "BELOW" in f.message} == \
        set(gc.COST_ENTRIES)
    assert not hasattr(gc, "ACCEPTED_BELOW_PEAK")


def test_price_below_the_allocators_peak_is_a_finding(jobs):
    """The requested peak under the price, the allocator's blocks above
    it: what the card held decides."""
    led = _ledger(jobs, frac=0.5)
    s = led["entries"]["bucketed_rollout"]["samples"]["16384"]
    s["allocated_bytes"] = int(1.01 * gc._admission_price(s["job"]))
    found = [f for f in gc.check_ledger(led) if "BELOW" in f.message]
    assert [(f.entry, f.code) for f in found] == [("bucketed_rollout",
                                                   "GB102")]
    assert "n=16384" in found[0].message


def test_memband_band_is_held(jobs):
    led = _ledger(jobs, frac=0.5)
    for name in ("bucketed_rollout", "streamed_rollout"):
        row = led["entries"][name]
        for s in row["samples"].values():
            s["peak_bytes"] = int(s["peak_bytes"] * 200)
        row["models"] = gc.fit_models(gc.COST_ENTRIES[name], row["samples"])
    msgs = [f.message for f in gc.check_ledger(led) if f.code == "GB102"]
    assert any("'bucketed_state' band" in m for m in msgs)


def test_drifted_hand_model_is_a_finding(jobs, monkeypatch):
    led = _ledger(jobs, frac=0.5)
    real = memband.fused_model_bytes
    monkeypatch.setattr(memband, "fused_model_bytes",
                        lambda *a: int(1.2 * real(*a)))
    found = [f for f in gc.check_ledger(led) if f.code == "GB102"]
    assert found and all(f.entry == "fused_anneal" for f in found)
    assert any("drifted" in f.message for f in found)


def test_exponent_and_coverage_findings(jobs):
    led = _ledger(jobs, frac=0.5, power=2.0)
    codes = {(f.entry, f.code) for f in gc.check_ledger(led)}
    assert ("fused_anneal", "GB104") in codes
    led = _ledger(jobs, frac=0.5)
    del led["entries"]["streamed_rollout"]
    assert ("streamed_rollout", "GB103") in {
        (f.entry, f.code) for f in gc.check_ledger(led)}
    assert {f.code for f in gc.check_ledger(None)} == {"GB103"}
    led = _ledger(jobs, frac=0.5)
    led["entries"]["fused_anneal"]["models"]["peak_bytes"]["slope"] += 1.0
    assert ("fused_anneal", "GB104") in {
        (f.entry, f.code) for f in gc.check_ledger(led)}


def test_sample_drift(jobs):
    led = _ledger(jobs, frac=0.5)
    live = {name: copy.deepcopy(row["samples"])
            for name, row in led["entries"].items()}
    assert gc.diff_samples(led, live) == []
    s = live["fused_anneal"]["5000"]
    s["peak_bytes"] = int(s["peak_bytes"] * 1.2)
    assert [f.code for f in gc.diff_samples(led, live)] == ["GB101"]


def test_sample_range_is_the_serves_spread_widened():
    """GB101's range is the ledger's serves, least to largest, widened by
    SAMPLE_BAND; a live sample (its serves' median) must lie in it."""
    want = {"peak_bytes": 1200, "repeats": [1000, 1200, 1100]}
    lo, hi = gc.sample_range(want)
    assert (lo, hi) == (1000 * (1 - gc.SAMPLE_BAND),
                        1200 * (1 + gc.SAMPLE_BAND))
    assert gc.sample_range({"peak_bytes": 500}) == (
        500 * (1 - gc.SAMPLE_BAND), 500 * (1 + gc.SAMPLE_BAND))
    led = {"entries": {"streamed_rollout": {"samples": {"8192": want}}}}
    # one serve that staged a chunk more does not move the median
    inside = {"streamed_rollout": {"8192": {"peak_bytes": 1000,
                                            "repeats": [1000, 1000, 1400]}}}
    assert gc.diff_samples(led, inside) == []
    for peak in (940, 1270):
        live = {"streamed_rollout": {"8192": {"peak_bytes": peak,
                                              "repeats": [peak] * 3}}}
        assert [f.code for f in gc.diff_samples(led, live)] == ["GB101"]


def test_price_below_a_serve_is_a_finding(jobs):
    """The largest serve counts, not only the median sample."""
    led = _ledger(jobs, frac=0.5)
    s = led["entries"]["streamed_rollout"]["samples"]["8192"]
    s["repeats"] = [s["peak_bytes"]] * 4 + [
        int(1.01 * gc._admission_price(s["job"]))]
    found = [f for f in gc.check_ledger(led) if "BELOW" in f.message]
    assert [(f.entry, f.code) for f in found] == [("streamed_rollout",
                                                   "GB102")]


def test_committed_ledger_is_from_the_card_and_reproduces():
    led = gc.load_ledger()
    assert led is not None
    assert "H100" in (led["device"]["name"] or "")
    assert led["device"]["power_limit"]
    for name, spec in gc.COST_ENTRIES.items():
        row = led["entries"][name]
        assert sorted(int(n) for n in row["samples"]) == list(spec.points)
        assert gc.fit_models(spec, row["samples"]) == row["models"]
        for s in row["samples"].values():
            # each sample is the median of its spec's serves
            assert len(s["repeats"]) == spec.repeats
            assert s["peak_bytes"] == statistics.median_low(s["repeats"])
            assert s["allocated_bytes"] >= max(s["repeats"])
    # the committed ledger holds: every price above what the card held
    assert gc.check_ledger(led) == []
    # every hand model recomputed here equals what the card's run blessed
    for hm in gc.HAND_MODELS:
        blessed = led["hand_models"][hm.name]
        for n, job in ((n, s["job"]) for n, s in
                       led["entries"][hm.entry]["samples"].items()):
            assert hm.hand(job) == blessed["hand_bytes"][n]
