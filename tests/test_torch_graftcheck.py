"""The port's dispatch fingerprints (``graphdyn_torch.analysis.
graftcheck``): every entry point's CPU row equals the committed ledger's
within its bands (the JAX package's band policy), the live rules hold, a
planted host sync (``.item()``) and a planted float64 op in a fingerprinted
chunk are caught, the band diff and the recompile guard fire on their own
cases, and the process-group entries are recorded as unsupported in one
process."""

import pytest
import torch

from graphdyn.analysis import graftcheck as jg
from graphdyn_torch.analysis import graftcheck as gc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_entry_names_and_codes_are_the_jax_package_ones():
    assert set(gc.ENTRIES) == set(jg.ENTRIES)
    assert set(gc.RULES) == set(jg.RULES)
    assert gc.LARGE_CONSTANT_BYTES == jg.LARGE_CONSTANT_BYTES


@pytest.mark.parametrize("name", sorted(gc.ENTRIES))
def test_cpu_row_matches_the_ledger(name):
    live = gc.collect_fingerprints([name], device="cpu")
    spec = gc.ENTRIES[name]
    if "unsupported" in live[name]:
        assert "process group" in live[name]["unsupported"]
        return
    assert gc.audit_fingerprint(name, live[name], in_place=spec.in_place,
                                device="cpu",
                                f64_reason=spec.f64_reason) == []
    assert gc.check_ledger(live, gc.load_ledger(), "cpu") == []
    assert live[name]["launches"] == {}        # the plain versions ran


def _planted(monkeypatch, name, plant):
    spec = gc.ENTRIES[name]

    def build(device):
        chunk = spec.build(device)
        return chunk._replace(run=lambda: plant(chunk.run()))

    monkeypatch.setitem(gc.ENTRIES, name, spec._replace(build=build))
    return gc.collect_fingerprints([name], device="cpu")


def test_planted_item_is_caught(monkeypatch):
    def plant(out):
        out.sum().item()
        return out

    live = _planted(monkeypatch, "packed_rollout", plant)
    assert live["packed_rollout"]["op_categories"]["host_sync"] == 1
    codes = [f.code for f in gc.check_ledger(live, gc.load_ledger(), "cpu")]
    assert "GC101" in codes


def test_planted_float64_is_caught(monkeypatch):
    def plant(out):
        return out, out.to(torch.float32).mean().double() * 2

    live = _planted(monkeypatch, "packed_rollout", plant)
    fp = live["packed_rollout"]
    assert fp["f64_ops"] >= 1
    assert [f.code for f in gc.audit_fingerprint(
        "packed_rollout", fp, in_place=False)] == ["GC002"]
    codes = [f.code for f in gc.check_ledger(live, gc.load_ledger(), "cpu")]
    assert "GC002" in codes


def test_sanctioned_float64_count_is_held_to_the_ledger():
    live = gc.collect_fingerprints(["sa_group_loop"], device="cpu")
    assert live["sa_group_loop"]["f64_ops"] > 0      # exp(-dH) by design
    assert gc.audit_fingerprint(
        "sa_group_loop", live["sa_group_loop"], in_place=False,
        f64_reason=gc.ENTRIES["sa_group_loop"].f64_reason) == []
    bumped = dict(live["sa_group_loop"],
                  f64_ops=live["sa_group_loop"]["f64_ops"] + 1)
    codes = [f.code for f in gc.check_ledger({"sa_group_loop": bumped},
                                             gc.load_ledger(), "cpu")]
    assert codes == ["GC002"]


BASE = {"op_categories": {"elementwise": 40, "gather": 8, "layout": 10},
        "op_total": 58, "f64_ops": 0, "largest_host_const_bytes": 100,
        "launches": {"fused_cuda.LAUNCHES": 1}, "state_in_place": True}


@pytest.mark.parametrize("change,code", [
    ({"op_categories": {**BASE["op_categories"], "scatter": 1}}, "GC101"),
    ({"op_categories": {**BASE["op_categories"], "elementwise": 70}},
     "GC102"),
    ({"op_total": 80}, "GC103"),
    ({"state_in_place": False}, "GC104"),
    ({"largest_host_const_bytes": 5 << 20}, "GC105"),
    ({"launches": {"fused_cuda.LAUNCHES": 2}}, "GC106"),
    ({"f64_ops": 1}, "GC002"),
])
def test_band_diff(change, code):
    assert gc.diff_fingerprints("e", BASE, BASE) == []
    live = {**BASE, **change}
    assert code in [f.code for f in gc.diff_fingerprints("e", BASE, live)]


def test_bands_absorb_small_drift():
    live = {**BASE, "op_categories": {**BASE["op_categories"],
                                      "elementwise": 44}, "op_total": 62}
    assert gc.diff_fingerprints("e", BASE, live) == []


def test_live_rules_and_missing_ledger():
    fp = {**BASE, "state_in_place": False,
          "largest_host_const_bytes": 2 << 20}
    codes = [f.code for f in gc.audit_fingerprint("e", fp, in_place=True,
                                                  device="cuda")]
    assert codes == ["GC001", "GC003"]
    assert gc.audit_fingerprint("e", fp, in_place=True, device="cpu")[0] \
        .code == "GC003"
    assert {f.code for f in gc.check_ledger({"e": BASE}, None, "cuda")} == \
        {"GC100"}


def test_recompile_watch_counts_builds_per_entry():
    from graphdyn_torch import obs

    orig = obs.counter
    with gc.RecompileWatch() as watch:
        with watch.entry("fused_anneal"):
            obs.counter("kernel.build", lib="libfused.so")
            obs.counter("kernel.build", lib="libfused2.so")
        obs.counter("kernel.build", lib="libpacked.so")
        obs.counter("other.event")
    assert obs.counter is orig           # restored
    assert watch.counts() == {"<run>": 1, "fused_anneal": 2}
    found = gc.check_recompiles(watch, {"fused_anneal": 1, "<run>": 1})
    assert [(f.entry, f.code) for f in found] == [("fused_anneal", "GC004")]


def test_cli_checks_a_subset(capsys):
    assert gc.main(["--entries", "packed_rollout,bdcm_sweep"]) == 0
