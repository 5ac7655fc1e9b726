"""The bounded soak matrix of the port, one (scenario, seed) run at a time,
for the ``tests/test_torch_soak_*.py`` files that split it (so that
``--dist loadfile`` spreads it over the test workers). Each run goes
through ``graphdyn_torch.resilience.soak.run_scenario`` on the CPU and is
held to the whole contract: bit-exact parity with the fault-free oracle,
a schema-valid journal with the scenario's required ops, the flight story,
and the scenario's own evidence."""

from graphdyn_torch.resilience.soak import BOUNDED_SEEDS, run_scenario

#: the evidence each scenario must leave in its journal, beyond its
#: catalogue's required ops
EVIDENCE = {
    "bitrot": "quarantine",
    "mirror_failover": "failover",
    "hang_detect": "supervise.restart",
    "crash_loop_quarantine": "supervise.quarantine",
    "stream_churn": "stream.churn",
    "serve_kill_requeue": "serve.evict",
}


def cases(names):
    return [(n, s) for n in names for s in BOUNDED_SEEDS]


def run_and_check(name: str, seed: int, root: str, oracle_cache: dict):
    rep = run_scenario(name, seed, root, oracle_cache, "cpu")
    assert rep["ok"], rep["problems"]
    assert rep["scenario"] == name and rep["seed"] == seed
    if name in EVIDENCE:
        assert EVIDENCE[name] in rep["journal_ops"], rep
    return rep
