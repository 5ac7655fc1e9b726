"""The port's host-concurrency auditor (``graphdyn_torch.analysis.
racecheck``): its static half gives the same GT001–GT005 findings as the
JAX package's auditor on shared fixture sources that use only
``threading``; ``_fuzz_delay_s`` gives the JAX package's delays; the
committed ``concurrency_ledger.json`` matches the live inventory of
``graphdyn_torch/``; the runtime half wraps the module locks, asserts the
observed order against the ledger, counts acquires into the flight ring,
stamps held locks into a crash event, and restores the plain locks."""

import json
import textwrap
import threading

import pytest

from graphdyn.analysis import racecheck as jr
from graphdyn_torch.analysis import racecheck as tr


def _src(text):
    return textwrap.dedent(text).lstrip("\n")


FIXTURES = {
    "gt001": """
        import threading

        _lock = threading.Lock()
        _seen = {}
        _log = []

        def _worker(k):
            _seen[k] = 1
            with _lock:
                _log.append(k)
            _helper(k)

        def _helper(k):
            _log.append(k)

        def start():
            t = threading.Thread(target=_worker, args=(1,), daemon=True)
            t.start()
            t.join(timeout=1.0)
        """,
    "gt002": """
        import threading

        _a = threading.Lock()
        _b = threading.RLock()

        def one():
            with _a:
                with _b:
                    pass

        def two():
            with _b:
                take_a()

        def take_a():
            with _a:
                pass
        """,
    "gt003": """
        import threading

        def _loop():
            pass

        def start():
            t = threading.Thread(target=_loop, name="spin", daemon=True)
            t.start()
            u = threading.Thread(target=_loop)
            u.start()
            u.join()
            threading.Thread(target=_loop).start()
        """,
    "gt005": """
        import time
        from time import sleep

        def wait():
            time.sleep(0.1)
            sleep(0.2)
            # graftrace: disable-next-line=GT005  an injected stall, a reason
            time.sleep(0.3)
        """,
    "disabled": """
        import threading
        # graftrace: disable-file=GT003  bounded by a documented close path

        def _loop():
            pass

        t = threading.Thread(target=_loop)
        t.start()
        """,
}


def _findings(mod, name):
    src = _src(FIXTURES[name])
    return [(f.code, f.line) for f in
            mod.analyze_sources([(f"fixtures/{name}.py", src)])]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_static_half_matches_the_jax_auditor(name):
    got = _findings(tr, name)
    assert got == _findings(jr, name)
    if name != "disabled":
        assert got                       # the fixture does fire


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_inventory_rows_match_the_jax_auditor(name):
    src = [(f"fixtures/{name}.py", _src(FIXTURES[name]))]
    got, _ = tr.collect_inventory(sources=src)
    want, _ = jr.collect_inventory(sources=src)
    assert tr.inventory_to_ledger(got) == jr.inventory_to_ledger(want)


def test_ledger_diff_matches_the_jax_auditor():
    src = [("fixtures/gt002.py", _src(FIXTURES["gt002"]))]
    for ledger in (None, {"threads": {}, "locks": {}, "globals": {},
                          "lock_order": [["fixtures/gt002.py::_b",
                                          "fixtures/gt002.py::_a"],
                                         ["x::stale", "y::stale"]]}):
        # each package names its own ledger file: compare (code, line)
        got = sorted((f.code, f.line) for f in
                     tr.analyze_sources(src, ledger, check_declarations=True))
        want = sorted((f.code, f.line) for f in
                      jr.analyze_sources(src, ledger,
                                         check_declarations=True))
        assert got == want


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("op", ["acquire", "release"])
def test_fuzz_delay_equals_the_jax_package(seed, op):
    for lock in ("graphdyn_torch/obs/flight.py::_lock", "a::b"):
        for thread in ("MainThread", "graphdyn-torch-prefetch"):
            for max_ms in (1.0, 3.0, 20.0, 30.0):
                assert tr._fuzz_delay_s(seed, lock, thread, op, max_ms) == \
                    jr._fuzz_delay_s(seed, lock, thread, op, max_ms)


def test_committed_ledger_matches_the_live_inventory(capsys):
    assert tr.main([]) == 0
    assert "concurrency surface clean" in capsys.readouterr().err
    led = tr.load_ledger()
    for site in ("graphdyn_torch/ops/cuda_build.py::_lock",
                 "graphdyn_torch/ops/packed_cuda.py::_lib_lock",
                 "graphdyn_torch/ops/bucketed.py::_layouts_lock",
                 "graphdyn_torch/serve/spool.py::Spool._lock",
                 "graphdyn_torch/serve/bucketing.py::BucketCache._lock"):
        assert site in led["locks"], site
    assert "graphdyn_torch/serve/worker.py::graphdyn-serve-worker" in \
        led["threads"]
    assert "runtime_order" in led


def test_write_ledger_keeps_the_runtime_order(tmp_path):
    p = tmp_path / "ledger.json"
    p.write_text(json.dumps({"runtime_order": [["a::x", "b::y"]]}))
    inv, _ = tr.collect_inventory(
        sources=[("fixtures/gt001.py", _src(FIXTURES["gt001"]))])
    tr.write_ledger(inv, p)
    doc = json.loads(p.read_text())
    assert doc["runtime_order"] == [["a::x", "b::y"]]
    assert doc["locks"] == tr.inventory_to_ledger(inv)["locks"]


@pytest.fixture
def runtime(tmp_path):
    """The runtime half installed against a ledger whose runtime_order
    declares [cuda_build._lock, flight._lock]; uninstalled afterwards."""
    from graphdyn_torch.obs import flight

    led = dict(tr.load_ledger())
    led["runtime_order"] = [["graphdyn_torch/ops/cuda_build.py::_lock",
                             "graphdyn_torch/obs/flight.py::_lock"]]
    p = tmp_path / "ledger.json"
    p.write_text(json.dumps(led))
    wrapped = tr.install(p, fuzz_seed=3, fuzz_max_ms=0.5)
    flight.clear()
    try:
        yield wrapped
    finally:
        tr.uninstall()


def test_runtime_wraps_the_module_locks(runtime):
    from graphdyn_torch.obs import flight
    from graphdyn_torch.ops import cuda_build, packed_cuda

    assert "graphdyn_torch/ops/packed_cuda.py::_lib_lock" in runtime
    assert "graphdyn_torch/analysis/racecheck.py::_book_lock" not in runtime
    assert isinstance(packed_cuda._lib_lock, tr.TracedLock)
    assert tr.installed() and tr.install() == runtime     # idempotent
    with packed_cuda._lib_lock:
        with cuda_build._lock:
            pass
    assert ("graphdyn_torch/ops/packed_cuda.py::_lib_lock",
            "graphdyn_torch/ops/cuda_build.py::_lock") in tr.observed_order()
    assert tr.assert_observed_against_ledger() == []
    assert ("graphdyn_torch/ops/packed_cuda.py::_lib_lock",
            "graphdyn_torch/ops/cuda_build.py::_lock") in \
        tr.undeclared_observed()
    acq = [e for e in flight.snapshot() if e["name"] == "racecheck.acquire"]
    assert any(e["attrs"]["lock"].endswith("cuda_build.py::_lock")
               and e["attrs"]["depth"] == 2 for e in acq)


def test_runtime_raises_on_an_inverted_pair(runtime):
    from graphdyn_torch.obs import flight
    from graphdyn_torch.ops import cuda_build

    with pytest.raises(tr.LockOrderError, match="inversion"):
        with flight._lock:
            with cuda_build._lock:
                pass
    assert not tr.held_locks()


def test_crash_event_names_the_held_locks(runtime):
    from graphdyn_torch.obs import flight
    from graphdyn_torch.ops import cuda_build

    with cuda_build._lock:
        attrs = flight._crash_attrs("test", None, "here")
    held = attrs["locks_held"]
    assert any("cuda_build.py::_lock" in v for v in held.values())


def test_uninstall_restores_and_off_costs_nothing(monkeypatch):
    from graphdyn_torch.ops import packed_cuda

    monkeypatch.delenv(tr.ENV_VAR, raising=False)
    assert tr.maybe_install() == []
    assert not tr.installed()
    plain = packed_cuda._lib_lock
    assert not isinstance(plain, tr.TracedLock)
    tr.install()
    try:
        assert isinstance(packed_cuda._lib_lock, tr.TracedLock)
    finally:
        tr.uninstall()
    assert packed_cuda._lib_lock is plain
    monkeypatch.setenv(tr.ENV_VAR, "1")
    try:
        assert tr.maybe_install()
    finally:
        tr.uninstall()


def test_traced_lock_across_threads_records_each_thread():
    lock = tr.TracedLock(threading.Lock(), "fixtures::l")
    seen = []

    def worker():
        with lock:
            seen.append(threading.current_thread().name)

    ts = [threading.Thread(target=worker, name=f"w{k}") for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=5)
    assert sorted(seen) == ["w0", "w1", "w2", "w3"]
    assert not lock.locked()


KERNEL_MODULES = ("packed_cuda", "fused_cuda", "bucketed_cuda", "gather_cuda",
                  "bdcm_sweep", "bdcm_cuda")


def _observe_library_builds(tmp_path, monkeypatch):
    """Each kernel library's first load under the runtime half, its nvcc
    replaced by a stand-in that writes an empty library (so the build, the
    ``kernel.build`` counter into the flight ring and the load all run, and
    the empty file then fails to load): the lock-order edges observed."""
    import importlib
    import stat

    from graphdyn_torch.ops import cuda_build

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi\n'
                    '  shift\ndone\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    tr.install()
    try:
        for name in KERNEL_MODULES:
            mod = importlib.import_module(f"graphdyn_torch.ops.{name}")
            monkeypatch.setattr(mod, "_lib", None)
            with pytest.raises(OSError):
                mod._library()
        return tr.observed_order(), tr.undeclared_observed()
    finally:
        tr.uninstall()


def test_kernel_builds_observe_only_the_declared_runtime_order(tmp_path,
                                                               monkeypatch):
    observed, undeclared = _observe_library_builds(tmp_path, monkeypatch)
    lib = "graphdyn_torch/ops/{}.py::_lib_lock"
    build = "graphdyn_torch/ops/cuda_build.py::_lock"
    ring = "graphdyn_torch/obs/flight.py::_lock"
    want = {(build, ring)}
    for name in KERNEL_MODULES:
        want |= {(lib.format(name), build), (lib.format(name), ring)}
    assert set(observed) == want
    assert undeclared == []
    assert sorted(want) == sorted(map(tuple,
                                      tr.load_ledger()["runtime_order"]))
