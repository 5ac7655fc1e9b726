"""The port's durable checkpoint store (``graphdyn_torch.resilience.store``),
unit by unit, as ``tests/test_store.py`` holds the JAX package's:
checksum-verified loads that catch silent bit rot, keep-last-K retention
with an atomic promote, the monotonic quarantine suffix, write-behind mirror
replication with verified failover, the degraded mirror, and the run
journal. Carries the ``faultinject`` marker (the ``checkpoint.bitrot`` and
``mirror.write`` sites live here).
"""

import json
import logging
import os

import numpy as np
import pytest

from graphdyn_torch.resilience import FaultPlan, FaultSpec, InjectedPreemption
from graphdyn_torch.resilience import faults as faults_mod
from graphdyn_torch.resilience.store import (
    DurableCheckpoint,
    configure_store,
    flush_mirror,
    journal_path_for,
    validate_journal,
)
from graphdyn_torch.utils.io import Checkpoint, open_checkpoint

pytestmark = pytest.mark.faultinject


@pytest.fixture(autouse=True)
def _default_store_config():
    """Every test starts from the defaults (no mirror, keep=2) and cannot
    leak its config into the next."""
    configure_store(mirror=None, keep=2)
    yield
    configure_store(mirror=None, keep=2)


def _save_n(ck, n, base=0):
    for i in range(n):
        ck.save({"x": np.arange(6) + base + i, "y": np.float64(i)},
                {"step": base + i})


# ---------------------------------------------------------------------------
# layout: versions, manifests, promote, retention
# ---------------------------------------------------------------------------


def test_save_publishes_current_plus_versions_and_manifests(tmp_path):
    ck = open_checkpoint(str(tmp_path / "ck"))
    assert isinstance(ck, DurableCheckpoint)       # the factory routes here
    _save_n(ck, 3)
    names = sorted(os.listdir(tmp_path))
    assert "ck.npz" in names and "ck.manifest.json" in names
    # keep=2: versions 2 and 3 retained, version 1 pruned
    assert "ck.v2.npz" in names and "ck.v3.npz" in names
    assert "ck.v1.npz" not in names
    assert "ck.v2.manifest.json" in names and "ck.v3.manifest.json" in names
    arrays, meta = ck.load()
    np.testing.assert_array_equal(arrays["x"], np.arange(6) + 2)
    assert meta == {"step": 2}
    # the published file and the newest version are the same bytes (the
    # promote is a hard link of the immutable version file)
    assert os.path.samefile(str(tmp_path / "ck.npz"),
                            str(tmp_path / "ck.v3.npz"))


def test_retention_honors_keep(tmp_path):
    configure_store(keep=3)
    ck = open_checkpoint(str(tmp_path / "ck"))
    _save_n(ck, 6)
    versions = sorted(f for f in os.listdir(tmp_path)
                      if f.startswith("ck.v") and f.endswith(".npz"))
    assert versions == ["ck.v4.npz", "ck.v5.npz", "ck.v6.npz"]


def test_version_numbering_survives_requeue(tmp_path):
    """A fresh DurableCheckpoint instance on the same path (a requeued
    process) continues the version sequence — it never re-publishes an old
    version number (the journal's exactly-once check depends on this)."""
    path = str(tmp_path / "ck")
    _save_n(open_checkpoint(path), 2)
    _save_n(open_checkpoint(path), 1, base=2)
    events, problems = validate_journal(journal_path_for(path))
    assert problems == []
    saves = [e["version"] for e in events if e.get("op") == "save"]
    assert saves == [1, 2, 3]


def test_remove_cleans_everything_but_quarantines(tmp_path):
    ck = open_checkpoint(str(tmp_path / "ck"))
    _save_n(ck, 3)
    faults_mod.flip_npz_bytes(str(tmp_path / "ck.npz"), seed=0)
    ck.load()                                       # quarantines the current
    ck.remove()
    left = sorted(os.listdir(tmp_path))
    assert left == ["ck.corrupt.1.npz", "run_journal.jsonl"]


# ---------------------------------------------------------------------------
# checksum layer: silent bit rot is detected 100% of the time
# ---------------------------------------------------------------------------


def test_flip_npz_bytes_keeps_container_valid_but_changes_data(tmp_path):
    """The fault payload models SILENT rot: np.load succeeds (CRCs are
    recomputed) and returns different bytes — exactly the corruption class
    a zipfile-error quarantine could never see."""
    p = str(tmp_path / "s")
    Checkpoint(p).save({"x": np.arange(64.0)}, {"t": 1})
    faults_mod.flip_npz_bytes(p + ".npz", seed=3)
    arrays, meta = Checkpoint(p)._read_npz(p + ".npz")  # no structural error
    assert meta == {"t": 1}                             # meta member intact
    assert not np.array_equal(arrays["x"], np.arange(64.0))


@pytest.mark.parametrize("seed", range(8))
def test_bitrot_never_resumes_wrong_state(tmp_path, seed):
    """Across seeds: a bit-rotted current snapshot is ALWAYS detected on
    load — the result is either the intact previous version or None, never
    the corrupted arrays."""
    ck = open_checkpoint(str(tmp_path / "ck"))
    good = np.arange(512) * 7
    ck.save({"x": good}, {"t": 1})
    faults_mod.flip_npz_bytes(str(tmp_path / "ck.npz"), seed=seed)
    loaded = ck.load()
    assert os.path.exists(str(tmp_path / "ck.corrupt.1.npz"))
    assert loaded is not None                      # v1 survived the rewrite
    np.testing.assert_array_equal(loaded[0]["x"], good)


def test_checkpoint_bitrot_fault_site_fires_and_recovers(tmp_path, caplog):
    ck = open_checkpoint(str(tmp_path / "ck"))
    _save_n(ck, 2)
    with caplog.at_level(logging.WARNING, logger="graphdyn_torch.resilience"):
        with FaultPlan([FaultSpec("checkpoint.bitrot", action="bitrot")]):
            arrays, meta = ck.load()
    np.testing.assert_array_equal(arrays["x"], np.arange(6) + 1)  # last save
    assert "quarantined" in caplog.text and "FAILOVER" in caplog.text
    events, problems = validate_journal(journal_path_for(str(tmp_path / "ck")))
    assert problems == []
    ops = [e.get("op") for e in events if e.get("ev") == "journal"]
    assert "quarantine" in ops and "failover" in ops
    q = next(e for e in events if e.get("op") == "quarantine")
    assert "Checksum" in q["reason"]


def test_stale_manifest_is_rejected_not_trusted(tmp_path):
    """A current manifest that disagrees with the current snapshot (crash
    between promote and manifest write, or manifest rot) must fail closed:
    fall back to a version whose own manifest verifies."""
    ck = open_checkpoint(str(tmp_path / "ck"))
    _save_n(ck, 2)
    man_path = str(tmp_path / "ck.manifest.json")
    with open(man_path) as f:
        doc = json.load(f)
    doc["meta_sha256"] = "0" * 64                  # stale/corrupt manifest
    from graphdyn_torch.utils.io import write_json_atomic

    write_json_atomic(man_path, doc)
    arrays, meta = ck.load()
    assert meta == {"step": 1}                     # recovered via v2
    ops = [e.get("op") for e in
           validate_journal(journal_path_for(str(tmp_path / "ck")))[0]
           if e.get("ev") == "journal"]
    assert "quarantine" in ops                     # self-sha caught it


def test_legacy_plain_snapshot_loads_unverified(tmp_path):
    """Format compatibility: a plain-Checkpoint snapshot (no manifest, no
    versions) still loads through the durable store — and the journal says
    it was unverified."""
    p = str(tmp_path / "ck")
    Checkpoint(p).save({"x": np.arange(4)}, {"t": 9})
    arrays, meta = open_checkpoint(p).load()
    assert meta == {"t": 9}
    loads = [e for e in validate_journal(journal_path_for(p))[0]
             if e.get("op") == "load"]
    assert loads and loads[-1]["verified"] is False


def test_durable_snapshot_readable_by_plain_checkpoint(tmp_path):
    """The inverse interop: the published <path>.npz keeps the plain checkpoint's
    format (snapshot formats unchanged — the acceptance criterion)."""
    p = str(tmp_path / "ck")
    open_checkpoint(p).save({"x": np.arange(4)}, {"t": 5})
    arrays, meta = Checkpoint(p).load()
    assert meta == {"t": 5}
    np.testing.assert_array_equal(arrays["x"], np.arange(4))


def test_transient_oserror_propagates_from_durable_load(tmp_path, monkeypatch):
    """The transient-error policy survives the durable wrapper: a transient OSError on
    every candidate re-raises — no quarantine, no silent fresh start."""
    import graphdyn_torch.utils.io as io_mod

    ck = open_checkpoint(str(tmp_path / "ck"))
    _save_n(ck, 2)
    monkeypatch.setattr(
        io_mod.np, "load",
        lambda *a, **k: (_ for _ in ()).throw(OSError(5, "EIO")))
    with pytest.raises(OSError):
        ck.load()
    monkeypatch.undo()
    assert ck.load()[1] == {"step": 1}             # intact after the blip
    assert not any(f.startswith("ck.corrupt") for f in os.listdir(tmp_path))


def test_current_missing_falls_back_to_version(tmp_path):
    """Crash between the version write and the promote: the published file
    is gone (or old) but the version + manifest are on disk — the load
    finds it instead of restarting."""
    ck = open_checkpoint(str(tmp_path / "ck"))
    _save_n(ck, 2)
    os.remove(str(tmp_path / "ck.npz"))
    os.remove(str(tmp_path / "ck.manifest.json"))
    arrays, meta = ck.load()
    assert meta == {"step": 1}


# ---------------------------------------------------------------------------
# quarantine: monotonic suffix + bounded retention (satellite)
# ---------------------------------------------------------------------------


def test_quarantine_suffix_is_monotonic_and_capped(tmp_path):
    """A second corruption must not overwrite the first's evidence; an
    unattended requeue loop must not fill the disk — at most 5 quarantines
    are retained, oldest removed first."""
    p = str(tmp_path / "s")
    ck = Checkpoint(p)
    for i in range(7):
        ck.save({"x": np.arange(4) + i}, {"i": i})
        with open(p + ".npz", "wb") as f:          # structural corruption
            f.write(b"not a zip %d" % i)
        assert ck.load() is None
    names = sorted(f for f in os.listdir(tmp_path) if ".corrupt." in f)
    # 7 corruptions → suffixes 1..7 were used, only the last 5 retained
    assert names == [f"s.corrupt.{i}.npz" for i in (3, 4, 5, 6, 7)]


# ---------------------------------------------------------------------------
# mirror: write-behind replication, failover, degraded mirror
# ---------------------------------------------------------------------------


def test_mirror_replicates_write_behind_and_fails_over(tmp_path):
    mirror = str(tmp_path / "mirror")
    configure_store(mirror=mirror)
    p = str(tmp_path / "primary" / "ck")
    ck = open_checkpoint(p)
    _save_n(ck, 2)
    flush_mirror()
    # the mirror namespace is one subdirectory per primary directory (so
    # same-named checkpoints of different jobs sharing one mirror cannot
    # collide), resolved by _mirror_base
    mbase = ck._mirror_base()
    assert os.path.dirname(os.path.dirname(mbase)) == mirror
    mnames = sorted(os.listdir(os.path.dirname(mbase)))
    assert "ck.npz" in mnames and "ck.manifest.json" in mnames
    assert "ck.v2.npz" in mnames
    # the primary directory dies wholesale — journal and all
    import shutil

    shutil.rmtree(str(tmp_path / "primary"))
    arrays, meta = ck.load()
    assert meta == {"step": 1}
    np.testing.assert_array_equal(arrays["x"], np.arange(6) + 1)
    events, problems = validate_journal(journal_path_for(p))
    assert problems == []
    fo = [e for e in events if e.get("op") == "failover"]
    assert fo and fo[-1]["source"] == "mirror"


def test_mirror_write_fault_degrades_primary_proceeds(tmp_path, caplog):
    """The mirror.write site: mirror-path ENOSPC must not fail the save —
    the primary publishes, the journal records the degraded mirror."""
    mirror = str(tmp_path / "mirror")
    configure_store(mirror=mirror)
    p = str(tmp_path / "primary" / "ck")
    ck = open_checkpoint(p)
    with caplog.at_level(logging.WARNING, logger="graphdyn_torch.resilience"):
        with FaultPlan([FaultSpec("mirror.write", count=99)]):
            _save_n(ck, 2)
    flush_mirror()
    assert ck.load()[1] == {"step": 1}             # primary intact
    assert not os.path.exists(ck._mirror_base() + ".npz")
    assert "DEGRADED" in caplog.text
    events, problems = validate_journal(journal_path_for(p))
    assert problems == []
    assert sum(1 for e in events if e.get("op") == "mirror.degraded") == 2
    # the episode over, mirroring recovers on the next save
    ck.save({"x": np.arange(6), "y": np.float64(0)}, {"step": 9})
    flush_mirror()
    assert os.path.exists(ck._mirror_base() + ".npz")


def test_mirror_preempt_is_a_hard_kill(tmp_path):
    configure_store(mirror=str(tmp_path / "mirror"))
    ck = open_checkpoint(str(tmp_path / "primary" / "ck"))
    with FaultPlan([FaultSpec("mirror.write", "preempt")]):
        with pytest.raises(InjectedPreemption):
            ck.save({"x": np.arange(3)}, {})


def test_remove_cleans_mirror_too(tmp_path):
    mirror = str(tmp_path / "mirror")
    configure_store(mirror=mirror)
    ck = open_checkpoint(str(tmp_path / "primary" / "ck"))
    _save_n(ck, 2)
    flush_mirror()
    ck.remove()
    mdir = os.path.dirname(ck._mirror_base())
    assert not any(f.startswith("ck") for f in os.listdir(mdir))


# ---------------------------------------------------------------------------
# run journal: schema, sealing, exactly-once
# ---------------------------------------------------------------------------


def test_journal_is_read_ledger_parseable_and_schema_valid(tmp_path):
    p = str(tmp_path / "ck")
    ck = open_checkpoint(p)
    _save_n(ck, 2)
    ck.load()
    ck.remove()
    events, problems = validate_journal(journal_path_for(p))
    assert problems == []
    ops = [e["op"] for e in events if e.get("ev") == "journal"]
    assert ops == ["save", "save", "load", "remove"]
    assert events[0]["ev"] == "manifest"           # the process stamp


def test_journal_seals_torn_tail_of_a_killed_run(tmp_path):
    """A hard-killed process dies mid-journal-line; the next (requeued)
    process must seal the fragment so its own events survive parsing —
    the obs recorder's seam contract, reused."""
    from graphdyn_torch.resilience import store as store_mod

    p = str(tmp_path / "ck")
    ck = open_checkpoint(p)
    _save_n(ck, 1)
    jpath = journal_path_for(p)
    with open(jpath, "a", encoding="utf-8") as f:
        f.write('{"ev": "journal", "t_unix": 1, "op": "sa')   # torn mid-line
    store_mod._reset_journal_state()               # simulate a new process
    _save_n(ck, 1, base=1)
    events, problems = validate_journal(jpath)
    assert problems == [
        "1 torn line(s) (sealed seams are tolerated)"
    ]
    assert [e["version"] for e in events if e.get("op") == "save"] == [1, 2]
    # two process stamps: the original and the requeue
    assert sum(1 for e in events if e.get("ev") == "manifest") == 2


def test_validate_journal_flags_unknown_ops_and_replayed_versions(tmp_path):
    jpath = str(tmp_path / "run_journal.jsonl")
    lines = [
        {"ev": "manifest", "t": 0.0, "run": {"journal": True}},
        {"ev": "journal", "t_unix": 1.0, "pid": 1, "op": "save",
         "path": "ck", "version": 2},
        {"ev": "journal", "t_unix": 2.0, "pid": 1, "op": "save",
         "path": "ck", "version": 2},              # replayed version
        {"ev": "journal", "t_unix": 3.0, "pid": 1, "op": "frobnicate",
         "path": "ck"},                            # unknown op
    ]
    with open(jpath, "w", encoding="utf-8") as f:
        f.writelines(json.dumps(e) + "\n" for e in lines)
    _, problems = validate_journal(jpath)
    assert any("re-published version" in p for p in problems)
    assert any("frobnicate" in p for p in problems)


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------


def test_atexit_flushes_queued_mirror_writes(tmp_path):
    """A run that saves and exits immediately must not drop its queued
    write-behind replicas: the module registers an atexit flush_mirror, so
    a normal interpreter exit drains the queue BEFORE daemon threads die.
    Proven end to end in a subprocess — the exact save-then-exit shape the
    write-behind race loses without the hook."""
    import subprocess
    import sys

    mirror = tmp_path / "mirror"
    primary = tmp_path / "primary"
    script = (
        "import numpy as np\n"
        "from graphdyn_torch.resilience.store import DurableCheckpoint, "
        "configure_store\n"
        f"configure_store(mirror={str(mirror)!r})\n"
        f"ck = DurableCheckpoint({str(primary / 'ck')!r})\n"
        # several sizable saves so the write-behind queue is realistically
        # non-empty at exit — then fall off the end of the script
        "for i in range(4):\n"
        "    ck.save({'a': np.arange(200_000) + i}, {'v': i})\n"
    )
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    # the mirror namespace is <mirror>/<dirhash8>/ck.npz
    replicas = list(mirror.glob("*/ck.npz"))
    assert replicas, (
        "queued mirror writes were dropped at exit "
        f"(mirror tree: {list(mirror.rglob('*'))})"
    )
    # the published replica is the LAST save (the queue drained fully)
    with np.load(replicas[0]) as f:
        assert f["a"][0] == 3


def test_flush_mirror_timeout_abandons_wedged_queue(monkeypatch, caplog):
    """The atexit flush is bounded: a mirror job wedged on a dead
    filesystem is logged and abandoned, never a hung interpreter exit."""
    import threading

    from graphdyn_torch.resilience import store as store_mod

    release = threading.Event()
    store_mod._ensure_mirror_worker()
    store_mod._mirror_q.put(lambda: release.wait(20))
    try:
        with caplog.at_level(logging.WARNING, logger="graphdyn_torch.resilience"):
            t0 = __import__("time").monotonic()
            flush_mirror(timeout_s=0.2)
            assert __import__("time").monotonic() - t0 < 5.0
        assert any("mirror flush timed out" in r.message
                   for r in caplog.records)
    finally:
        release.set()
        flush_mirror()                  # drain for the next test


def test_cli_flags_configure_the_store(tmp_path, capsys):
    """--ckpt-mirror/--ckpt-keep reach the singleton on every invocation —
    and are RESET on the next one (no leakage between in-process runs)."""
    from graphdyn_torch.cli import main
    from graphdyn_torch.resilience.store import CONFIG

    out = str(tmp_path / "r.npz")
    mirror = str(tmp_path / "m")
    rc = main(["--ckpt-mirror", mirror, "--ckpt-keep", "4",
               "sa", "--n", "40", "--d", "3", "--p", "1", "--c", "1",
               "--n-stat", "1", "--max-steps", "2000", "--seed", "0",
               "--device", "cpu",
               "--checkpoint", str(tmp_path / "ck"), "--out", out])
    capsys.readouterr()
    assert rc == 0
    assert CONFIG.mirror == mirror and CONFIG.keep == 4
    rc = main(["sa", "--n", "40", "--d", "3", "--p", "1", "--c", "1",
               "--n-stat", "1", "--max-steps", "2000", "--seed", "0",
               "--device", "cpu"])
    capsys.readouterr()
    assert rc == 0
    assert CONFIG.mirror is None and CONFIG.keep == 2
