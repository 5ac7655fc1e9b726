"""The port's persistence (``graphdyn_torch.utils.io``), as
``tests/test_io.py`` holds the JAX package's: npz results, the atomic
checkpoint, the periodic saver, the fingerprint."""

import numpy as np

from graphdyn_torch.utils.io import (
    Checkpoint,
    PeriodicCheckpointer,
    load_results_npz,
    save_results_npz,
)


def test_results_npz_roundtrip(tmp_path):
    p = str(tmp_path / "res.npz")
    save_results_npz(
        p, mag_reached=np.array([0.5]), conf=np.ones((2, 3), np.int8), time=1.25
    )
    out = load_results_npz(p)
    assert set(out) == {"mag_reached", "conf", "time"}
    np.testing.assert_array_equal(out["conf"], np.ones((2, 3), np.int8))


def test_checkpoint_roundtrip_single_file(tmp_path):
    ck = Checkpoint(str(tmp_path / "state"))
    assert ck.load() is None
    arrays = {"chi": np.arange(6.0).reshape(2, 3), "s": np.array([1, -1], np.int8)}
    meta = {"lmbd_index": 7, "t": 123, "seed": 5}
    ck.save(arrays, meta)
    # single-file layout: arrays+meta can never be torn apart by preemption
    assert (tmp_path / "state.npz").exists()
    assert not (tmp_path / "state.json").exists()
    arrs, m = ck.load()
    assert m == meta
    np.testing.assert_array_equal(arrs["chi"], arrays["chi"])
    np.testing.assert_array_equal(arrs["s"], arrays["s"])


def test_checkpoint_rejects_object_dtype_at_save(tmp_path):
    """np.savez would pickle an object array and succeed, but the default
    allow_pickle=False load then fails — which the corruption handler would
    quarantine as 'corrupt' on every resume. Fail at write time instead."""
    ck = Checkpoint(str(tmp_path / "state"))
    ragged = np.asarray([np.arange(2), np.arange(3)], dtype=object)
    with np.testing.assert_raises(TypeError):
        ck.save({"bad": ragged}, {})
    assert ck.load() is None                     # nothing was written


def test_checkpoint_reserved_key(tmp_path):
    ck = Checkpoint(str(tmp_path / "state"))
    try:
        ck.save({"__meta__": np.zeros(1)}, {})
    except ValueError:
        pass
    else:
        raise AssertionError("reserved key must be rejected")


def test_periodic_checkpointer_throttles(tmp_path):
    pc = PeriodicCheckpointer(str(tmp_path / "pc"), interval_s=1e9)
    assert not pc.maybe_save({"x": np.zeros(1)}, {})   # within interval
    pc._last -= 2e9
    assert pc.maybe_save({"x": np.zeros(1)}, {"t": 1})
    arrs, meta = pc.ckpt.load()
    assert meta == {"t": 1}


def test_results_npz_write_is_atomic(tmp_path):
    """save_results_npz goes through temp + os.replace (same discipline as
    Checkpoint.save): np.savez's .npz-appending semantics are preserved and
    no temp file survives the write."""
    p = str(tmp_path / "res")                    # extensionless, like np.savez
    save_results_npz(p, x=np.arange(3))
    assert (tmp_path / "res.npz").exists()
    assert list(tmp_path.glob("*.tmp.npz")) == []
    np.testing.assert_array_equal(load_results_npz(p + ".npz")["x"], np.arange(3))


def test_write_json_atomic_roundtrip(tmp_path):
    from graphdyn_torch.utils.io import write_json_atomic

    p = str(tmp_path / "doc.json")
    write_json_atomic(p, {"a": [1, 2]}, indent=1)
    import json

    with open(p) as f:
        assert json.load(f) == {"a": [1, 2]}
    assert list(tmp_path.glob("*.tmp")) == []


def test_checkpoint_load_metaless_npz(tmp_path):
    """A foreign npz without the __meta__ entry (e.g. a reference-style
    results file) loads with empty metadata instead of KeyError."""
    path = tmp_path / "foreign"
    np.savez(str(path) + ".npz", s=np.arange(4), m=np.float64(0.5))
    arrays, meta = Checkpoint(str(path)).load()
    assert meta == {}
    np.testing.assert_array_equal(arrays["s"], np.arange(4))


def test_fingerprint_omits_optional_fields_at_defaults():
    """Checkpoints written before EntropyConfig grew plateau_eps /
    plateau_patience must still resume: at their defaults the opt-in fields
    are omitted from the fingerprint, reproducing the pre-field digest
    byte-for-byte."""
    import dataclasses

    from graphdyn_torch.config import DynamicsConfig, EntropyConfig
    from graphdyn_torch.utils.io import _fingerprint_repr, run_fingerprint

    cfg = EntropyConfig()
    r = _fingerprint_repr(cfg)
    assert "plateau" not in r

    # reconstruct the pre-field dataclass (same name, same fields minus the
    # opt-in ones) and check digest equality, nested config included
    pre_fields = [
        (f.name, f.type, f)
        for f in dataclasses.fields(cfg)
        if f.name not in EntropyConfig._fingerprint_optional
    ]
    Pre = dataclasses.make_dataclass("EntropyConfig", pre_fields)
    pre = Pre(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(cfg)
        if f.name not in EntropyConfig._fingerprint_optional
    })
    assert _fingerprint_repr(pre) == r
    assert run_fingerprint(pre) == run_fingerprint(cfg)

    # a NON-default opt-in value must change the fingerprint (it changes
    # ladder semantics, so resuming across it would be a chimera)
    tuned = EntropyConfig(plateau_eps=1e-4)
    assert run_fingerprint(tuned) != run_fingerprint(cfg)
    assert "plateau_eps" in _fingerprint_repr(tuned)

    # nested dynamics config still participates in the digest
    other = EntropyConfig(dynamics=DynamicsConfig(rule="minority"))
    assert run_fingerprint(other) != run_fingerprint(cfg)
