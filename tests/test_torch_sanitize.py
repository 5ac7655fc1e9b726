"""The port's host-aliasing sanitizer (``graphdyn_torch.analysis.sanitize``)
on the CPU: a numpy buffer written while a tensor sharing its memory lives
raises ``AliasRaceError`` naming the crossing, as the JAX package's
sanitizer raises for the same buffer crossed with ``jnp.asarray``; copies,
read-only sources and writes after the tensor died do not; the pending
copy window (an asynchronous copy's source written before its event
completed) raises, a write after the host waited does not; the off path
patches nothing; ``GRAPHDYN_SANITIZE=alias`` wraps a CLI command."""

import contextlib
import gc
import io
import json

import numpy as np
import pytest
import torch

from graphdyn.analysis import sanitize as js
from graphdyn_torch import cli
from graphdyn_torch.analysis import sanitize as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _jax_race(buf):
    import jax.numpy as jnp

    with js.alias_sanitizer():
        d = jnp.asarray(buf)
        buf[0] = 7
        del d


def _port_race(buf):
    with ts.alias_sanitizer():
        t = torch.from_numpy(buf)
        buf[0] = 7
        del t


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.float32])
def test_alias_race_raises_in_both_packages(dtype):
    with pytest.raises(js.AliasRaceError):
        _jax_race(np.zeros(64, dtype))
    with pytest.raises(ts.AliasRaceError, match="test_torch_sanitize.py"):
        _port_race(np.zeros(64, dtype))


def test_as_tensor_alias_raises_and_copies_do_not():
    buf = np.zeros(32, np.float32)
    with pytest.raises(ts.AliasRaceError):
        with ts.alias_sanitizer():
            t = torch.as_tensor(buf)
            buf[1] = 3.0
            del t
    with ts.alias_sanitizer() as san:
        t1 = torch.as_tensor(buf, dtype=torch.float64)     # a conversion
        t2 = torch.tensor(buf)                              # a copy
        buf[1] = 4.0
        assert san.crossings == 0
    ro = np.zeros(8, np.int32)
    ro.flags.writeable = False
    with ts.alias_sanitizer() as san:
        torch.from_numpy(ro)
        assert san.crossings == 0
    del t1, t2


def test_write_after_the_tensor_died_is_outside_the_window():
    buf = np.zeros(16, np.int32)
    with ts.alias_sanitizer() as san:
        t = torch.from_numpy(buf)
        assert san.crossings == 1
        del t
        gc.collect()
        buf[0] = 9                      # the alias is gone: no race
        assert san.records == []


def test_verify_raises_inside_the_context():
    buf = np.zeros(16, np.int32)
    with pytest.raises(ts.AliasRaceError):
        with ts.alias_sanitizer() as san:
            t = torch.from_numpy(buf)
            buf[3] = 1
            try:
                san.verify()
            finally:
                del t


class _Event:
    """A stand-in for a CUDA event: complete once ``done`` is set (or
    ``synchronize`` is called)."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_pending_copy_window():
    src = torch.arange(64, dtype=torch.int32)
    # written before the copy's event completed: a race, named by its site
    with pytest.raises(ts.AliasRaceError, match="copy.py:12"):
        with ts.alias_sanitizer() as san:
            ev = _Event()
            san.track_pending(src, ev, "copy.py:12")
            src[0] = -1
            ev.done = True
            san.poll()
    # the host saw the event complete, then wrote: outside the window
    src = torch.arange(64, dtype=torch.int32)
    with ts.alias_sanitizer() as san:
        ev = _Event()
        san.track_pending(src, ev, "copy.py:20")
        ev.done = True
        san.poll()
        assert san.pending == []
        src[0] = -1
    # still pending at exit: waited for, then verified
    src = torch.arange(64, dtype=torch.int32)
    with ts.alias_sanitizer() as san:
        ev = _Event()
        san.track_pending(src, ev, "copy.py:30")
    assert ev.done


def test_off_path_patches_nothing(monkeypatch):
    monkeypatch.delenv(ts.ENV_VAR, raising=False)
    before = (torch.from_numpy, torch.as_tensor, torch.Tensor.to,
              torch.Tensor.copy_)
    with ts.maybe_alias_sanitizer() as san:
        assert san is None
        assert (torch.from_numpy, torch.as_tensor, torch.Tensor.to,
                torch.Tensor.copy_) == before
    monkeypatch.setenv(ts.ENV_VAR, ts.ENV_VALUE)
    with ts.maybe_alias_sanitizer() as san:
        assert isinstance(san, ts.AliasSanitizer)
        assert torch.from_numpy is not before[0]
    assert (torch.from_numpy, torch.as_tensor, torch.Tensor.to,
            torch.Tensor.copy_) == before
    with pytest.raises(RuntimeError, match="not re-entrant"):
        with ts.alias_sanitizer():
            with ts.alias_sanitizer():
                pass


def test_cli_command_runs_under_the_sanitizer(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    argv = ["consensus", "--device", "cpu", "--n", "200", "--replicas", "32",
            "--m0", "0.0", "0.3", "--max-steps", "20"]
    outs = []
    for env in (None, ts.ENV_VALUE):
        if env is None:
            monkeypatch.delenv(ts.ENV_VAR, raising=False)
        else:
            monkeypatch.setenv(ts.ENV_VAR, env)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv) == 0
        doc = json.loads(buf.getvalue().strip().splitlines()[-1])
        doc.pop("wall_s", None)
        outs.append(doc)
    assert outs[0].keys() == outs[1].keys()
    for k in outs[0]:
        if "time" not in k and not k.endswith("_s"):
            assert outs[0][k] == outs[1][k], k
