"""The port's row gather P against the JAX probe's Pallas kernel: the plain
version equals ``pallas_gather(..., interpret=True)`` on the JAX probe's
``--check`` shape (512×128 uint32 source, 1024 indices, block 256, depth
4), bit for bit — a gather moves words, so there is no tolerance. Also the
dispatch rules, the wrapper's checks on CPU tensors, the probe's
constant-bytes rule and byte bound, and ``--check --device cpu``. The CUDA
kernel runs only on a GPU; ``chip_smoke.py`` holds it against
``index_select`` there."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphdyn_torch import interop
from graphdyn_torch.ops import gather_cuda
from graphdyn_torch.ops.gather import row_gather, row_gather_plain
from graphdyn_torch.scripts import gather_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_probe():
    """``scripts/pallas_gather_probe.py`` as a module (scripts/ is not a
    package)."""
    path = os.path.join(REPO, "scripts", "pallas_gather_probe.py")
    spec = importlib.util.spec_from_file_location("pallas_gather_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_inputs():
    """The JAX probe's --check draw (`pallas_gather_probe.py:124-126`)."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, 2**32, size=(512, 128), dtype=np.uint32)
    idx = rng.integers(0, 512, size=1024).astype(np.int32)
    return src, idx


def test_plain_equals_pallas_gather_interpret():
    src, idx = _check_inputs()
    want = np.asarray(_jax_probe().pallas_gather(
        jnp.asarray(src), jnp.asarray(idx), block=256, depth=4,
        interpret=True))
    got = row_gather(interop.words_from_numpy(src), torch.from_numpy(idx))
    np.testing.assert_array_equal(interop.words_to_numpy(got), want)
    assert (src[idx] >= 2**31).any()         # top-bit words moved intact


@pytest.mark.parametrize("W", [1, 3, 16, 32, 128])
@pytest.mark.parametrize("n_idx", [1, 255, 1000])
def test_plain_matches_numpy_with_repeats(W, n_idx):
    rng = np.random.default_rng(W * 1000 + n_idx)
    src = rng.integers(0, 2**32, size=(50, W), dtype=np.uint32)
    idx = rng.integers(0, 50, size=n_idx).astype(np.int32)
    for kernel in ("auto", "plain"):
        got = row_gather(interop.words_from_numpy(src), torch.from_numpy(idx),
                         kernel=kernel)
        assert got.dtype == torch.int32 and got.shape == (n_idx, W)
        np.testing.assert_array_equal(interop.words_to_numpy(got), src[idx])


def test_dispatch_never_launches_on_cpu_and_refuses_cuda_there():
    src = torch.arange(40, dtype=torch.int32).reshape(10, 4)
    idx = torch.tensor([3, 3, 0], dtype=torch.int32)
    before = gather_cuda.LAUNCHES
    assert torch.equal(row_gather(src, idx), row_gather_plain(src, idx))
    assert gather_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA row-gather kernel"):
        row_gather(src, idx, kernel="cuda")
    with pytest.raises(ValueError, match="kernel must be"):
        row_gather(src, idx, kernel="pallas")
    with pytest.raises(ValueError, match="not CUDA"):
        gather_cuda.row_gather_cuda(src, idx)


@pytest.mark.parametrize("bad,match", [
    (lambda s, i: (s.to(torch.int64), i), "not int32 words"),
    (lambda s, i: (s, i.to(torch.int64)), "not int32"),
    (lambda s, i: (s.t(), i), "not contiguous"),
    (lambda s, i: (s.reshape(-1), i), "shape"),
    (lambda s, i: (s, i.reshape(1, -1)), "shape"),
])
def test_launch_checks(bad, match, monkeypatch):
    src = torch.arange(40, dtype=torch.int32).reshape(10, 4)
    idx = torch.tensor([3, 3, 0], dtype=torch.int32)
    s, i = bad(src, idx)
    # the device check comes after these: pretend the tensors are on CUDA
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: torch.device("cuda", 0)))
    with pytest.raises((TypeError, ValueError), match=match):
        gather_cuda.check_launch(s, i, gather_cuda.DEFAULT_DEPTH)


def test_depths_and_vector_words():
    src = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="depth"):
        gather_cuda.check_launch(src, torch.zeros(2, dtype=torch.int32), 3)
    assert gather_cuda.DEFAULT_DEPTH in gather_cuda.DEPTHS
    out = torch.empty((2, 4), dtype=torch.int32)
    assert gather_cuda.vector_words(src, out) == (
        src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    flat = torch.zeros(33, dtype=torch.int32)
    assert not gather_cuda.vector_words(flat[1:].view(8, 4), out)
    assert not gather_cuda.vector_words(torch.zeros((8, 3), dtype=torch.int32),
                                        torch.empty((2, 3), dtype=torch.int32))


@pytest.mark.parametrize("W,aligned,path,depth,streaming", [
    (1, True, "words", 8, True), (3, True, "words", 8, True),
    (4, True, "vector", 4, True), (4, False, "words", 8, True),
    (8, True, "vector", 4, True), (12, True, "vector", 4, True),
    (16, True, "vector", 4, True), (16, False, "words", 8, True),
    (28, True, "vector", 4, True), (30, True, "words", 8, True),
    (32, True, "vector", 2, True), (32, False, "words", 8, True),
    (64, True, "vector", 2, True), (128, True, "vector", 2, True),
    (256, True, "vector", 2, True), (508, True, "vector", 2, True),
    (511, True, "words", 8, True), (512, True, "vector", 1, False),
    (512, False, "words", 8, True), (1024, True, "vector", 1, False),
    (513, True, "words", 8, True), (2048, True, "vector", 1, False),
    (4096, True, "vector", 1, False), (16384, True, "vector", 1, False),
])
def test_launch_plan_path_selection(W, aligned, path, depth, streaming):
    """The plan's path and depth per row width: rows of a multiple of 4
    words (16 bytes) with both arrays 16-byte aligned take the 16-byte
    vector path, at depth 1 with write-back stores from 512 words, depth 2
    from 32, depth 4 below; other rows single words at depth 8, streaming.
    A depth given to the launch replaces the plan's and keeps its path and
    store policy."""
    plan = gather_cuda.launch_plan(W, aligned)
    assert plan == {"path": path, "depth": depth, "streaming": streaming}
    assert plan["depth"] in gather_cuda.DEPTHS
    assert gather_cuda.launch_plan(W, aligned, depth=16) == {
        "path": path, "depth": 16, "streaming": streaming}
    assert gather_cuda.PATHS[plan["path"]] == int(path == "vector")


def test_probe_rule_and_bound():
    """The JAX probe's constant-bytes rule (`pallas_gather_probe.py:136`)
    and the byte bound of one gather (each distinct source row read once)."""
    for n_idx in (3_000_000, 1000, 10):
        for W in (1, 16, 128, 512, 1024):
            want = max(256, (n_idx * 128 // W) // 256 * 256)
            assert gather_probe.probe_n_idx(n_idx, W) == want
    b = gather_probe.gather_bound(3_000_000, 128, 950_000)
    assert b["bytes"] == (950_000 + 3_000_000) * 128 * 4 + 3_000_000 * 4
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)


def test_probe_check_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert gather_probe.main(["--check", "--device", "cpu"]) == 0
    assert json.loads(buf.getvalue()) == {"check": "ok", "device": "cpu"}


def test_probe_without_device_refuses_on_cuda_less_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    proc = subprocess.run(
        [sys.executable, "-m", "graphdyn_torch.scripts.gather_probe"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr and proc.stdout == ""
