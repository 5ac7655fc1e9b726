"""``hpr_solve_batch(device_init=True)`` in the port: the initial chi,
biases and chain seeds drawn on the device from the Threefry init stream.

- The draw is deterministic in its seed, its bits equal a numpy mirror of
  the stream (so they cannot depend on the device that draws them: the
  card's run is held to the CPU's in ``chip_smoke.py``), and a pinned
  digest keeps the stream from drifting.
- Every chi row sums to 1 and every bias row to 1 (float32 rounding).
- Its moments agree with the host draw's (the port's numpy init) and with
  the JAX package's ``draw_chi_device`` (``jax.random``): the streams
  differ, so the comparison is statistical.
- The refusals of the JAX package (``mesh=``, ``checkpoint_path=``) and a
  whole batched run from the device init on the CPU."""

import hashlib

import jax
import numpy as np
import pytest
import torch

from graphdyn.ops import bdcm as jb
from graphdyn_torch.config import HPRConfig
from graphdyn_torch.graphs import random_regular_graph
from graphdyn_torch.models import hpr as th
from graphdyn_torch.ops import bdcm as tb
from graphdyn_torch.ops.fused import threefry2x32
from graphdyn_torch.pipeline.hpr_group import host_init

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _mirror(seed, purpose, count, dtype):
    """The init stream in numpy (the cipher on int64 arrays)."""
    j = np.arange(count, dtype=np.int64)
    y0, y1 = threefry2x32(np.int64(seed), np.int64(tb.HPR_INIT_TAG + purpose),
                          j >> 32, j & 0xFFFFFFFF)
    if dtype == np.float32:
        return (y0 >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24))
    return ((y0 << 21) | (y1 >> 11)).astype(np.float64) * (1.0 / (1 << 53))


def _tree(x):
    m = x.shape[-1]
    while m > 1:
        m //= 2
        x = x[..., :m] + x[..., m:]
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [2, 4, 8])
def test_device_init_bits_equal_the_numpy_mirror(dtype, K):
    R, n, twoE, seed = 3, 17, 40, 123
    chi, b, s, seeds = th.device_init_state(R, n, twoE, K, dtype, seed, CPU)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    u = _mirror(seed, 0, R * twoE * K * K, npdt).reshape(R * twoE, K * K)
    want_chi = (u / _tree(u)).reshape(R * twoE, K, K)
    assert chi.dtype == dtype and chi.shape == (R * twoE, K, K)
    np.testing.assert_array_equal(chi.numpy(), want_chi)
    ub = _mirror(seed, 1, 2 * R * n, npdt).reshape(R * n, 2)
    want_b = ub / (ub[:, :1] + ub[:, 1:])
    np.testing.assert_array_equal(b.numpy(), want_b)
    np.testing.assert_array_equal(
        s.numpy(), np.where(want_b[:, 0] > want_b[:, 1], 1, -1).astype(np.int8))
    j = np.arange(R, dtype=np.int64)
    want_seeds = threefry2x32(np.int64(seed), np.int64(tb.HPR_INIT_TAG + 2),
                              j >> 32, j)[0]
    np.testing.assert_array_equal(seeds.numpy(), want_seeds)
    assert ((seeds >= 0) & (seeds <= 0xFFFFFFFF)).all()


def test_device_init_is_deterministic_and_pinned():
    a = th.device_init_state(4, 10, 30, 4, torch.float32, 7, CPU)
    b = th.device_init_state(4, 10, 30, 4, torch.float32, 7, CPU)
    c = th.device_init_state(4, 10, 30, 4, torch.float32, 8, CPU)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    h = hashlib.sha256()
    for x in a:
        h.update(x.numpy().tobytes())
    assert h.hexdigest()[:16] == PINNED_DIGEST


#: sha256 of the draw above (chi, biases, s0, seeds bytes), first 16 hex
PINNED_DIGEST = "3e42badbfd470e26"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_are_normalized(dtype):
    chi, b, _, _ = th.device_init_state(2, 50, 300, 8, dtype, 3, CPU)
    tol = 64 * torch.finfo(dtype).eps
    assert (chi.sum(dim=(1, 2)) - 1).abs().max() <= tol
    assert (b.sum(dim=1) - 1).abs().max() <= 4 * torch.finfo(dtype).eps
    assert (chi > 0).all() and (b > 0).all()


def test_moments_match_the_host_and_jax_draws():
    R, n, twoE, K = 8, 500, 1500, 4
    chi, b, s, _ = th.device_init_state(R, n, twoE, K, torch.float32, 11, CPU)
    chi_h, b_h, s_h = host_init(np.random.default_rng(11), R * twoE, K, R * n,
                                np.float32)
    chi_j = np.asarray(jb.draw_chi_device(jax.random.key(11), R * twoE, K,
                                          np.float32))
    mean = 1.0 / (K * K)
    for x in (chi.numpy(), chi_h, chi_j):
        assert abs(x.mean() - mean) < 1e-6       # rows sum to 1 exactly-ish
    sd = [float(x.std()) for x in (chi.numpy(), chi_h, chi_j)]
    assert max(sd) / min(sd) < 1.02, sd
    # biases: b0 uniform-ratio around 1/2, s0 = +1 about half the time
    assert abs(float(b[:, 0].mean()) - float(b_h[:, 0].mean())) < 0.02
    assert abs(float((s == 1).float().mean()) - float((s_h == 1).mean())) \
        < 0.03


def test_refusals_match_the_jax_package(tmp_path):
    g = random_regular_graph(20, 3, seed=0)
    with pytest.raises(ValueError, match="incompatible with mesh="):
        th.hpr_solve_batch(g, n_replicas=2, device_init=True, mesh=object(),
                           device=CPU)
    with pytest.raises(ValueError, match="incompatible with checkpoint_path="):
        th.hpr_solve_batch(g, n_replicas=2, device_init=True,
                           checkpoint_path=str(tmp_path / "ck"), device=CPU)


def test_batched_run_from_the_device_init():
    g = random_regular_graph(60, 3, seed=1)
    cfg = HPRConfig(max_sweeps=60)
    a = th.hpr_solve_batch(g, cfg, n_replicas=3, seed=5, device_init=True,
                           device=CPU)
    b = th.hpr_solve_batch(g, cfg, n_replicas=3, seed=5, device_init=True,
                           device=CPU)
    for f in ("s", "num_steps", "m_final"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.s.shape == (3, 60)
    assert set(np.unique(a.m_final).tolist()) <= {1.0, 2.0}
    assert (a.num_steps >= 0).all()
