"""The port's packed dynamics against the JAX package's, bit for bit.

Inputs are made with numpy from a seed; packed words cross between the
packages as uint32 numpy arrays (``graphdyn_torch.interop``). The port's
plain PyTorch rollout — what CPU tensors run — is held against the XLA
program under both gather schedules and against the Pallas kernels K1 and K2
run in interpret mode, as tests/test_pallas_packed.py runs them. The CUDA
kernel itself runs only on a GPU (chip_smoke.py holds it against the same
plain version there)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.ops import packed as jp
from graphdyn.ops.pallas_packed import (
    pallas_packed_rollout,
    pallas_packed_rollout_general,
    pallas_packed_supported,
)
from graphdyn_torch.interop import (
    graph_from_arrays,
    words_from_numpy,
    words_to_numpy,
)
from graphdyn_torch.ops import dynamics as td
from graphdyn_torch.ops import packed as tp
from graphdyn_torch.ops import packed_cuda

RULE_TIE = [("majority", "stay"), ("majority", "change"),
            ("minority", "stay"), ("minority", "change")]

GRAPHS = {
    "rrg3": jg.random_regular_graph(90, 3, seed=0),
    "rrg4": jg.random_regular_graph(80, 4, seed=1),
    "rrg5": jg.random_regular_graph(70, 5, seed=2),
    "er": jg.erdos_renyi_graph(120, 3.0 / 120, seed=3),   # ragged, isolates kept
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs small tensors here: one intra-op thread per test
    process avoids oversubscribing the cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _tables(g):
    return torch.from_numpy(g.nbr), torch.from_numpy(g.deg)


def _words(n, W, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, W), dtype=np.uint64).astype(np.uint32)


def _biased_words(n, R, seed, lo=0.0, hi=0.6):
    """Packed spins whose replicas have biases spread over ±[lo, hi]
    (alternating sign): strongly biased replicas flow to consensus within a
    few steps, weakly biased ones may never do."""
    rng = np.random.default_rng(seed)
    bias = np.linspace(lo, hi, R) * np.where(np.arange(R) % 2 == 0, 1, -1)
    s = np.where(rng.random((R, n)) < (1 + bias[:, None]) / 2, 1, -1)
    return jp.pack_spins(s.astype(np.int8))


def _port_rollout(g, words, steps, rule, tie):
    nbr, deg = _tables(g)
    return words_to_numpy(tp.packed_rollout(nbr, deg, words_from_numpy(words),
                                            steps, rule, tie))


@pytest.mark.parametrize("R", [1, 31, 32, 33, 64, 70])
def test_pack_spins_bit_identical_and_round_trip(R):
    rng = np.random.default_rng(R)
    s = (2 * rng.integers(0, 2, size=(R, 50)) - 1).astype(np.int8)
    s[:, 0] = 1            # every bit of row 0 set: bit 31 is set once R > 31
    ref = jp.pack_spins(s)
    out = tp.pack_spins(torch.from_numpy(s))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(words_to_numpy(out), ref)
    np.testing.assert_array_equal(tp.unpack_spins(out, R).numpy(), s)
    np.testing.assert_array_equal(
        tp.unpack_spins(words_from_numpy(ref), R).numpy(), jp.unpack_spins(ref, R))


def test_row_chunking_is_invisible(monkeypatch):
    """The row-chunked helpers give the unchunked answers (a tiny
    temporary budget forces many chunks)."""
    s = (2 * np.random.default_rng(0).integers(0, 2, size=(70, 301)) - 1
         ).astype(np.int8)
    words = jp.pack_spins(s)
    whole = tp._bit_counts(words_from_numpy(words))
    monkeypatch.setattr(tp, "_TEMP_BYTES", 3000)
    assert tp._row_chunk(2 * 3 * 32 * 8) == 1
    np.testing.assert_array_equal(words_to_numpy(tp.pack_spins(torch.from_numpy(s))),
                                  words)
    np.testing.assert_array_equal(tp.unpack_spins(words_from_numpy(words), 70).numpy(), s)
    torch.testing.assert_close(tp._bit_counts(words_from_numpy(words)), whole,
                               rtol=0, atol=0)


@pytest.mark.parametrize("gather", ["per_slot", "fused"])
@pytest.mark.parametrize("rule,tie", RULE_TIE)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_plain_rollout_matches_xla(name, rule, tie, gather):
    g = GRAPHS[name]
    words = _words(g.n, 3, seed=len(name))
    ref = np.asarray(jp._packed_rollout_device(
        jnp.asarray(g.nbr), jnp.asarray(g.deg), jnp.asarray(words), 5, rule,
        tie, gather))
    np.testing.assert_array_equal(_port_rollout(g, words, 5, rule, tie), ref)


@pytest.mark.parametrize("rule", ["majority", "minority"])
@pytest.mark.parametrize("d", [3, 5])
def test_plain_rollout_matches_pallas_k1(rule, d):
    g = jg.random_regular_graph(300, d, seed=2)
    words = _words(g.n, 2, seed=d)
    ref = np.asarray(pallas_packed_rollout(
        jnp.asarray(g.nbr), g.deg, jnp.asarray(words), 4, rule, block=128,
        depth=4, interpret=True))
    np.testing.assert_array_equal(_port_rollout(g, words, 4, rule, "stay"), ref)
    # K1's gate and the kernel's fast-path gate agree
    assert (packed_cuda.fast_path_degree(g.deg, rule) == d) == \
        pallas_packed_supported(g.deg, rule, "stay")


@pytest.mark.parametrize("rule,tie", RULE_TIE)
def test_plain_rollout_matches_pallas_k2(rule, tie):
    for g in (jg.remove_isolates(jg.erdos_renyi_graph(150, 3.0 / 149, seed=0))[0],
              jg.random_regular_graph(120, 4, seed=1)):
        words = _words(g.n, 2, seed=g.n)
        ref = np.asarray(pallas_packed_rollout_general(
            jnp.asarray(g.nbr), jnp.asarray(g.deg), jnp.asarray(words), 4,
            rule, tie, block=64, depth=4, interpret=True))
        np.testing.assert_array_equal(_port_rollout(g, words, 4, rule, tie), ref)
        assert packed_cuda.fast_path_degree(g.deg, rule) == 0
        assert not pallas_packed_supported(g.deg, rule, tie)


@pytest.mark.parametrize("rule", ["majority", "minority"])
def test_ghost_row_stays_zero_under_tie_change(rule):
    g = GRAPHS["er"]
    nbr, deg = _tables(g)
    step = tp._stepper(nbr, deg, rule, "change")
    ext = torch.cat([words_from_numpy(_words(g.n, 2, 4)),
                     torch.zeros(1, 2, dtype=torch.int32)])
    for _ in range(6):
        ext = step(ext)
        assert not bool(ext[g.n].ne(0).any())
    # the ghost's degree-0 count ties: without the forced write it would flip
    planes = [torch.zeros(1, 2, dtype=torch.int32)]
    _, eq = tp._compare_planes(planes, [torch.zeros(1, 1, dtype=torch.int32)])
    assert bool((eq == -1).all())


def _homogeneous_words(n, W, seed):
    words = _words(n, W, seed)
    words[:, 0] |= np.uint32(0x0000000F)          # replicas 0-3 all +1
    words[:, 0] &= ~np.uint32(0x000000F0)         # replicas 4-7 all -1
    words[:, -1] |= np.uint32(0x80000000)         # the top bit all +1
    return words


@pytest.mark.parametrize("target", [1, -1])
def test_consensus_mask_and_fraction_match_jax(target):
    words = _homogeneous_words(40, 3, 5)
    ref = np.asarray(jp.packed_consensus_mask(jnp.asarray(words), target))
    out = tp.packed_consensus_mask(words_from_numpy(words), target)
    np.testing.assert_array_equal(words_to_numpy(out[None])[0], ref)
    for R in (8, 70, 96):
        assert tp.packed_consensus_fraction(words_from_numpy(words), R, target) == \
            jp.packed_consensus_fraction(jnp.asarray(words), R, target)
    with pytest.raises(ValueError, match="capacity"):
        tp.packed_consensus_fraction(words_from_numpy(words), 97, target)


@pytest.mark.parametrize("R", [8, 70, 96])
def test_flags_from_counts_equal_jax_reductions(R):
    """The port derives the AND/OR column reductions from per-bit counts
    (torch has no bitwise reductions); they equal the JAX package's
    reductions, and the float32 magnetizations agree bit for bit with the
    compiled program the scan runs them in (jitted, n is a constant)."""
    bits_j = jax.jit(jp._consensus_bits, static_argnums=1)
    mag_j = jax.jit(jp._replica_magnetization, static_argnums=1)
    for n in (1, 37, 257):
        words = _homogeneous_words(n, 3, n)
        np.testing.assert_array_equal(
            tp._consensus_bits(words_from_numpy(words), R).numpy(),
            np.asarray(bits_j(jnp.asarray(words), R)))
        np.testing.assert_array_equal(
            tp._replica_magnetization(words_from_numpy(words), R).numpy(),
            np.asarray(mag_j(jnp.asarray(words), R)))


SCAN_CASES = {
    # name: (graph, words, max_steps, chunk, near_eps, rule, tie, lo bias)
    "er_early_exit": (jg.remove_isolates(jg.erdos_renyi_graph(
        300, 6.0 / 300, seed=6))[0], 2, 200, 2, 0.05, "majority", "stay", 0.15),
    "er_budget_spent": (jg.remove_isolates(jg.erdos_renyi_graph(
        300, 4.0 / 300, seed=5))[0], 3, 60, 10, 0.01, "majority", "stay", 0.0),
    "er_near_eps": (jg.remove_isolates(jg.erdos_renyi_graph(
        300, 6.0 / 300, seed=6))[0], 2, 40, 5, 0.1, "majority", "change", 0.0),
    "rrg4_minority": (jg.random_regular_graph(100, 4, seed=7), 1, 30, 10,
                      0.01, "minority", "change", 0.0),
    "zero_budget": (jg.random_regular_graph(60, 3, seed=8), 1, 0, 10, 0.01,
                    "majority", "stay", 0.0),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_consensus_scan_matches_jax(case):
    g, W, max_steps, chunk, near_eps, rule, tie, lo = SCAN_CASES[case]
    words = _biased_words(g.n, W * 32, seed=W, lo=lo)
    ref = jp.packed_consensus_scan(
        jnp.asarray(g.nbr), jnp.asarray(g.deg), jnp.asarray(words.copy()),
        R=W * 32, max_steps=max_steps, chunk=chunk, near_eps=near_eps,
        rule=rule, tie=tie)
    nbr, deg = _tables(g)
    sp = words_from_numpy(words)
    out = tp.packed_consensus_scan(nbr, deg, sp, R=W * 32, max_steps=max_steps,
                                   chunk=chunk, near_eps=near_eps, rule=rule,
                                   tie=tie)
    np.testing.assert_array_equal(words_to_numpy(sp), words)   # input untouched
    assert set(out) == set(ref)
    assert out["steps_run"] == int(ref["steps_run"])
    np.testing.assert_array_equal(words_to_numpy(out["sp"]), np.asarray(ref["sp"]))
    for key in ("strict", "strict_step", "near", "near_step", "m_final"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    if case == "er_early_exit":
        assert out["steps_run"] < max_steps and bool(out["near"].all())
    if case == "er_budget_spent":
        assert out["steps_run"] == max_steps and not bool(out["near"].all())


def test_consensus_scan_refuses_nondividing_chunk():
    g = GRAPHS["rrg3"]
    nbr, deg = _tables(g)
    sp = words_from_numpy(_words(g.n, 1, 0))
    with pytest.raises(ValueError, match="must divide"):
        tp.packed_consensus_scan(nbr, deg, sp, R=32, max_steps=25, chunk=10)
    with pytest.raises(ValueError, match="must divide"):
        jp.packed_consensus_scan(jnp.asarray(g.nbr), jnp.asarray(g.deg),
                                 jnp.asarray(words_to_numpy(sp)), R=32,
                                 max_steps=25, chunk=10)
    with pytest.raises(ValueError, match="capacity"):
        tp.packed_consensus_scan(nbr, deg, sp, R=33, max_steps=20, chunk=10)


@pytest.mark.parametrize("m0", [-0.3, 0.0, 0.1, 0.5])
def test_draw_packed_biased_bit_rate(m0):
    n, W = 2000, 4
    sp = tp.draw_packed_biased(123, n, W, m0, device="cpu")
    assert sp.shape == (n, W) and sp.dtype == torch.int32
    ones = int(tp._bit_counts(sp).sum())
    total = n * W * 32
    p = (1 + m0) / 2
    assert abs(ones - p * total) <= 5 * np.sqrt(total * p * (1 - p))
    assert torch.equal(sp, tp.draw_packed_biased(123, n, W, m0, device="cpu"))
    assert not torch.equal(sp, tp.draw_packed_biased(124, n, W, m0, device="cpu"))


def test_packed_end_state_matches_jax_and_int8_path():
    g = GRAPHS["er"]
    tg = graph_from_arrays(g.nbr, g.deg, g.edges)
    s = (2 * np.random.default_rng(9).integers(0, 2, size=(40, g.n)) - 1
         ).astype(np.int8)
    for rule, tie in RULE_TIE:
        ref = jp.packed_end_state(g, s, 6, rule, tie)
        out = tp.packed_end_state(tg, s, 6, rule, tie, device="cpu")
        assert out.dtype == torch.int8
        np.testing.assert_array_equal(out.numpy(), ref)
        np.testing.assert_array_equal(
            out.numpy(), td.run_dynamics(tg, s, 6, rule, tie, device="cpu").numpy())


def test_packed_rollout_refusals_and_identity():
    g = GRAPHS["rrg3"]
    nbr, deg = _tables(g)
    sp = words_from_numpy(_words(g.n, 1, 1))
    assert tp.packed_rollout(nbr, deg, sp, 0) is sp
    # node sharding is ported (tests/test_torch_halo.py): a P = 1 partition
    # is the single-device program, P >= 2 needs a process group of P ranks
    from graphdyn_torch.graphs import partition_graph

    want = tp.packed_rollout(nbr, deg, sp, 3)
    one = partition_graph(g, 1)
    assert torch.equal(tp.packed_rollout(nbr, deg, sp, 3, partition=one),
                       want)
    with pytest.raises(ValueError, match="process group"):
        tp.packed_rollout(nbr, deg, sp, 1, partition=partition_graph(g, 2))
    with pytest.raises(TypeError, match="int32"):
        tp.packed_rollout(nbr.long(), deg, sp, 1)
    with pytest.raises(ValueError, match="shapes"):
        tp.packed_rollout(nbr, deg, sp[:-1], 1)
    # a tensor on neither CPU nor CUDA is refused, never run on the CPU
    meta = [t.to("meta") for t in (nbr, deg, sp)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tp.packed_rollout(*meta, 1)


def test_kernel_gate_and_plane_count():
    assert packed_cuda.fast_path_degree(np.full(10, 3, np.int32), "majority") == 3
    assert packed_cuda.fast_path_degree(torch.full((10,), 5, dtype=torch.int32),
                                        "minority") == 5
    assert packed_cuda.fast_path_degree(np.full(10, 4, np.int32), "majority") == 0
    assert packed_cuda.fast_path_degree(np.array([3, 3, 1], np.int32), "majority") == 0
    assert packed_cuda.fast_path_degree(np.zeros(0, np.int32), "majority") == 0
    for d in (1, 3, 19, 20):
        deg = np.full(8, d, np.int32)
        assert (packed_cuda.fast_path_degree(deg, "majority") > 0) == \
            pallas_packed_supported(deg, "majority", "stay")
    assert [packed_cuda.n_planes(d) for d in (0, 1, 2, 3, 4, 7, 8, 63, 64)] == \
        [1, 1, 2, 2, 3, 3, 4, 6, 7]


def test_kernel_table_check_refuses_out_of_range_tables():
    """The kernel reads nbr[i, :deg[i]] and rows nbr[i, j] of the state:
    tables outside [0, n] / [0, dmax] are refused before any launch."""
    g = GRAPHS["er"]
    nbr, deg = _tables(g)
    packed_cuda.check_tables(nbr, deg)
    for bad_nbr, bad_deg in ((nbr.clone().fill_(g.n + 1), deg),
                             (nbr.clone().fill_(-1), deg),
                             (nbr, deg.clone().fill_(g.dmax + 1)),
                             (nbr, deg.clone().fill_(-1))):
        with pytest.raises(ValueError, match="out of range"):
            packed_cuda.check_tables(bad_nbr, bad_deg)


def test_interop_words_round_trip():
    words = np.array([[0, 1, 0x7FFFFFFF], [0x80000000, 0xFFFFFFFF, 0xDEADBEEF]],
                     np.uint32)
    t = words_from_numpy(words)
    assert t.dtype == torch.int32
    assert t.tolist() == [[0, 1, 2**31 - 1], [-2**31, -1, 0xDEADBEEF - 2**32]]
    np.testing.assert_array_equal(words_to_numpy(t), words)
    with pytest.raises(TypeError):
        words_to_numpy(t.long())
    g = GRAPHS["er"]
    tg = graph_from_arrays(g.nbr, g.deg, g.edges)
    for a, b in zip(tg, g):
        np.testing.assert_array_equal(a, b)
