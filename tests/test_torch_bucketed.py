"""The port's degree-bucketed rollout against the JAX package's, and KB's
launch table on the CPU.

Every comparison is bit for bit (packed integer words, no tolerance):

- the port's plain ``bucketed_rollout_global`` equals the JAX package's
  ``bucketed_rollout_global`` across rule × tie × route on
  ``powerlaw_graph(600, 2.3, 2, 7)`` (the case of ``tests/test_bucketed.py:
  49-68``, whose hub bucket is wider than 32, so the wide path runs), and
  the port's padded ``packed_rollout_plain`` on the same graph; on a ragged
  ER graph against the padded plain rollout (and the JAX package's on one
  pair); at zero steps;
- the plain padded rollout past the packed kernel's old dmax 63 (a hub of
  degree 70; the power-law graph above, dmax 163, against the bucketed
  rollouts) equals the JAX package's ``packed_rollout``;
- KB's segment table (``bucketed_cuda.launch_table``/``index_map``): every
  output row and word is served once, by its bucket, with its own row.
"""

import numpy as np
import pytest
import torch

import graphdyn.graphs as jg
from graphdyn.ops.bucketed import bucketed_rollout_global as jax_bucketed
from graphdyn.ops.packed import packed_rollout as jax_packed
import graphdyn_torch.graphs as tg
from graphdyn_torch.interop import words_from_numpy, words_to_numpy
from graphdyn_torch.ops import bucketed as tb
from graphdyn_torch.ops import bucketed_cuda, packed_cuda
from graphdyn_torch.ops.packed import packed_rollout_plain

RULE_TIES = [("majority", "stay"), ("majority", "change"),
             ("minority", "stay"), ("minority", "change")]


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


def _words(n, W, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, W), dtype=np.uint64).astype(
        np.uint32)


def _pl600(m):
    return m.powerlaw_graph(600, gamma=2.3, dmin=2, seed=7)


def _padded_plain(g, sp, steps, rule, tie):
    return packed_rollout_plain(torch.from_numpy(g.nbr),
                                torch.from_numpy(g.deg), sp, steps, rule, tie)


@pytest.mark.parametrize("route", list(tb.ROUTES))
@pytest.mark.parametrize("rule,tie", RULE_TIES)
def test_bucketed_global_equals_jax_and_padded_on_powerlaw(rule, tie, route):
    g_j, g_t = _pl600(jg), _pl600(tg)
    assert g_t.dmax > tb.UNROLL_MAX            # the wide path runs
    sp = _words(g_t.n, 2, seed=1)
    want = np.asarray(jax_bucketed(g_j, sp, 3, rule, tie, route))
    got = tb.bucketed_rollout_global(g_t, words_from_numpy(sp), 3, rule, tie,
                                     route)
    np.testing.assert_array_equal(words_to_numpy(got), want)
    assert torch.equal(got, _padded_plain(g_t, words_from_numpy(sp), 3, rule,
                                          tie))


def test_bucketed_ragged_er_zero_steps_and_layout_reuse():
    g_j = jg.erdos_renyi_graph(200, 4.0 / 199, seed=3)
    g_t = tg.erdos_renyi_graph(200, 4.0 / 199, seed=3)
    assert (g_t.deg == 0).any() and len(tg.degree_buckets(g_t).widths) > 2
    sp = words_from_numpy(_words(g_t.n, 3, seed=2))
    b = tg.degree_buckets(g_t, seed=4)             # a shuffled layout
    for rule, tie in RULE_TIES:
        want = _padded_plain(g_t, sp, 4, rule, tie)
        for route in tb.ROUTES:
            got = tb.bucketed_rollout_global(g_t, sp, 4, rule, tie, route,
                                             buckets=b)
            assert torch.equal(got, want), (rule, tie, route)
    jax_want = np.asarray(jax_bucketed(g_j, words_to_numpy(sp), 4))
    np.testing.assert_array_equal(
        words_to_numpy(tb.bucketed_rollout_global(g_t, sp, 4)), jax_want)
    for steps in (0, -1):
        assert torch.equal(tb.bucketed_rollout_global(g_t, sp, steps), sp)
    # the bucketed-order entry: the state permuted in, the output permuted
    b0 = tg.degree_buckets(g_t)
    order = torch.from_numpy(b0.order)
    inv = torch.from_numpy(b0.inv)
    out = tb.bucketed_rollout(b0, sp[order], 2)
    assert torch.equal(out[inv], _padded_plain(g_t, sp, 2, "majority",
                                               "stay"))
    assert torch.equal(tb.bucketed_rollout_plain(b0, sp[order], 2), out)


def test_bucketed_refusals():
    g = tg.random_regular_graph(20, 3, seed=0)
    sp = torch.zeros((20, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="route"):
        tb.bucketed_rollout_global(g, sp, 1, route="xla")
    with pytest.raises(ValueError, match="int32"):
        tb.bucketed_rollout_global(g, sp[:5], 1)
    with pytest.raises(ValueError, match="int32"):
        tb.bucketed_rollout_global(g, sp.long(), 1)


def test_plain_padded_rollout_past_dmax63_equals_jax():
    """A hub of degree 70 (seven bit planes) on a ragged ER graph: the JAX
    package's per-slot program compiles in seconds at this dmax."""
    er = tg.erdos_renyi_graph(300, 3.0 / 299, seed=6)
    hub = np.array([[0, v] for v in range(1, 71)])
    edges = np.concatenate([hub, er.edges[(er.edges != 0).all(axis=1)]])
    g_j, g_t = jg.from_edgelist(edges, n=300), tg.from_edgelist(edges, n=300)
    assert g_t.dmax == 70 and packed_cuda.n_planes(g_t.dmax) == 7
    sp = _words(g_t.n, 2, seed=3)
    want = np.asarray(jax_packed(g_j.nbr, g_j.deg, sp, 3, "majority",
                                 "change"))
    got = _padded_plain(g_t, words_from_numpy(sp), 3, "majority", "change")
    np.testing.assert_array_equal(words_to_numpy(got), want)


def test_packed_kernel_planes_cover_every_int32_degree():
    """The lifted K1/K2': the launch admits any dmax whose bit planes fit
    the widest instantiation (32 planes: every int32 degree), and each
    plane count runs an instantiation with at least that many planes."""
    assert packed_cuda.MAX_PLANES == 32
    assert packed_cuda.n_planes(2**31 - 1) <= packed_cuda.MAX_PLANES
    assert packed_cuda.n_planes(19_617) == 15
    got = [packed_cuda.kernel_planes(p) for p in range(1, 33)]
    assert got[:6] == [1, 2, 3, 4, 5, 6]
    assert all(k >= p for p, k in zip(range(1, 33), got))
    assert set(got[6:]) == {8, 16, 32}
    assert packed_cuda.kernel_planes(15) == 16


def _covered(table, W, U, n_rows):
    seen = {}
    for seg, row, w0, words, self_row in bucketed_cuda.index_map(table, W, U):
        assert self_row == row
        for w in range(w0, w0 + words):
            assert (row, w) not in seen, (row, w)
            seen[(row, w)] = seg
    assert len(seen) == n_rows * W
    return seen


@pytest.mark.parametrize("W", [1, 3, 4, 32])
def test_launch_table_serves_every_row_once_with_its_width(W):
    g = _pl600(tg)
    b = tg.degree_buckets(g)
    segs = [(nb.shape[0], nb.shape[1], int(b.offsets[k]))
            for k, nb in enumerate(b.nbr)]
    U = bucketed_cuda.words_per_thread(W)
    geo = bucketed_cuda.wide_geometry(W, U)
    order = bucketed_cuda.launch_order(b.widths)
    table, blocks, ws_rows = bucketed_cuda.launch_table(
        [segs[k] for k in order], W, U)
    assert table.shape == (b.B, bucketed_cuda.COLS)
    assert (table[:, 6:] == 0).all()                 # pointers: the wrapper's
    np.testing.assert_array_equal(table[:, 3], [b.widths[k] for k in order])
    np.testing.assert_array_equal(table[:, 2], b.offsets[:-1][order])
    assert (np.diff(table[:, 0]) > 0).all() and table[0, 0] == 0
    assert blocks > table[-1, 0]
    wide = table[:, 3] > tb.UNROLL_MAX
    assert wide[:wide.sum()].all()                   # the hubs run first
    np.testing.assert_array_equal(
        table[wide, 4], -(-table[wide, 3] // geo["chunk"]))
    assert (table[~wide, 4] == 0).all() and (table[~wide, 5] == -1).all()
    multi = table[:, 4] > 1
    assert ws_rows == table[multi, 1].sum()
    if multi.any():                                  # workspace rows, in turn
        np.testing.assert_array_equal(
            table[multi, 5], np.cumsum(table[multi, 1]) - table[multi, 1])
    seen = _covered(table, W, U, g.n)
    for (row, _), seg in seen.items():
        k = order[seg]
        assert b.offsets[k] <= row < b.offsets[k + 1]


@pytest.mark.parametrize("W,U", [(1, 1), (3, 1), (4, 4), (8, 4), (32, 4),
                                 (512, 4), (5, 1)])
def test_wide_geometry_and_chunks_cover_every_slot_once(W, U):
    geo = bucketed_cuda.wide_geometry(W, U)
    vpr = W // U
    vl = geo["vlanes"]
    assert vl & (vl - 1) == 0 and vl <= 32 and geo["G"] * vl >= vpr
    assert (geo["G"] - 1) * vl < vpr                 # no empty vector group
    assert geo["chunk"] == (32 // vl) * bucketed_cuda.SLOTS_PER_LANE
    for d in (33, geo["chunk"], geo["chunk"] + 1, 19_617):
        n_chunks = -(-d // geo["chunk"])
        slots = [j for c in range(n_chunks)
                 for j in bucketed_cuda.chunk_slots(W, U, c) if j < d]
        assert sorted(slots) == list(range(d))


def test_launch_order_puts_the_hubs_first():
    assert bucketed_cuda.launch_order([1, 2, 64, 32, 256, 128]) == \
        [4, 5, 2, 0, 1, 3]
    # a synthetic layout with two rows per width, as the bench graph's
    # buckets 1..32768
    segs, row0 = [], 0
    for w in [2**k for k in range(16)]:
        segs.append((2, w, row0))
        row0 += 2
    order = bucketed_cuda.launch_order([s[1] for s in segs])
    table, _, ws_rows = bucketed_cuda.launch_table(
        [segs[k] for k in order], 8, 4)
    _covered(table, 8, 4, row0)
    chunk = bucketed_cuda.wide_geometry(8, 4)["chunk"]
    assert ws_rows == 2 * sum(1 for s in segs if s[1] > chunk)
    with pytest.raises(ValueError, match="segments"):
        bucketed_cuda.launch_table(segs * 3, 8, 4)
    with pytest.raises(ValueError, match="multiple"):
        bucketed_cuda.launch_table(segs, 6, 4)


def test_kb_wrapper_refuses_cpu_tensors_and_cpu_path_never_launches():
    g = _pl600(tg)
    b = tg.degree_buckets(g)
    tabs = tb.device_buckets(b, torch.device("cpu"))
    ext = torch.zeros((g.n + 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="not CUDA"):
        bucketed_cuda.bucketed_step([(nb, dg, None, r0) for nb, dg, r0 in tabs],
                                    ext, ext.clone(), rule="majority",
                                    tie="stay", ghost_row=g.n)
    before = bucketed_cuda.LAUNCHES
    tb.bucketed_rollout(b, ext[:-1], 3)
    assert bucketed_cuda.LAUNCHES == before


def test_device_layout_is_built_once_per_layout_and_bounded():
    """A layout's device tables are made at its first rollout and reused by
    later calls on the same layout object; an equal but distinct layout gets
    its own, and only the last few layouts are kept."""
    g = _pl600(tg)
    b = tg.degree_buckets(g)
    cpu = torch.device("cpu")
    tabs, launches = tb._device_layout(b, cpu)
    assert tb._device_layout(b, cpu)[0] is tabs
    assert tb._device_layout(b, cpu)[1] is launches
    sp = words_from_numpy(_words(g.n, 2, 5))
    first = tb.bucketed_rollout(b, sp, 3)
    assert tb._device_layout(b, cpu)[0] is tabs
    assert torch.equal(tb.bucketed_rollout(b, sp, 3), first)
    others = [tg.degree_buckets(g) for _ in range(tb._DEVICE_LAYOUTS_MAX)]
    assert tb._device_layout(others[0], cpu)[0] is not tabs
    for o in others[1:]:
        tb._device_layout(o, cpu)
    assert len(tb._DEVICE_LAYOUTS) <= tb._DEVICE_LAYOUTS_MAX
    assert all(key[1] != id(b) or hit[0] is not b
               for key, hit in tb._DEVICE_LAYOUTS.items())
    assert tb._device_layout(b, cpu)[0] is not tabs
    assert torch.equal(tb.bucketed_rollout(b, sp, 3), first)
