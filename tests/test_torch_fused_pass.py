"""The one-pass fused class step: the ball-local plain class step against
the JAX package's ``fused_chunk_xla`` bit for bit, step by step; the class
rows decided in shuffled chunks, in place, against the class step (the
property the CUDA kernel's one pass rests on); the refusal of class masks
whose balls overlap; and the kernel's lane plan.

The CUDA kernel runs only on a GPU; ``chip_smoke.py`` holds it against the
same plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.config import DynamicsConfig as JDyn, SAConfig as JSA
from graphdyn.ops import pallas_anneal as jpa
from graphdyn.search import fused as jsf
from graphdyn_torch import interop
from graphdyn_torch.config import DynamicsConfig, SAConfig
from graphdyn_torch.graphs import erdos_renyi_graph, random_regular_graph
from graphdyn_torch.ops import fused as tf
from graphdyn_torch.ops import fused_cuda
from graphdyn_torch.search import fused as tsf

CPU = torch.device("cpu")
RULE_TIES = [("majority", "stay"), ("majority", "change"),
             ("minority", "stay"), ("minority", "change")]

JAX_GRAPHS = {
    "rrg3": lambda: jg.random_regular_graph(64, 3, seed=0),
    "rrg4": lambda: jg.random_regular_graph(60, 4, seed=1),
    "rrg5": lambda: jg.random_regular_graph(72, 5, seed=2),
    "er": lambda: jg.erdos_renyi_graph(80, 3.0 / 80, seed=3),  # ragged
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


def _assert_state_equal(got: tf.FusedState, want, what: str):
    g = interop.fused_state_to_numpy(got)
    for name in want._fields:
        np.testing.assert_array_equal(g[name], np.asarray(getattr(want, name)),
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("rule,tie", RULE_TIES)
@pytest.mark.parametrize("gname", list(JAX_GRAPHS))
def test_ball_local_class_step_equal_xla(gname, rule, tie, W):
    """The plain class step, which evaluates the LUT end states only at the
    class rows' balls and flips the rows chunk by chunk in place, against
    ``fused_chunk_xla`` one class step at a time over 3χ+1 steps, in every
    ``FusedState`` field."""
    g = JAX_GRAPHS[gname]()
    jcfg = JSA(dynamics=JDyn(p=1, c=1, rule=rule, tie=tie))
    R = 32 * W - 3                                   # pad replicas present
    state, tdev, static, tables, _, _, _ = jsf._assemble_fused(
        g, jcfg, n_replicas=R, seed=W, m_target=1.0, betas=None, tables=None)
    st = interop.fused_state_from_jax(state)
    td = interop.fused_device_tables_from_jax(tdev)
    for t in range(3 * tables.chi + 1):
        state = jpa.fused_chunk_xla(state, jnp.uint32(W), *tdev, chunk_steps=1,
                                    stop_on_first=False, **static)
        st = tf._fused_class_step(st, W, td, **static)
        _assert_state_equal(st, state, f"class step {t + 1}")
    assert int(st.accepted) > 0


@pytest.mark.parametrize("rule,tie", RULE_TIES)
@pytest.mark.parametrize("gname", ["rrg3", "rrg5", "er"])
def test_shuffled_chunks_in_place_equal_class_step(gname, rule, tie):
    """The class rows decided in a random order, in chunks of 7, each chunk
    evaluating its balls' end states on the state as the earlier chunks
    left it and flipping its rows in place, give the class step's words and
    ``Σs_end`` at every one of 3χ+1 steps: what the kernel's one pass,
    with its blocks in no set order, computes."""
    g = {"rrg3": lambda: random_regular_graph(600, 3, seed=0),
         "rrg5": lambda: random_regular_graph(500, 5, seed=1),
         "er": lambda: erdos_renyi_graph(600, 3.0 / 600, seed=2)}[gname]()
    cfg = SAConfig(dynamics=DynamicsConfig(p=1, c=1, rule=rule, tie=tie))
    st, td, static, tables, _, W, Rp = tsf._assemble_fused(
        g, cfg, n_replicas=61, seed=5, m_target=1.0, betas=None, tables=None,
        device=CPU)
    n, dmax, chi = static["n"], static["dmax"], static["chi"]
    rng = np.random.default_rng(7)
    for t in range(3 * chi + 1):
        want = tf._fused_class_step(st, 5, td, **static)
        c = int(st.steps) % chi
        rows = tf._class_rows(td, c)
        rows = rows[torch.from_numpy(rng.permutation(rows.numel()))]
        cur = st._replace(sp_ext=st.sp_ext.clone())
        end = torch.zeros_like(cur.sp_ext)
        end_all = torch.zeros_like(cur.sp_ext)
        dsend_tot = torch.zeros(Rp, dtype=torch.int64)
        for i0 in range(0, rows.numel(), 7):
            dsend, acc = tf._class_chunk(cur, 5, td, rows[i0:i0 + 7], c, end,
                                         end_all, n=n, dmax=dmax)
            dsend_tot += (dsend * acc).sum(dim=0)
        assert torch.equal(cur.sp_ext, want.sp_ext), f"step {t + 1}"
        assert torch.equal(st.sum_end + dsend_tot.to(torch.int32),
                           want.sum_end), f"step {t + 1}"
        st = want
    assert int(st.accepted) > 0


def _hand_tables():
    """RRG(40, 3) and a maker of its device tables from given class
    masks."""
    g = random_regular_graph(40, 3, seed=4)
    cfg = SAConfig(dynamics=DynamicsConfig(p=1, c=1))
    _, td, _, _, _, _, _ = tsf._assemble_fused(
        g, cfg, n_replicas=8, seed=0, m_target=1.0, betas=None, tables=None,
        device=CPU)
    return g, lambda m: tf.fused_device_tables(
        m, td.facs[:m.shape[0]], td.nbr_ext, td.nbr_self, td.lut_masks,
        td.a_caps, td.b_caps)


def test_device_tables_refuse_overlapping_balls():
    """Class masks with two adjacent rows, or two rows that share a
    neighbour, are refused with the reason; two rows at distance 3 pass."""
    g, make = _hand_tables()
    nbr = g.nbr
    n = g.n
    i = 0
    j_adj = int(nbr[i, 0])
    k_mid = int(nbr[i, 1])
    j_two = next(int(x) for x in nbr[k_mid] if x != i and x not in nbr[i])
    dist = np.full(n, -1)
    dist[i], frontier = 0, [i]
    for step in range(1, 4):
        frontier = [int(y) for x in frontier for y in nbr[x] if dist[y] < 0]
        dist[frontier] = step
    j_far = int(np.flatnonzero(dist == 3)[0])

    def masks(*rows):
        m = torch.zeros((1, n + 1), dtype=torch.int32)
        m[0, list(rows)] = -1
        return m

    with pytest.raises(ValueError, match=rf"rows {min(i, j_adj)} and "
                                         rf"{max(i, j_adj)} of class 0 are "
                                         rf"adjacent"):
        make(masks(i, j_adj))
    with pytest.raises(ValueError, match=rf"both neighbours of row {k_mid}"):
        make(masks(i, j_two))
    td = make(masks(i, j_far))
    assert td.max_class == 2
    assert td.class_rows.tolist() == sorted([i, j_far])


@pytest.mark.parametrize("W", [1, 2, 3, 32, 33, 128])
def test_lane_plan_covers_each_pair_once(W):
    """The kernel's thread mapping covers every (class row, word, replica
    pair) exactly once; a word's lanes are one aligned segment of a warp,
    and each warp holds whole class rows or a run of one row's words."""
    lanes, rt = fused_cuda.lane_plan(W)
    assert lanes in (1, 2, 4, 8, 16) and rt % lanes == 0 and rt // lanes >= W
    assert (rt <= 32 and 32 % rt == 0) or rt % 32 == 0
    rows = 5
    items = fused_cuda.index_map(rows, W)
    want = {(r, w, p) for r in range(rows) for w in range(W)
            for p in range(16)}
    assert len(items) == len(want) == rows * W * 16
    assert {tuple(x) for x in items.tolist()} == want
