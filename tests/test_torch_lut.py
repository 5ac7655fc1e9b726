"""The port's update LUTs and their packed application against the JAX
package's ``ops/lut.py``, bit for bit. Host tables compare as numpy arrays;
packed words cross between the packages as uint32 arrays
(``graphdyn_torch.interop``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.ops import lut as jl
from graphdyn_torch.interop import words_from_numpy, words_to_numpy
from graphdyn_torch.ops import lut as tl

RULE_TIE = [("majority", "stay"), ("majority", "change"),
            ("minority", "stay"), ("minority", "change")]
GRAPHS = {
    "rrg": jg.random_regular_graph(64, 3, seed=0),
    "er": jg.erdos_renyi_graph(70, 3.0 / 70, seed=1),    # ragged, isolates
}


def _deg_ext(g):
    return np.concatenate([g.deg.astype(np.int64), [0]])


def _nbr_ext(g):
    return np.concatenate([g.nbr, np.full((1, g.dmax), g.n, np.int32)])


@pytest.mark.parametrize("rule,tie", RULE_TIE)
@pytest.mark.parametrize("dmax", [0, 1, 3, 4, 6])
def test_update_lut_equal(dmax, rule, tie):
    want = jl.update_lut(dmax, rule, tie)
    got = tl.update_lut(dmax, rule, tie)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_update_lut_rows_and_refusals():
    degs = np.array([0, 2, 5, 7, 3])
    for rule, tie in RULE_TIE:
        np.testing.assert_array_equal(tl.update_lut_rows(degs, 7, rule, tie),
                                      jl.update_lut_rows(degs, 7, rule, tie))
    with pytest.raises(ValueError, match="dmax"):
        tl.update_lut(-1)
    with pytest.raises(ValueError, match="exceeds"):
        tl.lut_node_masks(np.array([5, 0]), tl.update_lut(3))


@pytest.mark.parametrize("rule,tie", RULE_TIE)
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_lut_node_masks_equal(gname, rule, tie):
    g = GRAPHS[gname]
    lut = tl.update_lut(g.dmax, rule, tie)
    got = tl.lut_node_masks(_deg_ext(g), lut)
    want = jl.lut_node_masks(_deg_ext(g), jl.update_lut(g.dmax, rule, tie))
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rule,tie", RULE_TIE)
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_lut_one_step_equal(gname, rule, tie):
    g = GRAPHS[gname]
    n, dmax = g.n, g.dmax
    rng = np.random.default_rng(7)
    sp_ext = rng.integers(0, 2**32, size=(n + 1, 2), dtype=np.uint64)
    sp_ext = sp_ext.astype(np.uint32)
    sp_ext[n] = 0
    masks = jl.lut_node_masks(_deg_ext(g), jl.update_lut(dmax, rule, tie))
    want = np.asarray(jl.lut_one_step(
        jnp.asarray(sp_ext), jnp.asarray(_nbr_ext(g)), jnp.asarray(masks),
        n=n, dmax=dmax))
    lm = words_from_numpy(masks.reshape(-1, n + 1)).reshape(masks.shape)
    got = tl.lut_one_step(words_from_numpy(sp_ext),
                          torch.from_numpy(_nbr_ext(g)), lm, n=n, dmax=dmax)
    np.testing.assert_array_equal(words_to_numpy(got), want)
    assert (want[n] == 0).all()
