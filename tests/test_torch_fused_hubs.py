"""The fused annealer past degree 63: every int32 degree maps to a kernel
instantiation, the plain version on a power-law graph with a hub of degree
64 equals the JAX package's ``fused_anneal`` (its XLA twin) bit for bit
through the bucketed layout, and the device tables refuse what the
kernel's early loop exits could not handle. The CUDA kernel runs only on a
GPU: ``chip_smoke.py`` holds it against the same plain version at dmax 163
and in the thousands. (The XLA twin's compile grows with the degree, about
8 minutes at dmax 163 on the CPU, so the CPU case is the smallest past 63.)
"""

import numpy as np
import pytest
import torch

from graphdyn import graphs as jg
from graphdyn.config import DynamicsConfig as JDyn, SAConfig as JSA
from graphdyn.search import fused as jsf
from graphdyn_torch import interop
from graphdyn_torch.config import DynamicsConfig, SAConfig
from graphdyn_torch.ops import fused as tf
from graphdyn_torch.ops import fused_cuda
from graphdyn_torch.search import fused as tsf


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


def test_kernel_instances_cover_every_int32_degree():
    """``kernel_instance`` mirrors the kernel's ``pick``: dmax compiled in
    up to 8, the tight plane pairs to 63, then 8, 16 and 32 planes; each
    has the planes its neighbour and ball counts need."""
    tight = {(4, 4), (4, 5), (5, 5), (5, 6), (6, 6), (6, 7)}
    seen = set()
    degrees = list(range(1, 300)) + [2**k + j for k in range(9, 31)
                                     for j in (-1, 0, 1)] + [2**31 - 2]
    for d in degrees:
        np_, nb, dm = fused_cuda.kernel_instance(d)
        assert np_ >= d.bit_length() and nb >= (d + 1).bit_length()
        assert dm == (d if d <= 8 else 0)
        if d > 8:
            assert (np_, nb) in tight or np_ == nb in (8, 16, 32)
        seen.add((np_, nb, dm))
    assert {(8, 8, 0), (16, 16, 0), (32, 32, 0)} <= seen
    assert fused_cuda.kernel_instance(163) == (8, 8, 0)
    assert fused_cuda.kernel_instance(3000) == (16, 16, 0)
    for bad in (0, 2**31 - 1):
        with pytest.raises(ValueError, match="dmax"):
            fused_cuda.kernel_instance(bad)


@pytest.mark.parametrize("kw", [
    dict(n_replicas=8, seed=3, m_target=0.9, max_sweeps=3, chunk_sweeps=3),
    dict(n_replicas=29, seed=5, m_target=0.8, max_sweeps=2, chunk_sweeps=2,
         rule="minority", tie="change"),
], ids=["majority", "minority-change-pad-lanes"])
def test_plain_past_dmax_63_equal_xla_bucketed(kw):
    kw = dict(kw)
    rule, tie = kw.pop("rule", "majority"), kw.pop("tie", "stay")
    g = jg.powerlaw_graph(150, gamma=2.1, dmin=2, seed=5)
    assert g.dmax == 64
    want = jsf.fused_anneal(
        g, JSA(dynamics=JDyn(p=1, c=1, rule=rule, tie=tie)), kernel="xla",
        layout="bucketed", **kw)
    got = tsf.fused_anneal(
        interop.graph_from_arrays(g.nbr, g.deg, g.edges),
        SAConfig(dynamics=DynamicsConfig(p=1, c=1, rule=rule, tie=tie)),
        layout="bucketed", device="cpu", **kw)
    assert got.kernel_used == "plain"
    for name in ("s", "mag_reached", "m_end", "steps_to_target",
                 "sweeps_to_target"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert (got.chi, got.sweeps, got.device_steps, got.accepted) == \
        (want.chi, want.sweeps, want.device_steps, want.accepted)


def _tables(n=6, dmax=3):
    nbr = torch.full((n + 1, dmax), n, dtype=torch.int32)
    nbr[0, :2] = torch.tensor([1, 2])
    nbr[1, 0] = 0
    nbr[2, 0] = 0
    self_col = torch.arange(n + 1, dtype=torch.int32)[:, None]
    masks = torch.zeros((2, n + 1), dtype=torch.int32)
    masks[0, 0] = -1
    masks[1, 1] = -1
    return [masks, torch.zeros((2, 2)), nbr, torch.cat([self_col, nbr], 1),
            torch.zeros((dmax + 1, 2, n + 1), dtype=torch.int32),
            torch.zeros(32), torch.zeros(32)]


def test_device_tables_refuse_ghost_gaps_and_ghost_masks():
    """The kernel stops at a row's first ghost slot: a ghost before a
    neighbour, or a class mask in the ghost column, is refused."""
    tf.fused_device_tables(*_tables())
    t = _tables()
    t[2][0] = torch.tensor([6, 1, 2], dtype=torch.int32)
    t[3] = torch.cat([torch.arange(7, dtype=torch.int32)[:, None], t[2]], 1)
    with pytest.raises(ValueError, match="ghost"):
        tf.fused_device_tables(*t)
    t = _tables()
    t[0][1, 6] = 1
    with pytest.raises(ValueError, match="ghost"):
        tf.fused_device_tables(*t)
