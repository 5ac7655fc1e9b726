"""The port's attractor combinatorics and factor tensors against the JAX
package's: every function equal exactly (both are host numpy), for
T = p + c ∈ {1, 2, 3, 4}, d ∈ {0, …, 6}, the four (rule, tie) pairs and
both attractor values."""

import numpy as np
import pytest

from graphdyn import attractors as ja
from graphdyn_torch import attractors as ta

PC = [(0, 1), (1, 1), (2, 1), (1, 2), (3, 1), (2, 2)]
RULE_TIES = [("majority", "stay"), ("majority", "change"),
             ("minority", "stay"), ("minority", "change")]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("T", [1, 2, 3, 4])
def test_trajectories_lattices_masks_identical(T):
    _same(ta.trajectories01(T), ja.trajectories01(T))
    _same(ta.x0_pm(T), ja.x0_pm(T))
    for attr in (1, -1):
        _same(ta.attr_mask(T, attr), ja.attr_mask(T, attr))
    for d in range(7):
        _same(ta.rho_lattice(d, T), ja.rho_lattice(d, T))
    X = ta.trajectories01(T)
    for i in (0, len(X) - 1):
        for j in (0, len(X) // 2):
            assert ta.order_index(X[i], X[j]) == ja.order_index(X[i], X[j])


@pytest.mark.parametrize("rule,tie", RULE_TIES)
@pytest.mark.parametrize("p,c", PC)
def test_condition_and_factor_tensors_identical(p, c, rule, tie):
    for d in range(7):
        for include_xj in (True, False):
            got = ta.condition_tensors(d, p, c, include_xj=include_xj,
                                       rule=rule, tie=tie)
            want = ja.condition_tensors(d, p, c, include_xj=include_xj,
                                        rule=rule, tie=tie)
            for g, w in zip(got, want):
                _same(g, w)
        for attr in (1, -1):
            _same(ta.edge_factor_tensor(d, p, c, attr, rule, tie),
                  ja.edge_factor_tensor(d, p, c, attr, rule, tie))
            _same(ta.node_factor_tensor(d, p, c, attr, rule, tie),
                  ja.node_factor_tensor(d, p, c, attr, rule, tie))
    for attr in (1, -1):
        _same(ta.leaf_factor_tensor(p, c, attr, rule, tie),
              ja.leaf_factor_tensor(p, c, attr, rule, tie))
