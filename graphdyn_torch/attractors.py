"""(p,c) backtracking-attractor combinatorics and factor tensors (the port's
copy of ``graphdyn/attractors.py``, host numpy, line for line).

The attractor-closure / trajectory-consistency / endpoint indicators of the
reference (`HPR_pytorch_RRG.py:14-39`, `ER_BDCM_entropy.ipynb:66-111`) are
built as whole factor tensors over every ``(x_i, x_j, ρ)`` combo at once, for
any (rule, tie) pair, through the same closed-form ``R·sign(2·total +
C·prev)`` update as the dynamics (:mod:`graphdyn_torch.ops.dynamics`).

Conventions (all matching the reference):

- Trajectories live in {1, 0} with 1 ↔ spin +1; the enumeration order is
  ``itertools.product([1, 0], repeat=T)`` — index 0 is the all-ones
  trajectory (`HPR_pytorch_RRG.py:66-76`).
- ρ-lattices store *counts of +1 neighbors* ``0..d``; the signed sum of ``d``
  {±1} trajectories is ``2ρ − d`` (`ipynb:291`, `HPR_pytorch_RRG.py:212`).
- The λ-tilt ``exp(−λ·x_i(0))`` is applied at contraction time, not baked
  into the tensors.

The tensors stay float64 numpy; :class:`graphdyn_torch.ops.bdcm.BDCMData`
casts them to the message dtype when they move to a device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from graphdyn_torch.ops.dynamics import rule_coefficients


@lru_cache(maxsize=None)
def trajectories01(T: int) -> np.ndarray:
    """All {1,0} trajectories, shape [2^T, T], in product([1,0]) order
    (index 0 = all-ones)."""
    K = 2**T
    out = np.empty((K, T), dtype=np.int64)
    for t in range(T):
        period = 2 ** (T - 1 - t)
        out[:, t] = 1 - (np.arange(K) // period) % 2
    return out


def order_index(xi01: np.ndarray, xj01: np.ndarray) -> int:
    """Combo index of a trajectory pair in the reference's column encoding
    (`HPR_pytorch_RRG.py:66-74`): position of (xi, xj) in the double
    product([1,0]) enumeration."""
    bits = 1 - np.concatenate([np.asarray(xi01), np.asarray(xj01)])
    return int("".join(map(str, bits)), 2)


@lru_cache(maxsize=None)
def rho_lattice(n_msgs: int, T: int) -> np.ndarray:
    """Mixed-radix enumeration of ρ ∈ {0..n_msgs}^T, shape [(n_msgs+1)^T, T].

    Index r = Σ_t ρ_t·(n_msgs+1)^(T−1−t); axis t of the *tensor-shaped* DP
    state corresponds to ρ_t, matching the notebook's trailing-axes layout
    (`ipynb:91-93` cell comments).
    """
    base = n_msgs + 1
    M = base**T
    out = np.empty((M, T), dtype=np.int64)
    for t in range(T):
        out[:, t] = (np.arange(M) // base ** (T - 1 - t)) % base
    return out


def _step_out(total_pm, prev_pm, R_coef, C_coef):
    """Closed-form synchronous update (see ops.dynamics): what x(t+1) must be
    given the inclusive neighbor sum ``total_pm`` and x(t)=``prev_pm``."""
    return R_coef * np.sign(2 * total_pm + C_coef * prev_pm)


def condition_tensors(
    n_msgs: int,
    p: int,
    c: int,
    *,
    include_xj: bool,
    rule: str = "majority",
    tie: str = "stay",
):
    """Vectorized atr/traj indicators over the full (xi, xj, ρ) grid.

    Returns (atr, traj) with shape [K, K, M] when ``include_xj`` (edge
    variant: total = ρ + x_j, `ipynb:66-81`) else [K, M] (node variant:
    total = ρ, `ipynb:83-98`). ρ counts exclude x_j in the edge variant.
    """
    T = p + c
    R_coef, C_coef = rule_coefficients(rule, tie)
    X = 2 * trajectories01(T) - 1          # [K, T] in ±1
    Rho = 2 * rho_lattice(n_msgs, T) - n_msgs  # [M, T] signed sums

    if include_xj:
        xi = X[:, None, None, :]
        xj = X[None, :, None, :]
        rho = Rho[None, None, :, :]
        total = rho + xj
    else:
        xi = X[:, None, :]
        rho = Rho[None, :, :]
        total = rho

    shape = np.broadcast_shapes(total.shape[:-1], xi.shape[:-1])
    traj = np.ones(shape, dtype=bool)
    for t in range(T - 1):
        out_t = _step_out(total[..., t], xi[..., t], R_coef, C_coef)
        traj = traj & (xi[..., t + 1] == out_t)
    out_T = _step_out(total[..., T - 1], xi[..., T - 1], R_coef, C_coef)
    atr = xi[..., p] == out_T
    return atr, traj


def attr_mask(T: int, attr_value: int) -> np.ndarray:
    """bool[K]: trajectory endpoint pinned to the attractor value
    (`attr_fix`, `HPR_pytorch_RRG.py:34-36`)."""
    X = 2 * trajectories01(T) - 1
    return X[:, T - 1] == attr_value


def x0_pm(T: int) -> np.ndarray:
    """±1 initial value of each trajectory, [K] — the λ-tilt couples to this."""
    return 2 * trajectories01(T)[:, 0] - 1


def edge_factor_tensor(
    n_msgs: int,
    p: int,
    c: int,
    attr_value: int = 1,
    rule: str = "majority",
    tie: str = "stay",
) -> np.ndarray:
    """λ=0 edge factor A[x_i, x_j, ρ], shape [K, K, (n_msgs+1)^T]
    (= the notebook's ``A[d]``, `ipynb:285-291`; HPR's inline ``A_i_sums``,
    `HPR_pytorch_RRG.py:38-39` with the λ term factored out)."""
    T = p + c
    atr, traj = condition_tensors(n_msgs, p, c, include_xj=True, rule=rule, tie=tie)
    fix = attr_mask(T, attr_value)
    return (atr & traj & fix[:, None, None]).astype(np.float64)


def node_factor_tensor(
    n_msgs: int,
    p: int,
    c: int,
    attr_value: int = 1,
    rule: str = "majority",
    tie: str = "stay",
) -> np.ndarray:
    """λ=0 node factor Ai[x_i, ρ] over all-neighbor sums, [K, (n_msgs+1)^T]
    (= the notebook's ``Ai[d]``, `ipynb:309-313`)."""
    T = p + c
    atr, traj = condition_tensors(n_msgs, p, c, include_xj=False, rule=rule, tie=tie)
    fix = attr_mask(T, attr_value)
    return (atr & traj & fix[:, None]).astype(np.float64)


def leaf_factor_tensor(
    p: int,
    c: int,
    attr_value: int = 1,
    rule: str = "majority",
    tie: str = "stay",
) -> np.ndarray:
    """λ=0 message from a leaf node i to its unique neighbor j: the edge
    factor with an empty ρ (zero signed sum), [K, K]
    (`ipynb:403-417`: d=0 edges get the normalized bare factor)."""
    A = edge_factor_tensor(0, p, c, attr_value, rule, tie)
    return A[:, :, 0]
