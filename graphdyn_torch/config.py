"""Config surface — every hand-edited constant block of the reference as
dataclasses (SURVEY.md §5.6; reference `SA_RRG.py:44-56`,
`HPR_pytorch_RRG.py:222-255`, `ER_BDCM_entropy.ipynb:455-482`).

The port's copy of ``graphdyn/config.py``: the same fields and defaults, so a
config built for one package reads the same in the other."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class DynamicsConfig:
    """(p,c) backtracking-attractor dynamics parameters."""

    p: int = 1
    c: int = 1
    rule: str = "majority"      # 'majority' | 'minority'
    tie: str = "stay"           # 'stay' | 'change'
    attr_value: int = 1         # pinned attractor endpoint (`HPR:230`)

    @property
    def horizon(self) -> int:
        return self.p + self.c


@dataclass(frozen=True)
class GraphConfig:
    """Ensemble parameters: RRG(n,d) or ER G(n, deg/(n-1))."""

    kind: str = "rrg"           # 'rrg' | 'er'
    n: int = 10_000
    d: int = 4                  # RRG degree
    mean_degree: float = 2.0    # ER mean degree; p = mean_degree/(n-1)
    method: str = "pairing"     # 'pairing'|'numpy'|'networkx'|'native'

    @property
    def er_p(self) -> float:
        return self.mean_degree / (self.n - 1)


@dataclass(frozen=True)
class SAConfig:
    """Simulated-annealing search (`SA_RRG.py:44-56,67-84`)."""

    dynamics: DynamicsConfig = field(default_factory=lambda: DynamicsConfig(p=3, c=1))
    a0_frac: float = 0.015      # a = a0_frac * n  (`SA_RRG.py:67`)
    b0_frac: float = 0.010      # b = b0_frac * n  (`SA_RRG.py:68`)
    par_a: float = 1.0005       # per-step anneal multipliers (`:49-50`)
    par_b: float = 1.0005
    a_cap_frac: float = 4.5     # cap a at 4.5n (`:80`)
    b_cap_frac: float = 5.0     # cap b at 5n  (`:81`)
    max_steps: int | None = None  # default 2n^3 (`:84`); sentinel m_final=2
    n_replicas: int = 1
    seed: int = 0


@dataclass(frozen=True)
class HPRConfig:
    """History-Passing reinforcement (`HPR_pytorch_RRG.py:222-237`)."""

    dynamics: DynamicsConfig = field(default_factory=DynamicsConfig)
    damp: float = 0.4           # damppar (`:229`)
    lmbd: float = 25.0          # effective tilt = lmbd_in/n (`:231` with `/n` at `:39`)
    pie: float = 0.3            # reinforcement π (`:235`)
    gamma: float = 0.1          # reinforcement γ (`:236`)
    max_sweeps: int = 10_000    # TT (`:237`)
    eps_clamp: float = 1e-15    # marginal Z clamp (`:147`)
    n_replicas: int = 1
    seed: int = 0
    dtype: str = "float32"      # messages/marginals/biases dtype; 'float64'
                                # is the reference's precision
                                # (`HPR_pytorch_RRG.py:11`)


@dataclass(frozen=True)
class EntropyConfig:
    """BDCM entropy λ-sweep (`ER_BDCM_entropy.ipynb:455-482`)."""

    dynamics: DynamicsConfig = field(default_factory=DynamicsConfig)
    lmbd_max: float = 12.0
    lmbd_step: float = 0.1
    eps: float = 1e-6           # fixed-point tolerance (`ipynb:470`)
    damp: float = 0.1           # damppar (`ipynb:471`)
    eps_clamp: float = 0.0      # epsilon floor for Z and chi (`ipynb:473`)
    max_sweeps: int = 1300      # T_max (`ipynb:478`)
    ent_floor: float = -0.05    # early-exit threshold (`ipynb:446`)
    plateau_eps: float = 0.0    # opt-in: stop the ladder when (m_init, ent1)
                                # change less than this for plateau_patience
                                # consecutive λ (0 = off, reference behavior)
    plateau_patience: int = 3
    num_rep: int = 3
    seed: int = 0
    # fields a checkpoint fingerprint leaves out at their defaults, so that
    # checkpoints written before they existed still resume
    _fingerprint_optional = ("plateau_eps", "plateau_patience")
    dtype: str = "float32"      # 'float64' matches the reference's precision


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
