"""The part of ``graphdyn/plotting.py`` that needs no matplotlib: the
masking rule of the curve means. The figure functions are not ported
(ROADMAP A17); the CLI refuses ``--plot``."""

from __future__ import annotations

import numpy as np


def masked_mean(values, visited=None, axis: int = 0) -> np.ndarray:
    """Mean of ``values`` over ``axis`` restricted to ``visited`` AND finite
    entries; positions with no contributing entries give NaN (so downstream
    finite-masking drops them). Degraded −inf/NaN members do not poison the
    mean of the finite ones at the same λ."""
    v = np.asarray(values, float)
    ok = np.isfinite(v)
    if visited is not None:
        ok &= visited
    cnt = ok.sum(axis=axis)
    mean = np.where(ok, v, 0.0).sum(axis=axis) / np.maximum(cnt, 1)
    return np.where(cnt == 0, np.nan, mean)
