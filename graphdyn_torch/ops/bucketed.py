"""The layout-routing predicate of the degree-bucketed layout (the port of
``graphdyn/ops/bucketed.py:BUCKETED_CV_THRESHOLD`` and ``auto_layout``).

Only the predicate is ported: ``fused_anneal(layout="auto")`` consults it.
The bucketed layout itself comes with ROADMAP.md A13, and the drivers raise
``NotImplementedError`` naming it when a graph would need it.
"""

from __future__ import annotations

from graphdyn_torch.graphs import degree_cv

#: degree-CV above which the drivers route to the bucketed layout: an RRG
#: sits at 0, ER(c) at 1/sqrt(c) (< 0.71 for every c >= 2), a power-law
#: tail diverges with n
BUCKETED_CV_THRESHOLD = 1.0


def auto_layout(deg, *, threshold: float = BUCKETED_CV_THRESHOLD) -> str:
    """``'bucketed'`` when the degree CV crosses ``threshold``, else
    ``'padded'``."""
    return "bucketed" if degree_cv(deg) >= threshold else "padded"
