"""Observables: magnetization, consensus, tilted entropy, throughput.

The port's counterpart of ``graphdyn/observe.py``. Spins are ±1 integer
tensors whose trailing axis is the node axis; results stay on the input's
device. The mesh-wide variant reduces over a ``DeviceMesh`` dimension
(:mod:`graphdyn_torch.parallel.mesh`).
"""

from __future__ import annotations

import torch


def magnetization(s) -> torch.Tensor:
    """m(s) = Σ s_i / n (`SA_RRG.py:39-40`); works on batched spins
    (reduces the trailing axis). float32, computed as the JAX package's
    compiled mean is: the sum times the float32 reciprocal of n (XLA
    rewrites the division by a constant), so the values agree bit for bit."""
    s = torch.as_tensor(s)
    inv_n = (torch.ones((), dtype=torch.float32) / s.shape[-1]).to(s.device)
    return s.to(torch.float32).sum(dim=-1) * inv_n


def consensus_fraction(s_end, target: int = 1) -> torch.Tensor:
    """Fraction of replicas whose end state is the homogeneous ``target``
    consensus: reduce the trailing (node) axis to a bool per replica, then
    average the leading axes."""
    s_end = torch.as_tensor(s_end)
    reached = (s_end == target).all(dim=-1)
    return reached.to(torch.float32).mean()


def consensus_fraction_psum(s_end, mesh, axis_name: str,
                            target: int = 1) -> torch.Tensor:
    """Mesh-wide consensus fraction: :func:`consensus_fraction` of this
    rank's local batch, then its mean over the ranks of the mesh dimension
    ``axis_name`` (``lax.pmean``: an ``all_reduce`` sum divided by the
    dimension's size)."""
    from graphdyn_torch.parallel.mesh import pmean

    return pmean(consensus_fraction(s_end, target), mesh, axis_name)


def tilted_entropy(phi, lmbd, m_init):
    """Legendre transform s(m_init) = φ + λ·m_init (`ipynb:436`)."""
    return phi + lmbd * m_init


def spin_updates_per_sec(n_spins: int, n_replicas: int, steps: int, seconds: float) -> float:
    """The headline throughput metric: spin updates per second."""
    return n_spins * n_replicas * steps / seconds
