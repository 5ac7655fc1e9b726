"""Carry data between the JAX package and the port as numpy arrays, so that
both compute on the same inputs.

Packed spin words are ``uint32`` in the JAX package and ``torch.int32``
carrying the same bit patterns in the port (ROADMAP.md, container facts:
torch's CPU build has no right shift for ``uint32``). The conversion is a
reinterpretation of the bytes, never an arithmetic cast.
"""

from __future__ import annotations

import numpy as np
import torch

from graphdyn_torch.graphs import Graph


def graph_from_arrays(nbr, deg, edges) -> Graph:
    """A port :class:`~graphdyn_torch.graphs.Graph` holding copies of the
    given neighbor table, degrees and edge list (any array-likes, e.g. the
    fields of a JAX-package graph)."""
    return Graph(
        nbr=np.array(nbr, dtype=np.int32),
        deg=np.array(deg, dtype=np.int32),
        edges=np.array(edges, dtype=np.int32).reshape(-1, 2),
    )


def words_from_numpy(words) -> torch.Tensor:
    """uint32[n, W] -> torch.int32[n, W] with the same bit patterns (a copy
    on the CPU)."""
    a = np.ascontiguousarray(words, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32).copy())


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """torch.int32[n, W] (any device) -> uint32[n, W] with the same bit
    patterns."""
    if words.dtype != torch.int32:
        raise TypeError(f"packed words are torch.int32, got {words.dtype}")
    return words.detach().cpu().contiguous().numpy().view(np.uint32).copy()
