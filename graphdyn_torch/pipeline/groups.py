"""Group bookkeeping of the grouped ensemble drivers (the part of
``graphdyn/pipeline/groups.py`` the HPr driver needs).

The JAX package's ``GroupDriver`` snapshots the completed prefix, resumes
from it, fires the ``rep.boundary`` fault site and polls for a graceful
shutdown between chunks; it comes with the port's checkpoint and
resilience layer (ROADMAP A16). Until then every run starts at repetition
0 and the drivers refuse a checkpoint path."""

from __future__ import annotations

from typing import Iterator


def group_ranges(start: int, stop: int, size: int) -> Iterator[list[int]]:
    """Partition ``range(start, stop)`` into consecutive groups of at most
    ``size`` repetitions (the tail group may be shorter; the group runners
    pad it back to ``size`` with inactive rows)."""
    if size < 1:
        raise ValueError(f"group_size must be >= 1, got {size}")
    k = start
    while k < stop:
        ks = list(range(k, min(k + size, stop)))
        yield ks
        k = ks[-1] + 1

