"""graphdyn_torch.pipeline — batched multi-graph ensembles with host
prefetch (the port of ``graphdyn/pipeline``, the parts the HPr driver
uses): ``group_ranges`` (:mod:`~graphdyn_torch.pipeline.groups`), the
``HostPrefetcher`` (:mod:`~graphdyn_torch.pipeline.prefetch`), the
grouped HPr executor (:mod:`~graphdyn_torch.pipeline.hpr_group`) and the
cell-parallel entropy ladders (:mod:`~graphdyn_torch.pipeline.
entropy_group`) and the grouped SA ensemble
(:mod:`~graphdyn_torch.pipeline.sa_group`)."""

from graphdyn_torch.pipeline.groups import group_ranges
from graphdyn_torch.pipeline.prefetch import HostPrefetcher

__all__ = ["HostPrefetcher", "group_ranges"]
