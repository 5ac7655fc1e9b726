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


def chromatic_tables_from_jax(chrom):
    """The JAX package's ``ChromaticTables`` (numpy fields) -> the port's,
    with copies of every field in the same dtypes."""
    from graphdyn_torch.ops.chromatic import ChromaticTables

    return ChromaticTables(*(np.array(f) for f in chrom))


def fused_tables_from_jax(tables):
    """The JAX package's ``FusedTables`` -> the port's (numpy copies)."""
    from graphdyn_torch.ops.fused import FusedTables

    return FusedTables(
        chrom=chromatic_tables_from_jax(tables.chrom),
        masks_ext=np.array(tables.masks_ext),
        lut_masks=np.array(tables.lut_masks),
        fac_a=np.array(tables.fac_a),
        fac_b=np.array(tables.fac_b),
    )


def fused_device_tables_from_jax(tables_dev, device="cpu"):
    """The JAX package's seven device tables ``(masks_ext, facs, nbr_ext,
    nbr_self, lut_masks, a_caps, b_caps)`` -> the port's
    :class:`~graphdyn_torch.ops.fused.FusedDeviceTables` on ``device``
    (uint32 masks become int32 words with the same bits)."""
    from graphdyn_torch.ops.fused import fused_device_tables

    masks_ext, facs, nbr_ext, nbr_self, lut_masks, a_caps, b_caps = (
        np.asarray(t) for t in tables_dev)
    lm = words_from_numpy(lut_masks.reshape(-1, lut_masks.shape[-1]))
    return fused_device_tables(
        words_from_numpy(masks_ext).to(device),
        torch.from_numpy(np.array(facs, np.float32)).to(device),
        torch.from_numpy(np.array(nbr_ext, np.int32)).to(device),
        torch.from_numpy(np.array(nbr_self, np.int32)).to(device),
        lm.reshape(lut_masks.shape).to(device),
        torch.from_numpy(np.array(a_caps, np.float32)).to(device),
        torch.from_numpy(np.array(b_caps, np.float32)).to(device),
    )


def fused_state_from_jax(state, device="cpu"):
    """The JAX package's ``FusedState`` -> the port's
    :class:`~graphdyn_torch.ops.fused.FusedState` on ``device``."""
    from graphdyn_torch.ops.fused import FusedState

    def t(x, dtype):
        return torch.from_numpy(np.array(x, dtype)).to(device)

    return FusedState(
        sp_ext=words_from_numpy(np.asarray(state.sp_ext)).to(device),
        sum_end=t(state.sum_end, np.int32),
        a=t(state.a, np.float32),
        b=t(state.b, np.float32),
        t_target=t(state.t_target, np.int32),
        active=t(state.active, np.bool_),
        steps=t(state.steps, np.int32),
        accepted=t(state.accepted, np.int32),
    )


def fused_state_to_numpy(state) -> dict:
    """The port's ``FusedState`` (any device) -> a dict of numpy arrays in
    the JAX package's dtypes (uint32 words, int32, float32, bool)."""
    return {
        "sp_ext": words_to_numpy(state.sp_ext),
        "sum_end": state.sum_end.cpu().numpy().astype(np.int32),
        "a": state.a.cpu().numpy().astype(np.float32),
        "b": state.b.cpu().numpy().astype(np.float32),
        "t_target": state.t_target.cpu().numpy().astype(np.int32),
        "active": state.active.cpu().numpy().astype(np.bool_),
        "steps": np.int32(state.steps.item()),
        "accepted": np.int32(state.accepted.item()),
    }


def edge_tables_from_jax(tables):
    """The JAX package's ``EdgeTables`` (numpy fields) -> the port's, with
    copies of every field (``rev_map`` kept as None when absent)."""
    from graphdyn_torch.graphs import EdgeTables

    return EdgeTables(*(None if f is None else np.array(f) for f in tables))


def edge_classes_from_jax(data) -> list:
    """The edge classes of a JAX-package ``BDCMData`` -> the port's
    ``_EdgeClass`` tuples (numpy copies of ids, in-edges and factors)."""
    from graphdyn_torch.ops.bdcm import _EdgeClass

    return [_EdgeClass(d=int(c.d), idx=np.array(c.idx),
                       in_edges=np.array(c.in_edges), A=np.array(c.A))
            for c in data.edge_classes]


def hpr_group_state_from_jax(state, seeds, device="cpu"):
    """The JAX package's ``_HPRGroupState`` -> the port's
    :class:`~graphdyn_torch.pipeline.hpr_group._HPRGroupState` on
    ``device``. The reference's PRNG keys have no counterpart: ``seeds``
    (one per member) key the port's stream."""
    from graphdyn_torch.pipeline.hpr_group import _HPRGroupState

    def t(x, dtype=None):
        return torch.from_numpy(np.array(x, dtype)).to(device)

    return _HPRGroupState(
        chi=t(state.chi), biases=t(state.biases), s=t(state.s, np.int8),
        seeds=t(seeds, np.int64), t=int(np.asarray(state.t)),
        m_final=t(state.m_final, np.float32), active=t(state.active, np.bool_),
        steps=t(state.steps, np.int32),
    )


def hpr_group_state_to_numpy(state) -> dict:
    """The port's ``_HPRGroupState`` (any device) -> a dict of numpy arrays
    in the JAX package's dtypes (``seeds`` in place of its keys)."""
    out = {k: getattr(state, k).cpu().numpy()
           for k in ("chi", "biases", "s", "seeds", "m_final", "active",
                     "steps")}
    out["t"] = np.int32(state.t)
    return out


def bdcm_data_from_jax(data):
    """A JAX-package ``BDCMData`` -> the port's, holding numpy copies of its
    graph, edge tables, edge and node classes (ids, in-edges, factors), leaf
    ids, validity mask, x0 and leaf factor, in the same dtype: both packages
    then sweep and observe the same tables."""
    from graphdyn_torch.ops.bdcm import BDCMData, _NodeClass, as_dtype

    out = BDCMData.__new__(BDCMData)
    out.dtype = as_dtype(np.dtype(data.dtype).name)
    out.graph = graph_from_arrays(data.graph.nbr, data.graph.deg,
                                  data.graph.edges)
    out.tables = edge_tables_from_jax(data.tables)
    out.p, out.c, out.T, out.K = data.p, data.c, data.T, data.K
    out.attr_value, out.rule, out.tie = data.attr_value, data.rule, data.tie
    out.padded = data.padded
    out.valid = np.array(data.valid)
    out.x0 = np.array(data.x0)
    out.leaf01 = np.array(data.leaf01)
    out.leaf_idx = np.array(data.leaf_idx)
    out.edge_classes = edge_classes_from_jax(data)
    out.node_classes = [_NodeClass(d=int(c.d), idx=np.array(c.idx),
                                   in_edges=np.array(c.in_edges),
                                   Ai=np.array(c.Ai))
                        for c in data.node_classes]
    out.num_directed = data.num_directed
    out.num_edges = data.num_edges
    out.n = data.n
    return out


def stacked_bdcm_from_jax(stk):
    """A JAX-package ``StackedBDCM`` -> the port's, stacked from the same
    per-cell tables (:func:`bdcm_data_from_jax` of each cell)."""
    from graphdyn_torch.ops.bdcm import stack_bdcm

    return stack_bdcm([bdcm_data_from_jax(d) for d in stk.datas])


def chi_from_jax(chi, device="cpu") -> torch.Tensor:
    """A chi array or stack of the JAX package (``[2E, K, K]``, ``[G, 2E,
    K, K]``) -> a tensor of the same dtype on ``device``."""
    return torch.from_numpy(np.array(chi)).to(device)


def chi_to_numpy(chi: torch.Tensor) -> np.ndarray:
    """A chi tensor of the port (any device) -> numpy, for the JAX package."""
    return chi.detach().cpu().numpy()


def _tensor(x, dtype, device):
    return torch.from_numpy(np.array(x, dtype)).to(device)


def sa_state_from_jax(state, seeds, device="cpu"):
    """The JAX package's ``_SAState`` -> the port's
    :class:`~graphdyn_torch.models.sa._SAState` on ``device``. ``seeds`` are
    the chains' stream seeds (the reference's state holds ``jax.random``
    keys, which the port's counter stream does not use)."""
    from graphdyn_torch.models.sa import _SAState

    t = np.asarray(state.t)
    return _SAState(
        s=_tensor(state.s, np.int8, device),
        sum_end=_tensor(state.sum_end, np.int32, device),
        a=_tensor(state.a, np.asarray(state.a).dtype, device),
        b=_tensor(state.b, np.asarray(state.b).dtype, device),
        t=_tensor(t, t.dtype, device),
        m_final=_tensor(state.m_final, np.asarray(state.m_final).dtype,
                        device),
        active=_tensor(state.active, np.bool_, device),
        key=_tensor(np.asarray(seeds, np.int64) & 0xFFFFFFFF, np.int64,
                    device),
        chunk_t=_tensor(state.chunk_t, np.int32, device),
        traj=_tensor(state.traj, np.int8, device),
    )


def sa_state_to_numpy(state) -> dict:
    """The port's ``_SAState`` (any device) -> numpy arrays by field name."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def lightcone_tables_from_jax(tables, device="cpu"):
    """The JAX package's ``LightconeTables`` -> the port's (int64 index
    tensors on ``device``)."""
    from graphdyn_torch.ops.lightcone import LightconeTables

    return LightconeTables(
        ball=_tensor(tables.ball, np.int64, device),
        nbr_slot=_tensor(tables.nbr_slot, np.int64, device),
        nbr_glob=_tensor(tables.nbr_glob, np.int64, device),
        radius=int(tables.radius),
        ball_max=int(tables.ball_max),
    )


def chrom_state_from_jax(state, device="cpu"):
    """The JAX package's ``ChromState`` -> the port's
    :class:`~graphdyn_torch.ops.chromatic.ChromState` on ``device``."""
    from graphdyn_torch.ops.chromatic import ChromState

    return ChromState(
        sp=words_from_numpy(np.asarray(state.sp)).to(device),
        sum_end=_tensor(state.sum_end, np.int32, device),
        a=_tensor(state.a, np.float32, device),
        b=_tensor(state.b, np.float32, device),
        steps=_tensor(state.steps, np.int32, device),
        sweeps=_tensor(state.sweeps, np.int32, device),
        t_target=_tensor(state.t_target, np.int32, device),
        active=_tensor(state.active, np.bool_, device),
        accepted=_tensor(state.accepted, np.int32, device),
        chunk_s=_tensor(state.chunk_s, np.int32, device),
    )


def temper_state_from_jax(state, seeds, device="cpu"):
    """The JAX package's ``_TemperState`` -> the port's
    :class:`~graphdyn_torch.search.tempering._TemperState` on ``device``
    (``seeds``: the lanes' stream seeds; the per-pair counters start at
    0, the reference keeps only their sums)."""
    from graphdyn_torch.search.tempering import _TemperState

    K = np.shape(state.s)[0]
    t = np.asarray(state.t)
    zeros = np.zeros(max(K - 1, 0), np.int32)
    return _TemperState(
        s=_tensor(state.s, np.int8, device),
        sum_end=_tensor(state.sum_end, np.int32, device),
        a=_tensor(state.a, np.asarray(state.a).dtype, device),
        b=_tensor(state.b, np.asarray(state.b).dtype, device),
        t=_tensor(t, t.dtype, device),
        m_final=_tensor(state.m_final, np.asarray(state.m_final).dtype,
                        device),
        active=_tensor(state.active, np.bool_, device),
        key=_tensor(np.asarray(seeds, np.int64) & 0xFFFFFFFF, np.int64,
                    device),
        t_target=_tensor(state.t_target, t.dtype, device),
        chunk_t=_tensor(state.chunk_t, np.int32, device),
        swap_round=_tensor(state.swap_round, np.int32, device),
        swap_att=_tensor(state.swap_att, np.int32, device),
        swap_acc=_tensor(state.swap_acc, np.int32, device),
        pair_att=_tensor(zeros, np.int32, device),
        pair_acc=_tensor(zeros, np.int32, device),
    )


def degree_buckets_from_jax(buckets):
    """The JAX package's ``DegreeBuckets`` (numpy fields) -> the port's,
    with copies of every array in the same dtypes."""
    from graphdyn_torch.graphs import DegreeBuckets

    return DegreeBuckets(
        n=int(buckets.n),
        order=np.array(buckets.order, dtype=np.int64),
        inv=np.array(buckets.inv, dtype=np.int64),
        offsets=np.array(buckets.offsets, dtype=np.int64),
        widths=tuple(int(w) for w in buckets.widths),
        nbr=tuple(np.array(t, dtype=np.int32) for t in buckets.nbr),
        deg=tuple(np.array(d, dtype=np.int32) for d in buckets.deg),
    )


def stream_plan_from_jax(plan):
    """The JAX package's ``StreamPlan`` -> the port's (numpy copies of every
    chunk's tables, in the same dtypes)."""
    from graphdyn_torch.ops.streamed import StreamChunk, StreamPlan

    return StreamPlan(
        n=int(plan.n),
        chunks=tuple(StreamChunk(*(np.array(f) for f in ch))
                     for ch in plan.chunks),
        chunk_of=np.array(plan.chunk_of),
    )
