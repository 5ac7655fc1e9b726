"""Node-axis sharding by a full gather per step, over a ``DeviceMesh``
(the port of the node half of ``graphdyn/parallel/sharded.py``).

Replicas split over the mesh's ``"replica"`` dimension and, for a graph too
large for one card, nodes over ``"node"``: each rank owns a contiguous node
block and that block's neighbor-table rows, and one int8 ``all_gather`` of
the spin block per synchronous step (:func:`graphdyn_torch.parallel.mesh.
all_gather_tiled`) gives it every spin it reads. This is the gather mode:
the parity baseline of the halo exchange (:mod:`graphdyn_torch.parallel.
halo`) and the cheaper path for small graphs. The edge-sharded BDCM sweep
and fixed point of the JAX module come with a later slice (ROADMAP.md
A15b).

Every function here runs on one rank: tensors are the rank's blocks, and
the mesh's groups carry the collectives.
"""

from __future__ import annotations

import numpy as np
import torch

from graphdyn_torch.ops.dynamics import rule_coefficients
from graphdyn_torch.parallel.mesh import (
    NODE,
    REPLICA,
    all_gather_tiled,
    axis_index,
    axis_size,
    pmean,
    psum,
    rank_device,
)


def pad_nodes(graph, n_shards: int):
    """Pad the node axis to a multiple of ``n_shards``.

    Returns ``(nbr_padded, n_padded)`` (host numpy). Padding rows are
    all-ghost (degree 0), so padded nodes are isolated spins that no edge
    points at; the ghost slot index becomes ``n + n_pad``, the zero column
    appended after the gathered pad columns."""
    n, dmax = graph.n, graph.dmax
    n_pad = (-n) % n_shards
    nbr = graph.nbr.astype(np.int32)
    if n_pad:
        ghost_rows = np.full((n_pad, dmax), n, dtype=np.int32)
        nbr = np.concatenate([nbr, ghost_rows], axis=0)
        nbr = np.where(nbr == n, n + n_pad, nbr)
    return nbr, n + n_pad


def _real_mask(mesh, node_axis: str, n_block: int, n_real: int,
               device) -> torch.Tensor:
    """bool[n_block]: which rows of this rank's node block are real nodes
    (contiguous blocks: global index = node index · n_block + row)."""
    g0 = axis_index(mesh, node_axis) * n_block
    return torch.arange(g0, g0 + n_block, device=device) < n_real


def _local_step(nbr_local, s_full, s_local, real_mask, R_coef: int,
                C_coef: int) -> torch.Tensor:
    """One synchronous update of a local node block from the gathered
    spins ``s_full: int8[R, n_pad]``: the ghost slot is a zero column
    appended here; pad rows stay frozen under every rule."""
    Rb = s_full.shape[0]
    s_ext = torch.cat([s_full.to(torch.int32),
                       s_full.new_zeros((Rb, 1), dtype=torch.int32)], dim=1)
    nb = nbr_local.to(torch.int64)
    sums = s_ext.index_select(1, nb.reshape(-1)).reshape(
        Rb, nb.shape[0], nb.shape[1]).sum(dim=2)
    out = (R_coef * torch.sign(2 * sums + C_coef * s_local.to(torch.int32))
           ).to(torch.int8)
    return torch.where(real_mask[None, :], out, s_local)


def _masked_block_sum(s_local, real_mask) -> torch.Tensor:
    """Pad-free Σ over this rank's block (int32 per replica)."""
    return torch.where(real_mask[None, :], s_local.to(torch.int32),
                       0).sum(dim=1, dtype=torch.int32)


def make_sharded_rollout(mesh, n_real: int, steps: int,
                         rule: str = "majority", tie: str = "stay",
                         node_axis: str = NODE):
    """The rollout ``f(nbr_local, s_local) -> s_end_local`` of this rank's
    block (its replicas, its nodes over ``node_axis``); rows with global index
    >= ``n_real`` are padding and stay frozen. One tiled int8
    ``all_gather`` over ``node_axis`` per step."""
    R_coef, C_coef = rule_coefficients(rule, tie)

    def rollout(nbr_local, s_local):
        mask = _real_mask(mesh, node_axis, s_local.shape[1], n_real,
                          s_local.device)
        s = s_local
        for _ in range(steps):
            s_full = all_gather_tiled(s, mesh, node_axis, dim=1)
            s = _local_step(nbr_local, s_full, s, mask, R_coef, C_coef)
        return s

    return rollout


def make_sharded_sa_step(mesh, rollout_steps: int, n_real: int,
                         rule: str = "majority", tie: str = "stay",
                         replica_axis: str = REPLICA, node_axis: str = NODE):
    """One SA step over the mesh: per-replica proposal from the port's
    counter stream (:func:`graphdyn_torch.models.sa.draw_sa_proposal`, the
    same draw on every node rank), the flip on the owning rank, the
    candidate rollout, the Metropolis accept and the anneal, and the
    mesh-mean consensus fraction.

    Returns ``step(nbr_local, s_local, sum_end, a, b, key, t, par_a, par_b,
    a_cap, b_cap) -> (s', sum_end', a', b', key, t + 1, consensus)``, with
    per-replica vectors as this rank's replica block."""
    from graphdyn_torch.models.sa import (
        draw_sa_proposal,
        metropolis_anneal_update,
    )

    R_coef, C_coef = rule_coefficients(rule, tie)
    rollout = make_sharded_rollout(mesh, n_real, rollout_steps, rule, tie,
                                   node_axis)

    def step(nbr_local, s_local, sum_end, a, b, key, t, par_a, par_b, a_cap,
             b_cap):
        Rl, n_block = s_local.shape
        dev = s_local.device
        mask = _real_mask(mesh, node_axis, n_block, n_real, dev)
        i, u = draw_sa_proposal(key, t, None, None, injected=False,
                                stream_len=1, n=n_real, dt=a.dtype)
        i, u = i[:, 0], u[:, 0]
        local_i = i - axis_index(mesh, node_axis) * n_block
        owned = (local_i >= 0) & (local_i < n_block)
        li = local_i.clamp(0, n_block - 1)
        s_i_local = torch.gather(s_local, 1, li[:, None])[:, 0].to(torch.int32)
        flipped = s_local.scatter(1, li[:, None],
                                  (-s_i_local).to(torch.int8)[:, None])
        s_flip = torch.where(owned[:, None], flipped, s_local)
        s_i = psum(torch.where(owned, s_i_local, 0), mesh, node_axis)
        sum_end_flip = psum(_masked_block_sum(rollout(nbr_local, s_flip),
                                              mask), mesh, node_axis)
        always = torch.ones(a.shape, dtype=torch.bool, device=dev)
        do, sum_end_new, a_new, b_new, _, _, _ = metropolis_anneal_update(
            always, a, b, t, torch.zeros_like(a), sum_end, sum_end_flip, s_i,
            u, par_a=par_a, par_b=par_b, a_cap=a_cap, b_cap=b_cap,
            max_steps=2**31 - 2, n=n_real)
        s_new = torch.where(do[:, None], s_flip, s_local)
        local = (sum_end_new >= n_real).to(torch.float32).mean()
        consensus = pmean(pmean(local, mesh, replica_axis), mesh, node_axis)
        return s_new, sum_end_new, a_new, b_new, key, t + 1, consensus

    return step


def place_sharded(mesh, x, spec, device=None) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (one mesh axis name or None
    per leading dimension, the ``PartitionSpec`` of the JAX package): each
    named dimension splits evenly over that axis. On ``device`` (default:
    :func:`graphdyn_torch.parallel.mesh.rank_device`)."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    idx = []
    for d, ax in enumerate(spec):
        if ax is None:
            idx.append(slice(None))
            continue
        P, k = axis_size(mesh, ax), axis_index(mesh, ax)
        if x.shape[d] % P:
            raise ValueError(f"dimension {d} of size {x.shape[d]} does not "
                             f"split over {P} {ax!r} ranks")
        b = x.shape[d] // P
        idx.append(slice(k * b, (k + 1) * b))
    return x[tuple(idx)].contiguous().to(rank_device(device))
