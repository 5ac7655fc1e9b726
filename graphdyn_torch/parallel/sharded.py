"""Node-axis sharding by a full gather per step, over a ``DeviceMesh``
(the port of the node half of ``graphdyn/parallel/sharded.py``).

Replicas split over the mesh's ``"replica"`` dimension and, for a graph too
large for one card, nodes over ``"node"``: each rank owns a contiguous node
block and that block's neighbor-table rows, and one int8 ``all_gather`` of
the spin block per synchronous step (:func:`graphdyn_torch.parallel.mesh.
all_gather_tiled`) gives it every spin it reads. This is the gather mode:
the parity baseline of the halo exchange (:mod:`graphdyn_torch.parallel.
halo`) and the cheaper path for small graphs.

The edge-sharded BDCM sweep (:func:`make_sharded_sweep`) and fixed point
(:func:`make_sharded_fixed_point`) keep chi replicated on every rank of the
mesh's ``edge`` dimension and split each degree class's edges: per class
(in the Gauss-Seidel order of the unsharded sweep) rank ``r`` updates its
``Ed/P`` slice through :func:`graphdyn_torch.ops.bdcm.dp_contract_grouped`
(on the card one launch of the per-class kernel K3, ``csrc/
bdcm_contract.cu``), and one ``all_gather_into_tensor`` of the slice's new
rows (:func:`graphdyn_torch.parallel.mesh.all_gather_tiled`) gives every
rank the class's update before the next class reads it. A sweep needs that
collective between classes, so the one-launch sweep kernel K3′ does not
serve here.

Every function here runs on one rank: tensors are the rank's blocks, and
the mesh's groups carry the collectives.
"""

from __future__ import annotations

import numpy as np
import torch

from graphdyn_torch.analysis.contracts import contract
from graphdyn_torch.ops.dynamics import rule_coefficients
from graphdyn_torch.parallel.mesh import (
    NODE,
    REPLICA,
    all_gather_tiled,
    axis_index,
    axis_size,
    pmax,
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
    return torch.arange(g0, g0 + n_block, dtype=torch.int64,
                        device=device) < n_real


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

    @contract(nbr_local="int32[nb,d]", s_local="int8[r,nb]",
              ret="int8[r,nb]")
    def rollout(nbr_local, s_local):
        mask = _real_mask(mesh, node_axis, s_local.shape[1], n_real,
                          s_local.device)
        s = s_local
        for _ in range(steps):
            # graftlint: disable-next-line=GD013  legacy gather mode: the parity baseline the halo path (parallel/halo.py) is tested against, and the small-graph fallback
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


# ---------------------------------------------------------------------------
# edge-sharded BDCM sweep and fixed point
# ---------------------------------------------------------------------------


class _EdgeSlices:
    """Per class of ``data`` (in class order): the class's edge ids padded
    to a multiple of the shard count by repeating its first edge
    (``graphdyn/parallel/sharded.py:296-304``), and this rank's slice of
    them and of their incoming-edge table, as int64 tensors on ``device``.
    ``rows`` is chi's row count (the ghost row included when the classes
    are padded)."""

    def __init__(self, data, mesh, edge_axis: str, device):
        P = axis_size(mesh, edge_axis)
        r = axis_index(mesh, edge_axis)
        self.classes = []
        for cls in data.edge_classes:
            Ed = cls.idx.shape[0]
            pad = (-Ed) % P
            idx = np.concatenate([cls.idx, np.repeat(cls.idx[:1], pad)])
            ins = np.concatenate(
                [cls.in_edges, np.repeat(cls.in_edges[:1], pad, axis=0)])
            b = idx.shape[0] // P
            sl = slice(r * b, (r + 1) * b)

            def t(x):
                return torch.as_tensor(np.asarray(x, np.int64), device=device)

            self.classes.append((int(cls.d), Ed, t(cls.idx), t(idx[sl]),
                                 t(ins[sl])))
        self.rows = data.num_directed + (1 if data.padded else 0)


def _sharded_sweep_core(data, mesh, *, damp: float, eps_clamp: float,
                        mask_invalid_src: bool, edge_axis: str, kernel: str,
                        device):
    """The shared core of :func:`make_sharded_sweep` and
    :func:`make_sharded_fixed_point`: ``one(chi, a_tilted) -> chi'`` over
    chi ``[2E, K, K]`` replicated on every rank of ``edge_axis``
    (module docstring), and its per-class modes. ``chi`` is not written.
    While recording, each class's update runs in a
    ``parallel.sharded.contract`` span and its gather in a
    ``parallel.sharded.gather`` span, each closed once the card has
    finished it (two synchronisations a class, only while recording)."""
    from graphdyn_torch import obs
    from graphdyn_torch.ops.bdcm import dp_contract_grouped, resolve_modes

    dev = rank_device(device)
    sl = _EdgeSlices(data, mesh, edge_axis, dev)
    modes = resolve_modes([d for d, *_ in sl.classes], T=data.T,
                          dtype=data.dtype, kernel=kernel, device=dev)
    valid = torch.as_tensor(data.valid, dtype=data.dtype, device=dev)
    K = data.K

    def fence(rec):
        if rec.enabled and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one(chi: torch.Tensor, a_tilted) -> torch.Tensor:
        rec = obs.current()
        n_real = chi.shape[0]
        new = chi.clone()
        if data.padded:
            # the ghost row padded class members gather from and write to
            new = torch.cat([new, new.new_full((1, K, K), 1.0 / (K * K))])
        for k, ((d, Ed, idx_all, idx_r, ins_r), mode, a) in enumerate(
                zip(sl.classes, modes, a_tilted)):
            with rec.span("parallel.sharded.contract", cls=k):
                chi_in = new[ins_r]                          # [Ed/P, d, K, K]
                if mask_invalid_src:
                    chi_in = chi_in * valid[:, None]
                upd = dp_contract_grouped(chi_in[None], a, new[idx_r][None],
                                          d=d, T=data.T, damp=damp,
                                          eps_clamp=eps_clamp,
                                          kernel=mode)[0]
                fence(rec)
            with rec.span("parallel.sharded.gather", cls=k):
                # graftlint: disable-next-line=GD013  edge-sharded BDCM sweep: chi is replicated by design, each class's updated rows gathered once a class (the JAX package's sharded sweep)
                rows = all_gather_tiled(upd, mesh, edge_axis, dim=0)
                # the padded tail repeats the first edge's update: the real
                # rows are the first Ed, in class order
                new.index_copy_(0, idx_all, rows[:Ed])
                fence(rec)
        return new[:n_real]

    return one, modes


def make_sharded_sweep(data, mesh, *, damp: float, eps_clamp: float = 0.0,
                       mask_invalid_src: bool = True, edge_axis: str = "edge",
                       kernel: str = "auto", device=None):
    """The edge-parallel BDCM sweep ``(chi, lmbd) -> chi'`` over ``mesh``'s
    ``edge_axis`` (module docstring; ``graphdyn/parallel/sharded.py:
    340-366``), chi ``[2E, K, K]`` replicated on every rank of it, the
    tilt folded into each class's factor as the unsharded
    :func:`graphdyn_torch.ops.bdcm.make_sweep` folds it. Every rank of the
    axis calls it together with the same chi; every rank gets the same
    result. On the CPU (the plain class update, whose rows do not depend on
    the slice) it equals the unsharded sweep bit for bit."""
    from graphdyn_torch.ops.bdcm import tilted_factors

    dev = rank_device(device)
    one, modes = _sharded_sweep_core(
        data, mesh, damp=float(damp), eps_clamp=float(eps_clamp),
        mask_invalid_src=bool(mask_invalid_src), edge_axis=edge_axis,
        kernel=kernel, device=dev)
    As = [torch.as_tensor(cls.A, dtype=data.dtype, device=dev)
          for cls in data.edge_classes]
    x0 = torch.as_tensor(data.x0, dtype=data.dtype, device=dev)

    def sweep(chi, lmbd):
        return one(chi, tilted_factors(As, x0, lmbd))

    sweep.modes = modes
    return sweep


def make_sharded_fixed_point(data, mesh, *, damp: float, eps: float,
                             max_sweeps: int, eps_clamp: float = 0.0,
                             edge_axis: str = "edge", kernel: str = "auto",
                             device=None):
    """The edge-sharded BP fixed point ``(chi, lmbd) -> (chi*, sweeps,
    delta)`` (``graphdyn/parallel/sharded.py:369-403``): every sweep is
    :func:`make_sharded_sweep`'s (invalid sources masked), and one
    ``all_reduce(MAX)`` of ``max|Δchi|`` a sweep feeds the JAX package's
    stop rule (``delta > eps`` and ``t < max_sweeps``), in the chunks of
    :func:`graphdyn_torch.ops.bdcm.run_fixed_point` with one host read per
    chunk. The factors are tilted per λ as the unsharded
    :func:`graphdyn_torch.ops.bdcm.make_fixed_point` tilts them, so on the
    CPU the two agree bit for bit. While recording, the sweeps' classes
    run in the spans of :func:`_sharded_sweep_core`."""
    from graphdyn_torch.ops.bdcm import (
        CHUNK_SWEEPS,
        run_fixed_point,
        tilt_vector,
    )

    dev = rank_device(device)
    one, modes = _sharded_sweep_core(
        data, mesh, damp=float(damp), eps_clamp=float(eps_clamp),
        mask_invalid_src=True, edge_axis=edge_axis, kernel=kernel,
        device=dev)
    As = [torch.as_tensor(cls.A, dtype=data.dtype, device=dev)
          for cls in data.edge_classes]

    def fixed_point(chi, lmbd):
        tilt = tilt_vector(lmbd, data.x0, data.dtype).to(dev)
        a_t = [A * tilt[:, None, None] for A in As]
        return run_fixed_point(
            lambda c: one(c, a_t), chi, eps=float(eps), t_max=int(max_sweeps),
            chunk_sweeps=CHUNK_SWEEPS,
            reduce=lambda d: pmax(d, mesh, edge_axis))

    fixed_point.modes = modes
    return fixed_point
