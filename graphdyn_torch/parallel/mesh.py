"""Process groups, meshes and the collectives of the port's sharded paths
(the port of ``graphdyn/parallel/mesh.py``).

One process per card, through ``torch.distributed``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
the JAX package's axis names (``"replica"``, ``"node"``); a JAX collective
over a named axis becomes one over that dimension's process group:

- ``psum`` → ``all_reduce`` (:func:`psum`);
- ``all_gather(tiled=True)`` → ``all_gather_into_tensor``
  (:func:`all_gather_tiled`);
- ``ppermute`` slabs → ``batch_isend_irecv`` with one ``P2POp`` pair per
  schedule offset δ (:func:`exchange`).

Backends: NCCL on the card, one rank per card; gloo on the CPU, and for
ranks that share one card (NCCL refuses two ranks on one device). gloo
takes no CUDA tensor for an all-gather or a point-to-point op, so where the
group's backend is gloo and the tensor lies on the card, the collective
stages through pinned host buffers (:func:`staged`): chosen by the group's
backend, never as a fallback after a failure.

:func:`init_distributed` is the one place a process group is made (the
counterpart of ``init_multihost``): it keeps the ``multihost.init`` fault
site, the jittered retry with ``retry_deadline_s``, and the no-op for a
single process.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

REPLICA = "replica"
NODE = "node"

#: transient rendezvous failures worth waiting out (the JAX package's list)
_TRANSIENT = ("unavailable", "connection refused", "failed to connect",
              "deadline", "timed out", "timeout")


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def local_world_size() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` (set by ``torchrun``), else
    the world size."""
    n = _env_int("LOCAL_WORLD_SIZE")
    if n is not None:
        return n
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This rank's index on its host: ``LOCAL_RANK``, else the global rank."""
    r = _env_int("LOCAL_RANK")
    if r is not None:
        return r
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """The device of this rank: ``cuda:<local rank mod cards>`` on the card
    (ranks beyond the card count share cards round-robin), the CPU when
    asked. Raises without a card unless given ``device="cpu"``."""
    from graphdyn_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def default_backend(device: torch.device, on_host: int | None = None) -> str:
    """``nccl`` when every one of the ``on_host`` ranks of this host
    (default :func:`local_world_size`) has a card of its own, else ``gloo``
    (the CPU, or ranks sharing a card)."""
    on_host = local_world_size() if on_host is None else on_host
    if device.type == "cuda" and torch.cuda.device_count() >= on_host:
        return "nccl"
    return "gloo"


def init_distributed(retry_deadline_s: float = 60.0, *,
                     backend: str | None = None,
                     init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None,
                     device: str | torch.device | None = None) -> int:
    """Make this process's default process group and return the world size
    (the counterpart of ``graphdyn.parallel.mesh.init_multihost``).

    The world comes from the arguments or from the launcher's environment
    (``torchrun``: ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/
    ``MASTER_PORT``). Idempotent, and a no-op returning 1 for a single
    process with no world stated, so drivers call it unconditionally.
    ``backend`` defaults to :func:`default_backend` of ``device`` (default
    CUDA; no card raises unless ``device="cpu"``). A rendezvous that is not
    up yet is a race, not an error: the connection retries with jittered
    backoff until ``retry_deadline_s`` (fault site ``multihost.init``),
    keyed by the rank so the ranks de-correlate."""
    from graphdyn_torch.resilience import RetryPolicy, retry
    from graphdyn_torch.resilience import faults as _faults

    if dist.is_initialized():
        return dist.get_world_size()
    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    stated = (world_size is not None or rank is not None
              or init_method is not None or backend is not None)
    if not stated and (world is None or world == 1):
        return 1
    world = 1 if world is None else world
    rank = rank if rank is not None else (_env_int("RANK") or 0)
    dev = rank_device(device)
    if dev.type == "cuda" and dev.index is not None and \
            _env_int("LOCAL_RANK") is None and device in (None, "cuda"):
        # launched without torchrun's LOCAL_RANK: one host, rank = local
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if backend is None:
        backend = default_backend(dev, _env_int("LOCAL_WORLD_SIZE") or world)
    if init_method is None and "MASTER_ADDR" not in os.environ and world == 1:
        store = dist.HashStore()
        kw = {"store": store}
    else:
        kw = {"init_method": init_method or "env://"}

    def connect():
        _faults.maybe_fail("multihost.init")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, world_size=world, rank=rank, **kw)

    def transient(e: BaseException) -> bool:
        if isinstance(e, _faults.InjectedUnavailable):
            return True
        msg = str(e).lower()
        return any(t in msg for t in _TRANSIENT)

    retry(connect,
          policy=RetryPolicy(tries=64, base_delay_s=0.5, max_delay_s=8.0,
                             jitter=True),
          retry_on=(RuntimeError,), retry_if=transient,
          what=f"torch.distributed.init_process_group(rank {rank})",
          deadline_s=retry_deadline_s)
    return dist.get_world_size()


def _ensure_world(device: str | torch.device | None) -> None:
    """A one-process world (in-memory store) when none exists, so a mesh
    of size 1 works without a launcher."""
    if not dist.is_initialized():
        init_distributed(world_size=1, rank=0, device=device,
                         backend=default_backend(rank_device(device)))


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...] | None = None,
              axis_names: tuple[str, ...] = (REPLICA,), *,
              device: str | torch.device | None = None):
    """A ``DeviceMesh`` over the world's ranks in rank order, reshaped to
    ``shape`` (default: every rank on the first axis). Its dimensions are
    named ``axis_names``. Makes a one-process world when there is none."""
    from torch.distributed.device_mesh import DeviceMesh

    _ensure_world(device)
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {np.prod(shape)} "
                         f"ranks; the world has {world}")
    return DeviceMesh(_mesh_device_type(),
                      torch.arange(world).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def make_hybrid_mesh(ici_shape: tuple[int, ...], axis_names: tuple[str, ...],
                     *, dcn_axis: str | None = None,
                     device: str | torch.device | None = None):
    """A mesh with ``dcn_axis`` (default: the first axis) across hosts and
    the other axes inside each host (``graphdyn/parallel/mesh.py:159``):
    node axes ride the host's links, the replica axis the network, which
    the solvers use only for their per-chunk scalar reductions.
    ``ici_shape`` gives the per-host shape of the other axes and must
    cover the host's ranks exactly; the DCN axis size is the host count."""
    from torch.distributed.device_mesh import DeviceMesh

    if dcn_axis is None:
        dcn_axis = axis_names[0]
    if dcn_axis not in axis_names:
        raise ValueError(f"dcn_axis {dcn_axis!r} not in axis_names {axis_names}")
    k = axis_names.index(dcn_axis)
    ici_axes = [a for a in axis_names if a != dcn_axis]
    if len(ici_shape) != len(ici_axes):
        raise ValueError(
            f"ici_shape {ici_shape} must give one size per non-DCN axis "
            f"{tuple(ici_axes)}")
    _ensure_world(device)
    world = dist.get_world_size()
    per_host = local_world_size() if world > 1 else 1
    need = int(np.prod(ici_shape))
    if need != per_host:
        raise ValueError(f"prod(ici_shape)={need} must equal the per-host "
                         f"rank count {per_host}")
    hosts = world // per_host
    ranks = torch.arange(world).reshape((hosts,) + tuple(ici_shape))
    ranks = ranks.movedim(0, k)
    return DeviceMesh(_mesh_device_type(), ranks,
                      mesh_dim_names=tuple(axis_names))


def device_pool(n_devices: int, device: str | torch.device | None = None):
    """``n_devices`` devices for ``n_devices`` ranks: the cards
    ``cuda:0 .. cuda:n-1`` (raises when fewer are visible), or the CPU
    ``n_devices`` times when asked (``device="cpu"``)."""
    from graphdyn_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * n_devices
    have = torch.cuda.device_count()
    if have < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n_devices)]


# ---------------------------------------------------------------------------
# axes and rank-local blocks
# ---------------------------------------------------------------------------


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def _block(n: int, parts: int, idx: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what}: {n} rows do not split into {parts} "
                         "equal blocks")
    b = n // parts
    return slice(idx * b, (idx + 1) * b)


def shard_batch(mesh, x, axis: str = REPLICA, device=None) -> torch.Tensor:
    """This rank's block of ``x`` along its leading axis, split evenly over
    the mesh's ``axis`` (the rank-local view of ``P(axis)``), on
    ``device`` (default: :func:`rank_device`)."""
    x = torch.as_tensor(x)
    sl = _block(x.shape[0], axis_size(mesh, axis), axis_index(mesh, axis),
                "shard_batch")
    return x[sl].to(rank_device(device))


def replicate(mesh, x, device=None) -> torch.Tensor:
    """The whole of ``x`` on this rank (``P()``)."""
    return torch.as_tensor(x).to(rank_device(device))


def shard_stack(mesh, x, axis: str = "group", device=None) -> torch.Tensor:
    """One array of an ensemble stack: a leading axis splits over ``axis``;
    a scalar is replicated."""
    if torch.as_tensor(x).ndim:
        return shard_batch(mesh, x, axis, device)
    return replicate(mesh, x, device)


# ---------------------------------------------------------------------------
# collectives over a named axis
# ---------------------------------------------------------------------------


def staged(group, t: torch.Tensor) -> bool:
    """True when an exchange of ``t`` over ``group`` goes through pinned
    host buffers: the group's backend is gloo and ``t`` lies on the card."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def psum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Σ of ``t`` over ``axis`` (``lax.psum``), returned as a new tensor on
    ``t``'s device; the input is not written."""
    g = axis_group(mesh, axis)
    out = _host(t) if staged(g, t) else t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
    return out.to(t.device)


def pmean(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Mean of ``t`` over ``axis`` (``lax.pmean``): the sum over the
    group divided by its size."""
    return psum(t, mesh, axis) / axis_size(mesh, axis)


def _gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, t, group=group)


def all_gather_tiled(t: torch.Tensor, mesh, axis: str,
                     dim: int = 0) -> torch.Tensor:
    """``lax.all_gather(t, axis, axis=dim, tiled=True)``: the blocks of the
    ranks along ``axis`` concatenated on ``dim`` in rank order."""
    if t.dtype == torch.bool:         # gathered as bytes: not every backend
        return all_gather_tiled(t.to(torch.uint8), mesh, axis, dim).bool()
    g = axis_group(mesh, axis)
    P = axis_size(mesh, axis)
    src = t.movedim(dim, 0).contiguous()
    if staged(g, t):
        src = _host(src)
        out = torch.empty((P,) + tuple(src.shape), dtype=t.dtype,
                          pin_memory=True)
    else:
        out = torch.empty((P,) + tuple(src.shape), dtype=t.dtype,
                          device=t.device)
    _gather_into(out.view(P * src.shape[0], *src.shape[1:]), src, g)
    out = out.to(t.device).reshape((P * src.shape[0],) + tuple(src.shape[1:]))
    return out.movedim(0, dim).contiguous()


def exchange(slabs, deltas, mesh, axis: str) -> list[torch.Tensor]:
    """One ``ppermute`` per offset: rank ``p`` sends ``slabs[k]`` to rank
    ``(p + deltas[k]) mod P`` and receives the slab of rank
    ``(p - deltas[k]) mod P``, all offsets in one ``batch_isend_irecv``.
    Returns the received slabs (same shapes and types as sent)."""
    g = axis_group(mesh, axis)
    P = axis_size(mesh, axis)
    me = axis_index(mesh, axis)
    if not slabs:
        return []
    stage = staged(g, slabs[0])
    sends = [_host(s) if stage else s.contiguous() for s in slabs]
    recvs = [torch.empty(s.shape, dtype=s.dtype, pin_memory=True) if stage
             else torch.empty_like(s) for s in sends]
    ops = []
    for s, r, d in zip(sends, recvs, deltas):
        if d % P == 0:
            r.copy_(s)
            continue
        ops.append(dist.P2POp(dist.isend, s,
                              dist.get_global_rank(g, (me + d) % P), group=g))
        ops.append(dist.P2POp(dist.irecv, r,
                              dist.get_global_rank(g, (me - d) % P), group=g))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    dev = slabs[0].device
    return [r.to(dev) for r in recvs]


class WorldSync:
    """The decisions every rank must take together, over the default
    (world) group: :meth:`any` or-reduces host flags, :meth:`bcast` sends
    rank 0's object to every rank. ``writer`` is True on rank 0, the one
    rank that writes snapshots. Without a process group it is the one
    process's own view."""

    def __init__(self, device=None):
        self.world = dist.is_initialized()
        self.writer = not self.world or dist.get_rank() == 0
        # the world group's backend decides where its flags live
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if self.world and dist.get_backend() == "nccl"
                       else torch.device("cpu"))

    def any(self, *flags: bool) -> tuple[bool, ...]:
        if not self.world:
            return tuple(bool(f) for f in flags)
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return tuple(bool(v) for v in t.tolist())

    def bcast(self, obj):
        if not self.world:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]
