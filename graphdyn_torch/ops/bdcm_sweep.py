"""The one-launch BDCM sweep kernel (K3′): its launch plan, its build, its
launch wrapper and launch counter, and its plain twin.

The kernel (``graphdyn_torch/csrc/bdcm_sweep.cu``) computes one whole
Gauss-Seidel sweep of a group of G instances in one cooperative launch: the
class loop of :func:`graphdyn_torch.ops.bdcm._sweep_core` (the JAX
package's ``graphdyn/ops/bdcm.py:330-372``, XLA gathers around the Pallas
K3), with the gathers of the class inputs, the bias or the validity mask and
the writes of the updated rows inside the kernel. Classes run in
``spec.class_ds`` order with a grid barrier between two; each runs the path
of :func:`graphdyn_torch.ops.bdcm_cuda.launch_plan` (the per-edge bodies
are the per-class kernel's, ``csrc/bdcm_dp.cuh``).

Jacobi inside a class, Gauss-Seidel across classes, by class id: a row
whose class comes before the running class is read from the output, any
other from the input; rows in no class are copied through; padding members
(whose output row is a ghost row, in no class) compute nothing.
:func:`sweep_plain` is that decomposition in PyTorch, the kernel's plain
twin; it equals ``_sweep_core``'s plain route bit for bit on every real
row.

:func:`build_plan` runs once where a sweep is made, on the sweep's device:
int32 copies of the class tables, the int16 class id of every row, the rows
in no class, the int32 source-node table of a node-level bias, and the
launch shape (the block size and the largest dynamic shared memory over the
classes) and the global path's lattice bytes per workspace slot; the
workspace itself is the per-device, per-stream buffer of
:func:`graphdyn_torch.ops.bdcm_cuda.workspace`, which :func:`sweep_cuda`
takes at each launch.
Horizons 1 ≤ T ≤ 6 run at any degree, register, block and global classes
in one launch. The kernel reads the classes' descriptors (tables, factor,
sizes, path) from device memory, which :func:`sweep_cuda` fills once per
set of factors and keeps with the plan, so the class count is bounded only
by the int16 class id. A class the kernel refuses raises: there is no
fallback to the per-class route or the plain version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from graphdyn_torch.attractors import x0_pm
from graphdyn_torch.ops import bdcm_cuda, cuda_build

SOURCE = "bdcm_sweep.cu"
NVCC_FLAGS = cuda_build.BASE_FLAGS
NO_CLASS = 32767           # the class id (int16) of a row in no class
MAX_CLASSES = NO_CLASS     # class ids 0 .. NO_CLASS - 1
DESC_WORDS = 7             # a class descriptor: idx, in_edges, a, Ed,
#                            a_stride, d, path (csrc/bdcm_sweep.cu ClassDesc)
_DESC_CACHE_MAX = 64       # descriptor sets kept per plan

# kernel launches made through sweep_cuda since the last reset; a run shows
# that its path went through the kernel by zeroing this and reading it
LAUNCHES = 0

_lib = None
_lib_lock = threading.Lock()


class NodeBias(NamedTuple):
    """A node-level bias for the sweep: ``values`` [G·n, 2], the biases of
    the nodes; an in-edge row r's source trajectory k is weighed by
    ``values[src[r], 0]`` where x_k(0) = +1, else ``values[src[r], 1]``,
    with ``src`` the sweep tables' source-node table."""

    values: torch.Tensor


class SweepPlan(NamedTuple):
    """The kernel's tables and launch shape for one sweep."""

    G: int
    rows: int                 # rows per group (the ghost row included)
    T: int
    dtype: torch.dtype
    masked: bool              # multiply the inputs by valid[k]
    valid_bits: int           # bit k: valid[k] != 0
    bias_cols: int            # bit k: the node-bias column of x_k
    class_ds: tuple
    paths: tuple              # per class 'register' | 'block' | 'global'
    Ed: tuple                 # members per group, per class
    idx: tuple                # per class int32 [G·Ed] output rows
    in_edges: tuple           # per class int32 [G·Ed, d] input rows
    cid: torch.Tensor         # int16 [G·rows]
    pass_rows: torch.Tensor   # int32 rows in no class
    src: torch.Tensor | None  # int32 [G·rows] source node of each row
    threads: int
    smem: int
    ws_bytes: int             # the global path's lattice bytes per slot
    ws_members: int           # the most members of one global-path class
    descs: dict               # the class descriptors in device memory, by
    #                           their host words (sweep_cuda fills it)


def build() -> str:
    """Compile the kernel library if this source and these flags have not
    been built yet; return its path (:func:`cuda_build.build`)."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cuda_build.load(SOURCE, NVCC_FLAGS)
            fn = lib.graphdyn_bdcm_sweep
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                + [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                           ctypes.c_ulonglong, ctypes.c_int,
                                           ctypes.c_ulonglong,
                                           ctypes.c_longlong]
                + [ctypes.c_int] * 3
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
                + [ctypes.c_double, ctypes.c_double, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
            )
            _lib = lib
        return _lib


def stage_stride(d: int, K: int) -> int:
    """The register path's staged edge stride in elements: an edge's d·K·K
    inputs padded to ≡ K (mod 32) (``stage_stride`` of the kernel)."""
    return d * K * K + (K - (d * K * K) % 32) % 32


def class_smem(d: int, T: int, path: str, threads: int, dtype) -> int:
    """Dynamic shared bytes a class needs at ``threads`` per block: the
    register path stages a tile's inputs and the factor, the block path
    its lattice rows and the edge's shared elements, the global path the
    latter only (:func:`bdcm_cuda.launch_plan`'s count)."""
    esize = 8 if dtype == torch.float64 else 4
    K, M = 2**T, (d + 1) ** T
    if path == "register":
        return (threads // K * stage_stride(d, K) + K * K * M) * esize
    edge = bdcm_cuda.edge_smem_elems(K, threads)
    return (edge if path == "global" else 2 * M + edge) * esize


def launch_shape(class_ds, T: int, dtype) -> tuple[tuple, int, int]:
    """``(paths, threads, smem)`` of a sweep over classes ``class_ds``: each
    class's path from :func:`bdcm_cuda.launch_plan` (register, block and
    global classes mix in one launch), one block size for the whole launch
    (the largest the classes ask for), and the largest shared memory over
    the classes at that size. Raises for a class the kernel refuses, more
    than :data:`MAX_CLASSES` classes, or a class whose shared memory at
    that block size exceeds a block's."""
    if len(class_ds) > MAX_CLASSES:
        raise ValueError(f"the BDCM sweep kernel takes at most {MAX_CLASSES} "
                         f"edge classes, got {len(class_ds)}")
    plans = []
    for d in class_ds:
        if not bdcm_cuda.bdcm_kernel_supported(d, T, dtype):
            raise ValueError(
                f"the CUDA BDCM kernel refuses the class d={d}, T={T}, "
                f"dtype={dtype} ({bdcm_cuda.refusal_reason(d, T, dtype)})")
        plans.append(bdcm_cuda.launch_plan(d, T, dtype))
    paths = tuple(pl["path"] for pl in plans)
    threads = max([pl["threads"] for pl in plans], default=32)
    smem = max([class_smem(d, T, pth, threads, dtype)
                for d, pth in zip(class_ds, paths)], default=0)
    if smem > bdcm_cuda.SMEM_MAX:
        raise ValueError(f"the BDCM sweep needs {smem} bytes of shared memory "
                         f"per block, more than {bdcm_cuda.SMEM_MAX}")
    return paths, threads, smem


def _bits(mask) -> int:
    return int(sum(1 << k for k, v in enumerate(np.asarray(mask)) if v))


def build_plan(tables, *, G: int, rows: int, T: int, dtype, padded: bool,
               masked: bool, valid, src=None) -> SweepPlan:
    """The kernel's plan from the sweep's int64 tables: per class ``(idx
    [G, Ed], in_edges [G, Ed, d])`` ids into the ``[G·rows]`` rows (a
    padded sweep's padding members point at the ghost row ``rows − 1`` of
    their group), ``valid`` the [K] mask, ``src`` the int64 [G·rows] source
    node of each row for a node-level bias (or None). Built on the tables'
    device. Checks once, with one host read, that every table id lies
    within the rows and that no row belongs to two classes."""
    dev = tables[0][0].device if tables else valid.device
    K = 2**T
    total = G * rows
    if total >= 2**31:
        raise ValueError(f"the BDCM sweep kernel indexes rows in int32: "
                         f"{total} rows")
    class_ds = tuple(int(ie.shape[-1]) for _, ie in tables)
    paths, threads, smem = launch_shape(class_ds, T, dtype)
    cid = torch.full((total,), NO_CLASS, dtype=torch.int16, device=dev)
    count = torch.zeros(total, dtype=torch.int32, device=dev)
    idx32, ie32, Eds, bounds = [], [], [], []
    for c, (idx, ie) in enumerate(tables):
        idx = idx.reshape(-1)
        ie = ie.reshape(idx.shape[0], -1)
        real = idx[idx % rows != rows - 1] if padded else idx
        cid[real] = c
        count.index_add_(0, real, torch.ones_like(real, dtype=torch.int32))
        if idx.numel():
            bounds += [idx.min(), idx.max(), ie.min(), ie.max()]
        idx32.append(idx.to(torch.int32).contiguous())
        ie32.append(ie.to(torch.int32).contiguous())
        Eds.append(int(idx.shape[0]) // G)
    vals = torch.stack(bounds + [count.max().long()]).tolist()
    if bounds and (min(vals[:-1]) < 0 or max(vals[:-1]) >= total):
        raise ValueError(f"sweep tables index outside the {total} rows")
    if vals[-1] > 1:
        raise ValueError("a row belongs to two edge classes")
    pass_rows = torch.nonzero(cid == NO_CLASS).reshape(-1).to(torch.int32)
    sel_plus = x0_pm(T) == 1
    glob = [(bdcm_cuda.launch_plan(d, T, dtype)["workspace"], G * E)
            for d, pth, E in zip(class_ds, paths, Eds) if pth == "global"]
    return SweepPlan(
        G=G, rows=rows, T=T, dtype=dtype, masked=bool(masked),
        valid_bits=_bits(torch.as_tensor(valid).cpu().numpy() != 0),
        bias_cols=sum((0 if sel_plus[k] else 1) << k for k in range(K)),
        class_ds=class_ds, paths=paths, Ed=tuple(Eds), idx=tuple(idx32),
        in_edges=tuple(ie32), cid=cid, pass_rows=pass_rows.contiguous(),
        src=None if src is None else src.to(torch.int32).contiguous(),
        threads=threads, smem=smem,
        ws_bytes=max([w for w, _ in glob], default=0),
        ws_members=max([e for _, e in glob], default=0), descs={})


def _check(chi, a_tilted, bias, plan: SweepPlan):
    """The launch's checks: types, devices, shapes, contiguity and the
    16-byte alignment of chi's rows."""
    if not isinstance(plan, SweepPlan):
        raise TypeError("the CUDA sweep runs from a SweepPlan (build_plan)")
    K = 2**plan.T
    if chi.device.type != "cuda":
        raise ValueError(f"bdcm sweep: chi is on {chi.device}, not CUDA")
    if chi.dtype != plan.dtype:
        raise TypeError(f"bdcm sweep: chi is {chi.dtype}, the plan {plan.dtype}")
    if tuple(chi.shape) != (plan.G, plan.rows, K, K):
        raise ValueError(f"bdcm sweep: chi shape {tuple(chi.shape)} != "
                         f"{(plan.G, plan.rows, K, K)}")
    if not chi.is_contiguous() or chi.data_ptr() % 16:
        raise ValueError("bdcm sweep: chi must be contiguous and 16-byte "
                         "aligned")
    if plan.cid.device != chi.device:
        raise ValueError("bdcm sweep: the plan's tables are on "
                         f"{plan.cid.device}, chi on {chi.device}")
    if len(a_tilted) != len(plan.class_ds):
        raise ValueError(f"bdcm sweep: {len(a_tilted)} factors for "
                         f"{len(plan.class_ds)} classes")
    for a, d in zip(a_tilted, plan.class_ds):
        M = (d + 1) ** plan.T
        if (a.device != chi.device or a.dtype != chi.dtype
                or not a.is_contiguous()
                or tuple(a.shape) not in ((K, K, M), (plan.G, K, K, M))):
            raise ValueError(f"bdcm sweep: factor of class d={d}: "
                             f"{tuple(a.shape)} {a.dtype} on {a.device}")
    v, _, _, _ = bias_args(bias, plan)
    if v is not None and (v.device != chi.device or v.dtype != chi.dtype
                          or not v.is_contiguous()):
        raise ValueError("bdcm sweep: the bias must be a contiguous tensor of "
                         "chi's dtype and device")


def bias_args(bias, plan: SweepPlan):
    """The kernel's bias read ``(values, src, stride, cols)``: per-row
    weights ``[G, rows, K]`` are read at row r, column k (no source table,
    stride K, the identity columns; ``cols`` 0); a :class:`NodeBias` at the
    source node ``src[r]``, column 0 where x_k(0) = +1 else 1 (stride 2),
    ``cols`` bit k holding the column of trajectory k; ``(None, None, 0,
    0)`` without a bias."""
    K = 2**plan.T
    if bias is None:
        return None, None, 0, 0
    if isinstance(bias, NodeBias):
        v = bias.values
        if plan.src is None:
            raise ValueError("bdcm sweep: a node bias needs the plan's "
                             "source-node table")
        if v.ndim != 2 or v.shape[1] != 2:
            raise ValueError(f"bdcm sweep: node bias shape {tuple(v.shape)}")
        return v, plan.src, 2, plan.bias_cols
    if tuple(bias.shape) != (plan.G, plan.rows, K):
        raise ValueError(f"bdcm sweep: bias shape {tuple(bias.shape)} != "
                         f"{(plan.G, plan.rows, K)}")
    return bias, None, K, 0


def class_descriptors(a_tilted, plan: SweepPlan) -> np.ndarray:
    """The kernel's class descriptors, int64 ``[classes, DESC_WORDS]``: per
    class the device addresses of its output rows, its in-edges and its
    factor, its members per group, the factor's group stride (0 when
    shared), d, and its path."""
    K = 2**plan.T
    out = np.zeros((len(plan.class_ds), DESC_WORDS), np.int64)
    for c, (a, d) in enumerate(zip(a_tilted, plan.class_ds)):
        out[c] = (plan.idx[c].data_ptr(), plan.in_edges[c].data_ptr(),
                  a.data_ptr(), plan.Ed[c],
                  K * K * (d + 1) ** plan.T if a.ndim == 4 else 0, d,
                  bdcm_cuda.PATHS[plan.paths[c]])
    return out


def _device_descriptors(host: np.ndarray, plan: SweepPlan, device):
    """``host``'s words in device memory, copied once per distinct set and
    kept in ``plan.descs`` (at most ``_DESC_CACHE_MAX``, the oldest
    dropped): a sweep repeated with the same factors copies nothing. The
    words are plain values, so a set equal to a kept one is that one."""
    key = host.tobytes()
    descs = plan.descs.get(key)
    if descs is None:
        if len(plan.descs) >= _DESC_CACHE_MAX:
            plan.descs.pop(next(iter(plan.descs)))
        descs = torch.from_numpy(host.reshape(-1).copy()).to(device)
        plan.descs[key] = descs
    return descs


def sweep_cuda(chi: torch.Tensor, a_tilted, bias, plan: SweepPlan, *,
               damp: float, eps_clamp: float) -> torch.Tensor:
    """One sweep of ``chi`` [G, rows, K, K] in one launch on the current
    CUDA stream; returns a new tensor (``chi`` is not written). ``a_tilted``:
    per class ``[K, K, M]`` (shared) or ``[G, K, K, M]`` (per group);
    ``bias``: None, per-row weights ``[G, rows, K]``, or a :class:`NodeBias`.
    Does not synchronise."""
    global LAUNCHES
    _check(chi, a_tilted, bias, plan)
    v, src, stride, cols = bias_args(bias, plan)
    out = torch.empty_like(chi)
    n = len(plan.class_ds)
    host = class_descriptors(a_tilted, plan)
    descs = _device_descriptors(host, plan, chi.device)
    fn = _library().graphdyn_bdcm_sweep
    with torch.cuda.device(chi.device):
        ws, slots = bdcm_cuda.workspace(chi.device, plan.ws_bytes,
                                        plan.ws_members)
        rc = fn(chi.data_ptr(), out.data_ptr(), plan.cid.data_ptr(),
                plan.pass_rows.data_ptr() if plan.pass_rows.numel() else None,
                plan.pass_rows.numel(),
                None if v is None else v.data_ptr(),
                None if src is None else src.data_ptr(), stride, cols,
                int(plan.masked), plan.valid_bits, plan.G,
                plan.T, int(chi.dtype == torch.float64), n,
                host.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                descs.data_ptr() if n else None,
                float(damp), float(eps_clamp), plan.threads, plan.smem,
                None if ws is None else ws.data_ptr(), slots,
                torch.cuda.current_stream(chi.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bdcm sweep: kernel launch failed, cudaError {rc}")
    LAUNCHES += 1
    return out


def sweep_plain(chi: torch.Tensor, a_tilted, bias, plan: SweepPlan, *,
                damp: float, eps_clamp: float) -> torch.Tensor:
    """The kernel's decomposition in PyTorch on any device, from the same
    plan: the rows in no class copied through, then per class the inputs
    read by class id (rows of earlier classes from the output, any other
    from the input), weighed by the bias (read through the source node for
    a :class:`NodeBias`) and the mask, the plain class update
    (:func:`graphdyn_torch.ops.bdcm.dp_contract_grouped_plain`) and the
    write of the live members' rows. Equals ``_sweep_core``'s plain route
    bit for bit on every row a real member or no class owns."""
    from graphdyn_torch.ops.bdcm import dp_contract_grouped_plain

    G, rows, T = plan.G, plan.rows, plan.T
    K = 2**T
    dev = chi.device
    src = chi.reshape(G * rows, K, K)
    out = torch.empty_like(src)
    pr = plan.pass_rows.to(dev).long()
    out[pr] = src[pr]
    cid = plan.cid.to(dev).long()
    if bias is None:
        w = None
    elif isinstance(bias, NodeBias):
        s = plan.src.to(dev).long()
        cols = torch.tensor([(plan.bias_cols >> k) & 1 for k in range(K)],
                            device=dev)
        w = bias.values[s][:, cols]                          # [G·rows, K]
    else:
        w = bias.reshape(G * rows, K)
    valid = torch.tensor([(plan.valid_bits >> k) & 1 for k in range(K)],
                         dtype=chi.dtype, device=dev)
    for c, (d, a) in enumerate(zip(plan.class_ds, a_tilted)):
        Ed = plan.Ed[c]
        idx = plan.idx[c].to(dev).long().reshape(G, Ed)
        ie = plan.in_edges[c].to(dev).long().reshape(G, Ed, d)
        live = cid[idx] == c
        upd = (cid[ie] < c)[..., None, None]
        chi_in = torch.where(upd, out[ie], src[ie])         # [G, Ed, d, K, K]
        if w is not None:
            chi_in = chi_in * w[ie][..., None]
        if plan.masked:
            chi_in = chi_in * valid[:, None]
        new = dp_contract_grouped_plain(chi_in, a, src[idx], d=d, T=T,
                                        damp=damp, eps_clamp=eps_clamp)
        out[idx[live]] = new[live]
    return out.reshape(G, rows, K, K)
