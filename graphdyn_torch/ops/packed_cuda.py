"""The CUDA packed-step kernel: its build, its launch wrapper, its launch
counter, its fast-path gate and its launch plan.

The kernel (``graphdyn_torch/csrc/packed_step.cu``) replaces the JAX
package's Pallas kernels K1 (``graphdyn/ops/pallas_packed.py:
pallas_packed_step``) and K2 (``_general_step_ext``): one synchronous packed
majority/minority step on the ghost-extended state ``[n+1, W]``. It walks
the state in node order with 16-byte vectors; :func:`launch_plan` chooses
the thread's width and :func:`index_map` is the kernel's index map, word
for word, for the tests.

Build: ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ctypes at the first CUDA use, through
:mod:`graphdyn_torch.ops.cuda_build` (never at import). There is no
fallback: when a CUDA tensor reaches :func:`packed_step` and the build or the
launch fails, it raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from graphdyn_torch.ops import cuda_build

SOURCE = "packed_step.cu"
NVCC_FLAGS = cuda_build.BASE_FLAGS
MAX_PLANES = 32         # the kernel's widest instantiation: any int32 dmax
THREADS = 256           # per block

# kernel launches made through packed_step since the last reset; a run shows
# that its path went through the kernel by zeroing this and reading it after
LAUNCHES = 0

_lib = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile the kernel library if this source and these flags have not
    been built yet; return its path (:func:`cuda_build.build`)."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cuda_build.load(SOURCE, NVCC_FLAGS)
            fn = lib.graphdyn_packed_step
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            _lib = lib
        return _lib


def n_planes(dmax: int) -> int:
    """Bit planes of the per-replica counter: bit_length(dmax) counts up to
    dmax exactly."""
    return max(int(dmax).bit_length(), 1)


def launch_plan(W: int, *, aligned: bool = True) -> dict:
    """The kernel's work split for rows of W words: ``U`` words per thread
    (4, a uint4, when W is a multiple of 4 and the states are 16-byte
    aligned; else 1) and ``VPR`` = W / U threads per row."""
    U = 4 if W % 4 == 0 and aligned else 1
    return {"U": U, "VPR": W // U}


def index_map(n: int, W: int, plan: dict):
    """Yield ``(thread, row, first_word, words)`` for every thread of a
    launch over the ghost-extended state ``[n+1, W]`` that touches words:
    the kernel's own arithmetic (``packed_step_kernel``), for tests."""
    U, vpr = plan["U"], plan["VPR"]
    total = (n + 1) * vpr
    for t in range(-(-total // THREADS) * THREADS):
        if t >= total:
            continue
        row, v = divmod(t, vpr)
        yield t, row, v * U, U


def fast_path_degree(deg, rule: str) -> int:
    """K1's gate (``graphdyn/ops/pallas_packed.py:pallas_packed_supported``):
    the uniform degree when every degree is the same odd number and the rule
    is majority or minority, else 0. Ties cannot occur then, so the kernel
    skips the own-row read and the tie mask. Computed on the host, once per
    graph and rollout, never per step (a CUDA ``deg`` is copied back once)."""
    d = np.asarray(deg.cpu() if isinstance(deg, torch.Tensor) else deg)
    if d.size == 0 or rule not in ("majority", "minority"):
        return 0
    d0 = int(d.flat[0])
    return d0 if d0 % 2 == 1 and bool((d == d0).all()) else 0


def check_tables(nbr: torch.Tensor, deg: torch.Tensor) -> None:
    """Refuse tables the kernel would read out of bounds with: neighbor
    indices outside [0, n] (n is the ghost row) or degrees outside
    [0, dmax]. One reduction and one host read per call, so callers check
    once per graph and rollout, not per step."""
    n, dmax = nbr.shape
    if n == 0:
        return
    bounds = torch.stack([nbr.min(), nbr.max(), deg.min().to(nbr.dtype),
                          deg.max().to(nbr.dtype)]).tolist()
    if bounds[0] < 0 or bounds[1] > n or bounds[2] < 0 or bounds[3] > dmax:
        raise ValueError(
            f"packed tables out of range: nbr in [{bounds[0]}, {bounds[1]}] "
            f"(must be within [0, {n}]), deg in [{bounds[2]}, {bounds[3]}] "
            f"(must be within [0, {dmax}])"
        )


def check_launch(nbr: torch.Tensor, deg: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor) -> tuple[int, int, int, int]:
    """Check the types, devices, shapes and contiguity that a launch needs,
    and return its dimensions ``(n, dmax, W, planes)`` for :func:`_launch`."""
    for name, t in (("nbr", nbr), ("deg", deg), ("src", src), ("dst", dst)):
        if t.device.type != "cuda":
            raise ValueError(f"packed_step: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.int32:
            raise TypeError(f"packed_step: {name} is {t.dtype}, not torch.int32")
        if not t.is_contiguous():
            raise ValueError(f"packed_step: {name} is not contiguous")
        if t.device != src.device:
            raise ValueError("packed_step: tensors on different devices")
    if nbr.ndim != 2 or src.ndim != 2:
        raise ValueError("packed_step: nbr and src must be 2-D")
    n, dmax = nbr.shape
    W = src.shape[1]
    if tuple(deg.shape) != (n,):
        raise ValueError(f"packed_step: deg shape {tuple(deg.shape)} != ({n},)")
    if tuple(src.shape) != (n + 1, W) or tuple(dst.shape) != (n + 1, W):
        raise ValueError(
            f"packed_step: states must be [n+1, W] = [{n + 1}, {W}], got "
            f"{tuple(src.shape)} and {tuple(dst.shape)}"
        )
    if src.data_ptr() == dst.data_ptr():
        raise ValueError("packed_step: src and dst must be distinct buffers")
    if W < 1:
        raise ValueError("packed_step: W must be >= 1")
    planes = n_planes(dmax)
    if planes > MAX_PLANES:
        raise ValueError(
            f"packed_step: dmax={dmax} needs {planes} bit planes; the kernel "
            f"takes at most {MAX_PLANES}"
        )
    return n, dmax, W, planes


def kernel_planes(planes: int) -> int:
    """The instantiation a launch of ``planes`` bit planes runs: the exact
    count up to 6 (dmax 63), else the next of 8, 16 and 32 (the extra
    planes stay zero)."""
    if planes <= 6:
        return planes
    return next(k for k in (8, 16, 32) if planes <= k)


def _launch(nbr, deg, src, dst, dims, minority: bool, change: bool,
            d_uniform: int, plan: dict) -> None:
    """Launch the kernel on the current stream with no checks: ``dims``
    comes from :func:`check_launch` and ``plan`` from :func:`launch_plan` on
    tensors of these shapes and alignment."""
    global LAUNCHES
    n, dmax, W, planes = dims
    fn = _library().graphdyn_packed_step
    with torch.cuda.device(src.device):
        rc = fn(
            nbr.data_ptr(), deg.data_ptr(), src.data_ptr(), dst.data_ptr(),
            n, dmax, W, planes, int(d_uniform > 0), int(d_uniform),
            int(minority), int(change), plan["U"],
            torch.cuda.current_stream(src.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"packed_step: kernel launch failed, cudaError {rc}")
    LAUNCHES += 1


def aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def packed_step(nbr: torch.Tensor, deg: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, *, minority: bool, change: bool,
                d_uniform: int = 0) -> None:
    """Launch one packed step ``src -> dst`` on the current CUDA stream.

    ``nbr: int32[n, dmax]`` (ghost-padded with n), ``deg: int32[n]``,
    ``src``/``dst``: distinct ``int32[n+1, W]`` ghost-extended states carrying
    uint32 bit patterns (row n is the ghost row; the kernel writes it 0).
    ``d_uniform`` > 0 takes the uniform-odd fast path (see
    :func:`fast_path_degree`). The caller
    checks the tables once with :func:`check_tables`; this wrapper checks
    types, devices, shapes and contiguity with :func:`check_launch` on every
    call. Does not synchronise."""
    dims = check_launch(nbr, deg, src, dst)
    plan = launch_plan(dims[2], aligned=aligned16(src, dst))
    _launch(nbr, deg, src, dst, dims, minority, change, d_uniform, plan)
