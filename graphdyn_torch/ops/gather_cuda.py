"""The CUDA row-gather kernel: its build, its launch wrapper and its launch
counter.

The kernel (``graphdyn_torch/csrc/row_gather.cu``) replaces the JAX
package's Pallas kernel P (``scripts/pallas_gather_probe.py:63``,
``pallas_gather``): ``out[i] = src[idx[i]]`` over rows of 4-byte words. It
computes what :func:`graphdyn_torch.ops.gather.row_gather_plain` computes,
bit for bit.

:func:`launch_plan` picks the path and its depth per launch: the
``'vector'`` path (16-byte vectors) for rows of a multiple of 16 bytes with
both arrays 16-byte aligned, ``'words'`` (single words) otherwise, each
with the rows in flight per thread and the store policy measured best for
the row width on an H100 (:func:`vector_plan`). A TMA version (one bulk
copy per row through shared-memory stages) measured slower than the vector
path at every width from 16 to 1024 words and is not kept (PERF.md, the
kernel table's P rows).

Build: ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ctypes at the first CUDA use, through
:mod:`graphdyn_torch.ops.cuda_build` (never at import). A failed build or
launch raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from graphdyn_torch.ops import cuda_build

SOURCE = "row_gather.cu"
NVCC_FLAGS = cuda_build.BASE_FLAGS
DEPTHS = (1, 2, 4, 8, 16)      # the kernel's rows in flight per thread
DEFAULT_DEPTH = 8               # the words path's
PATHS = {"words": 0, "vector": 1}

# kernel launches made through row_gather_cuda since the last reset; a run
# shows that its path went through the kernel by zeroing this and reading it
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
            fn = lib.graphdyn_row_gather
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 3
                           + [ctypes.c_longlong, ctypes.c_longlong]
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            _lib = lib
        return _lib


def vector_words(src: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether a launch moves 16-byte vectors: rows of a multiple of 4
    words and both arrays 16-byte aligned (else single words)."""
    return (src.shape[1] % 4 == 0 and src.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)


def vector_plan(W: int, vec: bool = True) -> tuple[int, bool]:
    """``(depth, streaming)`` of the vector path (``vec``) or the words path
    for rows of ``W`` words: the rows in flight per thread and whether
    stores are streaming (``__stcs``) or write-back. Chosen on an H100 at
    700 W from depths 1-16 and both store policies: depth 1 with write-back
    stores from 512 words, depth 2 (streaming) from 32, depth 4 below; the
    words path keeps depth 8. Timed in turns against depth 8 with streaming
    stores, the first plan, on an H100 (PERF.md): W=512 1.034 against 1.054
    ms, W=1024 1.043 / 1.063, the headline's gather 4.126 / 4.199, W=128
    1.026 / 1.028, HPr config 2's 64-byte chi rows 8.539 / 8.565."""
    if not vec:
        return DEFAULT_DEPTH, True
    if W >= 512:
        return 1, False
    return (2, True) if W >= 32 else (4, True)


def launch_plan(W: int, aligned: bool, *, depth: int | None = None) -> dict:
    """The launch of one gather of rows of ``W`` words, ``aligned`` when both
    arrays are 16-byte aligned: ``path`` (``'vector'`` where the rows are a
    multiple of 4 words and aligned, else ``'words'``), ``depth`` (the
    plan's, or ``depth`` when given) and ``streaming`` (:func:`vector_plan`)."""
    vec = aligned and W % 4 == 0
    d, st = vector_plan(W, vec)
    return {"path": "vector" if vec else "words",
            "depth": d if depth is None else depth, "streaming": st}


def check_launch(src: torch.Tensor, idx: torch.Tensor,
                 depth: int | None) -> None:
    """Check the depth (None: the plan's), types, devices, shapes and
    contiguity a launch needs."""
    if depth is not None and depth not in DEPTHS:
        raise ValueError(f"row_gather: depth {depth} not in {DEPTHS}")
    if src.dtype != torch.int32:
        raise TypeError(f"row_gather: src is {src.dtype}, not int32 words")
    if idx.dtype != torch.int32:
        raise TypeError(f"row_gather: idx is {idx.dtype}, not int32")
    for name, t in (("src", src), ("idx", idx)):
        if t.device.type != "cuda":
            raise ValueError(f"row_gather: {name} is on {t.device}, not CUDA")
        if not t.is_contiguous():
            raise ValueError(f"row_gather: {name} is not contiguous")
    if idx.device != src.device:
        raise ValueError("row_gather: src and idx on different devices")
    if src.ndim != 2 or src.shape[0] < 1 or src.shape[1] < 1:
        raise ValueError(f"row_gather: src shape {tuple(src.shape)} is not "
                         "[n_src >= 1, W >= 1]")
    if idx.ndim != 1:
        raise ValueError(f"row_gather: idx shape {tuple(idx.shape)} is not "
                         "[n_idx]")


def row_gather_cuda(src: torch.Tensor, idx: torch.Tensor, *,
                    depth: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current CUDA stream: ``out[i] =
    src[idx[i]]`` for ``src`` int32 ``[n_src, W]`` and ``idx`` int32
    ``[n_idx]``, both contiguous CUDA tensors; returns a new int32 ``[n_idx,
    W]``. ``depth``: None for :func:`launch_plan`'s, or one of
    :data:`DEPTHS`. Every index must lie in ``[0, n_src)``: the kernel does
    not check them (neither does the Pallas kernel). Does not
    synchronise."""
    global LAUNCHES
    check_launch(src, idx, depth)
    out = torch.empty((idx.shape[0], src.shape[1]), dtype=src.dtype,
                      device=src.device)
    if idx.shape[0] == 0:
        return out
    plan = launch_plan(src.shape[1], vector_words(src, out), depth=depth)
    fn = _library().graphdyn_row_gather
    dev = src.device
    with torch.cuda.device(dev):
        rc = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(),
                src.shape[0], idx.shape[0], src.shape[1],
                PATHS[plan["path"]], plan["depth"], int(plan["streaming"]),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row_gather: kernel launch failed, cudaError {rc}")
    LAUNCHES += 1
    return out
