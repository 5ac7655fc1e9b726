"""The CUDA fused-annealer kernel: its build, its launch wrapper and its
launch counter.

The kernel (``graphdyn_torch/csrc/fused_anneal.cu``) replaces the JAX
package's Pallas kernel K4 (``graphdyn/ops/pallas_anneal.py:433``,
``fused_chunk_pallas``): up to ``chunk_steps`` fused SA class steps in one
cooperative launch, the loop condition evaluated on the device, no host read
within the chunk. Each class step is one pass over the class rows (each
evaluates the LUT end states of its own ball in registers and writes its
flips in place) and one grid barrier; the last block to finish the pass does
the per-replica bookkeeping. It computes what :func:`graphdyn_torch.ops.
fused.fused_chunk_plain` computes, bit for bit. :func:`lane_plan` is its
thread mapping, chosen here and checked by :func:`index_map`.

It is built with ``--fmad=false`` (its one float decision, ``u <
exp(−ΔE)``, must see ``ΔE`` rounded op by op as the plain version rounds
it). There is no fallback: a failed build, a refused launch, or a grid that
cannot be co-resident raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from graphdyn_torch.ops import cuda_build
from graphdyn_torch.ops.fused import (
    FusedDeviceTables,
    FusedState,
    _check_seed,
)
from graphdyn_torch.ops.packed import WORD

SOURCE = "fused_anneal.cu"
NVCC_FLAGS = cuda_build.BASE_FLAGS + ("--fmad=false",)
MAX_DMAX = 63           # the kernel's template range of bit planes

# kernel launches made through fused_chunk_cuda since the last reset; a run
# shows that its path went through the kernel by zeroing this and reading it
LAUNCHES = 0
# the grid of the last launch (blocks of 256 threads), for reports
LAST_GRID_BLOCKS = 0

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
            fn = lib.graphdyn_fused_chunk
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p] * 18
                + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong]
                + [ctypes.c_int] * 5
                + [ctypes.c_uint, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.c_void_p]
            )
            grid = lib.graphdyn_fused_grid
            grid.restype = ctypes.c_int
            grid.argtypes = [ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int)]
            _lib = lib
        return _lib


def grid_info(dmax: int, Rp: int) -> dict:
    """The co-resident cooperative grid on the current device for this
    ``dmax`` and replica width: blocks per SM (occupancy at 256 threads),
    SMs, and their product (the most blocks one launch may have)."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    rc = _library().graphdyn_fused_grid(int(dmax), int(Rp),
                                        ctypes.byref(per_sm), ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError(f"fused_chunk: occupancy query failed, cudaError {rc}")
    return {"blocks_per_sm": per_sm.value, "sms": sms.value,
            "max_blocks": per_sm.value * sms.value}


def lane_plan(W: int) -> tuple[int, int]:
    """``(lanes, row_threads)`` of the kernel at W words per row: the
    threads that share one class word (each takes every ``lanes``-th of its
    16 replica pairs, and the ball rows likewise), and the threads one class
    row takes, its W words padded to a power of two below 32 or a multiple
    of 32 above, times ``lanes``. So a warp covers whole class rows or a run
    of one row's words, and a word's lanes are one aligned segment of a
    warp: 16 lanes at W = 1 and 2, fewer as W grows, 1 from W = 17."""
    if W < 1:
        raise ValueError(f"W must be >= 1, got {W}")
    padded = -(-W // WORD) * WORD if W >= WORD else 1 << (W - 1).bit_length()
    lanes = min(16, max(1, WORD // padded))
    return lanes, padded * lanes


def index_map(rows: int, W: int) -> np.ndarray:
    """The kernel's work items for ``rows`` class rows at W words, from
    :func:`lane_plan`, as int64 ``[items, 3]`` of (class row, word, replica
    pair within the word), one line per (thread, pair) the kernel runs:
    thread t takes class row ``t // row_threads``, word ``(t % row_threads)
    // lanes`` (none past W) and pairs ``lane, lane + lanes, ...`` of it."""
    lanes, rt = lane_plan(W)
    t = np.arange(rows * rt, dtype=np.int64)
    r = t % rt
    row, word, lane = t // rt, r // lanes, r % lanes
    keep = word < W
    row, word, lane = row[keep], word[keep], lane[keep]
    per = 16 // lanes
    pair = lane[:, None] + lanes * np.arange(per, dtype=np.int64)[None, :]
    return np.stack([np.repeat(row, per), np.repeat(word, per),
                     pair.reshape(-1)], axis=1)


_STATE_TYPES = {"sp_ext": torch.int32, "sum_end": torch.int32,
                "a": torch.float32, "b": torch.float32,
                "t_target": torch.int32, "active": torch.bool,
                "steps": torch.int32, "accepted": torch.int32}
_TABLE_TYPES = {"masks_ext": torch.int32, "facs": torch.float32,
                "nbr_ext": torch.int32, "nbr_self": torch.int32,
                "lut_masks": torch.int32, "a_caps": torch.float32,
                "b_caps": torch.float32, "class_ptr": torch.int32,
                "class_rows": torch.int32}


def check_launch(state: FusedState, tables: FusedDeviceTables, *, n: int,
                 dmax: int, chi: int) -> tuple[int, int]:
    """Check the types, devices, shapes and contiguity a launch needs;
    return ``(W, Rp)``."""
    dev = state.sp_ext.device
    named = ([(k, getattr(state, k), t) for k, t in _STATE_TYPES.items()]
             + [(k, getattr(tables, k), t) for k, t in _TABLE_TYPES.items()])
    for name, t, dtype in named:
        if t.device.type != "cuda":
            raise ValueError(f"fused_chunk: {name} is on {t.device}, not CUDA")
        if t.device != dev:
            raise ValueError("fused_chunk: tensors on different devices")
        if t.dtype != dtype:
            raise TypeError(f"fused_chunk: {name} is {t.dtype}, not {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_chunk: {name} is not contiguous")
    if state.sp_ext.ndim != 2:
        raise ValueError("fused_chunk: sp_ext must be 2-D [n+1, W]")
    W = state.sp_ext.shape[1]
    Rp = 32 * W
    if not 1 <= dmax <= MAX_DMAX:
        raise ValueError(f"fused_chunk: dmax={dmax} outside [1, {MAX_DMAX}]")
    if n < 1 or chi < 1 or W < 1:
        raise ValueError(f"fused_chunk: n={n}, chi={chi}, W={W} must be >= 1")
    want = {
        "sp_ext": (n + 1, W), "sum_end": (Rp,), "a": (Rp,), "b": (Rp,),
        "t_target": (Rp,), "active": (Rp,), "steps": (), "accepted": (),
        "masks_ext": (chi, n + 1), "facs": (chi, 2), "nbr_ext": (n + 1, dmax),
        "nbr_self": (n + 1, dmax + 1), "lut_masks": (dmax + 1, 2, n + 1),
        "a_caps": (Rp,), "b_caps": (Rp,), "class_ptr": (chi + 1,),
    }
    for name, shape in want.items():
        t = getattr(state, name, None)
        if t is None:
            t = getattr(tables, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_chunk: {name} shape {tuple(t.shape)} != "
                             f"{shape}")
    if tables.class_rows.ndim != 1 or tables.class_rows.shape[0] > n * chi:
        raise ValueError("fused_chunk: class_rows must be 1-D, at most n*chi")
    if not 0 <= tables.max_class <= n:
        raise ValueError(f"fused_chunk: max_class={tables.max_class} outside "
                         f"[0, {n}]")
    return W, Rp


def fused_chunk_cuda(state: FusedState, seed, tables: FusedDeviceTables, *,
                     n: int, dmax: int, chi: int, target_sum: int,
                     chunk_steps: int, stop_on_first: bool = False,
                     trace: torch.Tensor | None = None) -> FusedState:
    """Launch one chunk on the current CUDA stream; returns ``state``,
    whose tensors the kernel updated in place (the reference's donation
    contract: the state buffers are input and output). Allocates only the
    ``Rp + 3`` accumulator words per call (no end-state scratch: each class
    row evaluates its ball's end states in registers); raises if the grid
    cannot be co-resident. Does not synchronise. The tables' index ranges
    and the disjointness of the class balls were checked once when
    :func:`graphdyn_torch.ops.fused.fused_device_tables` built them.
    ``trace`` (int64 ``[K, 4]`` on the state's device) receives the global
    timer in ns for each of the first K class steps: at its start, at the
    end of the pass (when the last block finishes it), at the end of the
    bookkeeping, and after the grid barrier."""
    global LAUNCHES, LAST_GRID_BLOCKS
    W, Rp = check_launch(state, tables, n=n, dmax=dmax, chi=chi)
    seed = _check_seed(seed)
    if chunk_steps < 0 or not 0 <= target_sum < 2**31:
        raise ValueError(f"fused_chunk: chunk_steps={chunk_steps}, "
                         f"target_sum={target_sum} out of range")
    dev = state.sp_ext.device
    if trace is not None and (trace.dtype != torch.int64 or trace.ndim != 2
                              or trace.shape[1] != 4 or trace.device != dev
                              or not trace.is_contiguous()):
        raise ValueError("fused_chunk: trace must be a contiguous int64 "
                         "[K, 4] tensor on the state's device")
    work = torch.zeros(Rp + 3, dtype=torch.int32, device=dev)
    lanes, row_threads = lane_plan(W)
    inv_n = float(np.float32(1.0) / np.float32(n))
    blocks = ctypes.c_int(0)
    fn = _library().graphdyn_fused_chunk
    ptrs = [t.data_ptr() for t in (
        state.sp_ext, state.sum_end, state.a, state.b, state.t_target,
        state.active, state.steps, state.accepted,
        tables.masks_ext, tables.facs, tables.nbr_ext, tables.nbr_self,
        tables.lut_masks, tables.a_caps, tables.b_caps, tables.class_ptr,
        tables.class_rows, work)]
    with torch.cuda.device(dev):
        rc = fn(*ptrs, n, W, dmax, chi, int(tables.max_class), lanes,
                row_threads, int(target_sum), int(chunk_steps),
                int(bool(stop_on_first)), seed, inv_n,
                None if trace is None else trace.data_ptr(),
                0 if trace is None else trace.shape[0], ctypes.byref(blocks),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_chunk: kernel launch failed, cudaError {rc}")
    LAUNCHES += 1
    LAST_GRID_BLOCKS = blocks.value
    return state
