"""The CUDA BDCM class-update kernel: its build, its launch plan and
admission gate, its launch wrapper and its launch counter.

The kernel (``graphdyn_torch/csrc/bdcm_contract.cu``) replaces the JAX
package's Pallas kernel K3 (``graphdyn/ops/pallas_bdcm.py:200``,
``dp_contract_grouped``): the ρ-lattice DP, the contraction against the
tilted factor, the ε-clamp, the normalisation and the damping of one
edge-degree class of G instances, with the group axis as the grid's second
dimension. It computes what :func:`graphdyn_torch.ops.bdcm.
dp_contract_grouped_plain` computes, in float32 or float64, up to the order
of the sums.

:func:`launch_plan` is the kernel's launch model and
:func:`bdcm_kernel_supported` its admission gate; they replace the JAX
package's VMEM model (``vmem_bytes``/``vmem_block_edges``/
``pallas_supported``/``pallas_group_supported``). Three paths:

- register: lattices of up to 32 entries (d ≤ 8, T ≤ 4), one thread per
  (edge, x_i);
- block: one block per edge with the two lattice rows in shared memory,
  for every larger lattice whose rows fit (float32 / float64: T = 4 up to
  d = 12 / 9, T = 5 up to d = 6 / 5, T = 6 up to d = 4 / 3);
- global: the same per-edge body with the two rows in a device workspace of
  ``slots × 2M`` elements, for every lattice beyond. At d = 18, T = 4,
  float32 that is M = 19⁴ = 130,321 entries, 1.04 MB per slot. The
  workspace (:func:`workspace`) is one ``torch.empty`` buffer per device and
  stream, shared by both kernels' wrappers and grown only when a launch
  needs more; the kernels allocate nothing.

The gate admits every class with 1 ≤ T ≤ 6 and d ≥ 1 in float32 and float64
(the JAX package runs every (d, T), its XLA path outside its Pallas
regime ``T ≤ 4, d ≤ 8``), except where the class's own factor ``[K, K, M]``
with one workspace slot cannot be allocated on the card
(:data:`DEVICE_BYTES`) or M passes the kernel's int32 lattice index: from
d = 93 / 78 at T = 4, d = 28 / 24 at T = 5 and d = 13 / 11 at T = 6 (at
T = 6, d = 13 the factor is 64·64·14⁶ ≈ 3.1·10¹⁰ entries). T ≥ 7
is refused: K·K = 16,384 outputs per edge, whose f64 values alone (128 KB)
crowd a block's shared memory, and the factor of a class with d = 4
incoming messages is 128·128·5⁷ ≈ 1.3·10⁹ entries, 5.1 GB in float32 — the
JAX package's XLA path builds the same factor, so T = 7 is not a shape its
users run either. On a CUDA device a class the gate refuses raises, under
``kernel='auto'`` as under ``kernel='cuda'``, and so does a failed build or
launch: there is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from graphdyn_torch.ops import cuda_build

SOURCE = "bdcm_contract.cu"
NVCC_FLAGS = cuda_build.BASE_FLAGS

MAX_T = 6                 # K = 2^T destination rows per edge, at most 64
REG_MAX_M, REG_MAX_D, REG_MAX_T = 32, 8, 4   # the register path's instantiations
THREADS = 256             # per block, at most
SMEM_MAX = 232448         # a block's shared memory on an H100, opted in
DEVICE_BYTES = 80 * 10**9  # an H100's device memory
INT32_MAX = 2**31 - 1     # the kernel indexes a lattice row in int32
PATHS = {"register": 0, "block": 1, "global": 2}
# the global path's workspace: at most this many slots per SM, and at most
# this many bytes in all (at least one slot)
WS_SLOTS_PER_SM = 2
WS_BUDGET = 8 * 2**30
# the workspace of each (device, stream): a uint8 tensor, grown on demand
_WS: dict = {}

# kernel launches made through dp_contract_cuda since the last reset; a run
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
            fn = lib.graphdyn_bdcm_contract
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p] * 4
                + [ctypes.c_longlong, ctypes.c_longlong]
                + [ctypes.c_int] * 4
                + [ctypes.c_double, ctypes.c_double]
                + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_void_p]
            )
            _lib = lib
        return _lib


W_STAGE = 256             # staged source weights per buffer (kWStage)


def edge_smem_elems(K: int, threads: int) -> int:
    """Shared elements the block and global paths index besides the lattice
    rows: the edge's K·K outputs, one K-row of partial sums per warp, two
    buffers of :data:`W_STAGE` staged source weights and the K offsets
    (``edge_smem_elems`` of ``csrc/bdcm_dp.cuh``)."""
    return K * K + threads // 32 * K + 2 * W_STAGE + K


def launch_plan(d: int, T: int, dtype) -> dict:
    """The kernel's plan for a class with d incoming messages at horizon T:
    ``path`` (``'register'``, ``'block'``, ``'global'`` or ``'refused'``),
    threads per block, dynamic shared bytes per block (the register path
    stages the factor; the block path two lattice rows and the edge's
    shared elements, :func:`edge_smem_elems`; the global path only the
    latter), ``workspace``, the global path's lattice bytes per resident
    block (2M elements; 0 on the other paths), and ``factor``, the class's
    ``[K, K, M]`` bytes."""
    esize = 8 if dtype == torch.float64 else 4
    if not (1 <= T <= MAX_T and d >= 1):
        return {"path": "refused", "threads": 0, "smem": 0, "workspace": 0,
                "factor": 0}
    K, M = 2**T, (d + 1) ** T
    factor = K * K * M * esize
    if T <= REG_MAX_T and M <= REG_MAX_M and d <= REG_MAX_D:
        return {"path": "register", "threads": THREADS,
                "smem": K * K * M * esize, "workspace": 0, "factor": factor}
    threads = min(THREADS, -(-M // 32) * 32)
    smem = (2 * M + edge_smem_elems(K, threads)) * esize
    if smem <= SMEM_MAX:
        return {"path": "block", "threads": threads, "smem": smem,
                "workspace": 0, "factor": factor}
    plan = {"path": "global", "threads": THREADS,
            "smem": edge_smem_elems(K, THREADS) * esize,
            "workspace": 2 * M * esize, "factor": factor}
    if M > INT32_MAX or factor + plan["workspace"] > DEVICE_BYTES:
        plan["path"] = "refused"
    return plan


def bdcm_kernel_supported(d: int, T: int, dtype) -> bool:
    """Whether the kernel takes an edge class with d incoming messages at
    horizon T in ``dtype`` (float32 or float64)."""
    return (dtype in (torch.float32, torch.float64)
            and launch_plan(d, T, dtype)["path"] != "refused")


def refusal_reason(d: int, T: int, dtype) -> str:
    if dtype not in (torch.float32, torch.float64):
        return f"dtype {dtype} is not float32 or float64"
    if not (1 <= T <= MAX_T and d >= 1):
        return (f"outside 1 <= T <= {MAX_T}, d >= 1: at T = 7 an edge has "
                f"K·K = 16384 outputs and a class of d = 4 a factor of "
                f"1.3e9 entries (module docstring)")
    plan = launch_plan(d, T, dtype)
    return (f"the class's factor [K, K, M] needs {plan['factor']} bytes and "
            f"one lattice workspace slot {plan['workspace']} bytes, which "
            f"cannot be allocated on the card ({DEVICE_BYTES} bytes), or "
            f"M = {(d + 1) ** T} passes the int32 lattice index")


def workspace_slots(slot_bytes: int, members: int, sms: int) -> int:
    """The global path's resident lattice slots for ``members`` edges of
    ``slot_bytes`` each on a card of ``sms`` SMs: min(members,
    :data:`WS_SLOTS_PER_SM` × sms, :data:`WS_BUDGET` // slot_bytes), at
    least 1; 0 when no class takes the global path."""
    if slot_bytes <= 0 or members <= 0:
        return 0
    return max(1, min(members, WS_SLOTS_PER_SM * sms,
                      WS_BUDGET // slot_bytes))


def workspace(device, slot_bytes: int, members: int):
    """The global-path lattice workspace for a launch on ``device``'s current
    stream: ``(uint8 tensor, slots)`` with :func:`workspace_slots` slots of
    ``slot_bytes``; ``(None, 0)`` when no class takes the global path. One
    buffer per (device, stream), reused by every launch there and replaced
    by a larger one only when a launch needs more, so launches on one
    stream, which run in order, share it and launches on two streams never
    do."""
    if slot_bytes <= 0 or members <= 0:
        return None, 0
    device = torch.device(device)
    slots = workspace_slots(
        slot_bytes, members,
        torch.cuda.get_device_properties(device).multi_processor_count)
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ws = _WS.get(key)
    if ws is None or ws.numel() < slots * slot_bytes:
        _WS.pop(key, None)
        ws = torch.empty(slots * slot_bytes, dtype=torch.uint8, device=device)
        _WS[key] = ws
    return ws, slots


def check_launch(chi_in: torch.Tensor, a_tilted: torch.Tensor,
                 chi_old: torch.Tensor, *, d: int, T: int) -> tuple[int, int]:
    """Check the types, devices, shapes and contiguity a launch needs;
    return ``(G, Ed)``."""
    dt = chi_in.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"dp_contract: chi_in is {dt}, not float32/float64")
    for name, t in (("chi_in", chi_in), ("a_tilted", a_tilted),
                    ("chi_old", chi_old)):
        if t.device.type != "cuda":
            raise ValueError(f"dp_contract: {name} is on {t.device}, not CUDA")
        if t.device != chi_in.device:
            raise ValueError("dp_contract: tensors on different devices")
        if t.dtype != dt:
            raise TypeError(f"dp_contract: {name} is {t.dtype}, chi_in {dt}")
        if not t.is_contiguous():
            raise ValueError(f"dp_contract: {name} is not contiguous")
    K, M = 2**T, (d + 1) ** T
    if chi_in.ndim != 5 or tuple(chi_in.shape[2:]) != (d, K, K):
        raise ValueError(f"dp_contract: chi_in shape {tuple(chi_in.shape)} is "
                         f"not [G, Ed, {d}, {K}, {K}]")
    G, Ed = chi_in.shape[0], chi_in.shape[1]
    if tuple(chi_old.shape) != (G, Ed, K, K):
        raise ValueError(f"dp_contract: chi_old shape {tuple(chi_old.shape)} "
                         f"!= {(G, Ed, K, K)}")
    if tuple(a_tilted.shape) not in ((K, K, M), (G, K, K, M)):
        raise ValueError(f"dp_contract: a_tilted shape {tuple(a_tilted.shape)}"
                         f" is neither {(K, K, M)} nor {(G, K, K, M)}")
    if not bdcm_kernel_supported(d, T, dt):
        raise ValueError(f"dp_contract: the kernel refuses d={d}, T={T}, {dt}: "
                         f"{refusal_reason(d, T, dt)}")
    if not 1 <= G <= 65535:
        raise ValueError(f"dp_contract: G={G} outside [1, 65535]")
    return G, Ed


def dp_contract_cuda(chi_in: torch.Tensor, a_tilted: torch.Tensor,
                     chi_old: torch.Tensor, *, d: int, T: int, damp: float,
                     eps_clamp: float = 0.0) -> torch.Tensor:
    """Launch the kernel on the current CUDA stream for ``chi_in``
    [G, Ed, d, K, K], ``a_tilted`` [K, K, M] (shared) or [G, K, K, M] (per
    group) and ``chi_old`` [G, Ed, K, K], all contiguous CUDA tensors of one
    float dtype; returns a new [G, Ed, K, K]. Does not synchronise."""
    global LAUNCHES
    G, Ed = check_launch(chi_in, a_tilted, chi_old, d=d, T=T)
    out = torch.empty_like(chi_old)
    if Ed == 0:
        return out
    fn = _library().graphdyn_bdcm_contract
    plan = launch_plan(d, T, chi_in.dtype)
    dev = chi_in.device
    with torch.cuda.device(dev):
        ws, slots = workspace(dev, plan["workspace"], G * Ed)
        rc = fn(chi_in.data_ptr(), a_tilted.data_ptr(), chi_old.data_ptr(),
                out.data_ptr(), G, Ed, int(d), int(T),
                int(chi_in.dtype == torch.float64), int(a_tilted.ndim == 4),
                float(damp), float(eps_clamp), PATHS[plan["path"]],
                plan["threads"], plan["smem"],
                None if ws is None else ws.data_ptr(), slots,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dp_contract: kernel launch failed, cudaError {rc}")
    LAUNCHES += 1
    return out
