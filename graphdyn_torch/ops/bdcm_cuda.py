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
``pallas_supported``/``pallas_group_supported``). Lattices of up to 32
entries (d ≤ 8) run on the register path; every larger one runs on the
block path, one block per edge with two lattice rows in shared memory. The
gate admits every class with T ≤ 4 whose block-path rows fit one block's
shared memory: the whole reference regime T ≤ 4, d ≤ 8 in both dtypes, and
higher degrees up to d = 119 (T=2, f64). On a CUDA device a class it
refuses raises, under ``kernel='auto'`` as under ``kernel='cuda'``, and so
does a failed build or launch: there is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from graphdyn_torch.ops import cuda_build

SOURCE = "bdcm_contract.cu"
NVCC_FLAGS = cuda_build.BASE_FLAGS

MAX_T = 4                 # K = 2^T destination rows per edge, at most 16
REG_MAX_M, REG_MAX_D = 32, 8   # the register path's instantiations
THREADS = 256             # per block, at most
SMEM_MAX = 232448         # a block's shared memory on an H100, opted in
PATHS = {"register": 0, "block": 1}

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
                + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            )
            _lib = lib
        return _lib


def launch_plan(d: int, T: int, dtype) -> dict:
    """The kernel's plan for a class with d incoming messages at horizon T:
    ``path`` (``'register'``, ``'block'`` or ``'refused'``), threads per
    block and dynamic shared bytes per block (the register path stages the
    factor, the block path two lattice rows, the edge's K·K outputs and one
    K-row of partial sums per warp)."""
    esize = 8 if dtype == torch.float64 else 4
    if not (1 <= T <= MAX_T and d >= 1):
        return {"path": "refused", "threads": 0, "smem": 0}
    K, M = 2**T, (d + 1) ** T
    if M <= REG_MAX_M and d <= REG_MAX_D:
        return {"path": "register", "threads": THREADS, "smem": K * K * M * esize}
    threads = min(THREADS, -(-M // 32) * 32)
    smem = (2 * M + K * K + threads // 32 * K) * esize
    if smem > SMEM_MAX:
        return {"path": "refused", "threads": 0, "smem": smem}
    return {"path": "block", "threads": threads, "smem": smem}


def bdcm_kernel_supported(d: int, T: int, dtype) -> bool:
    """Whether the kernel takes an edge class with d incoming messages at
    horizon T in ``dtype`` (float32 or float64)."""
    return (dtype in (torch.float32, torch.float64)
            and launch_plan(d, T, dtype)["path"] != "refused")


def refusal_reason(d: int, T: int, dtype) -> str:
    if dtype not in (torch.float32, torch.float64):
        return f"dtype {dtype} is not float32 or float64"
    if not (1 <= T <= MAX_T and d >= 1):
        return f"outside T <= {MAX_T}, d >= 1"
    smem = launch_plan(d, T, dtype)["smem"]
    return (f"the block path's lattice rows need {smem} bytes of shared "
            f"memory, more than {SMEM_MAX}")


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
        rc = fn(chi_in.data_ptr(), a_tilted.data_ptr(), chi_old.data_ptr(),
                out.data_ptr(), G, Ed, int(d), int(T),
                int(chi_in.dtype == torch.float64), int(a_tilted.ndim == 4),
                float(damp), float(eps_clamp), PATHS[plan["path"]],
                plan["threads"], plan["smem"],
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dp_contract: kernel launch failed, cudaError {rc}")
    LAUNCHES += 1
    return out
