"""Build and load the C++ graph samplers (``graphgen.cpp``), the port's
copy of ``graphdyn/_native/build.py``.

The library is compiled with g++ at its first use, never at import, into
the git-ignored ``build/graphdyn_torch/`` at the repo root, named by a hash
of the source, and installed through a temporary name and ``os.replace``
(concurrent first uses cannot tear it). A missing toolchain or a failed
build raises ``RuntimeError`` from the sampler that needed it:
``method='native'`` never falls back to another sampler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "graphgen.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "graphdyn_torch")

_lib = None
_load_error: str | None = None
_lock = threading.Lock()


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libgraphgen-{key}.so")


def _ensure_built() -> None:
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return
        so = _library_path()
        try:
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
                     "-o", tmp],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.rrg_edges.restype = ctypes.c_int
            lib.rrg_edges.argtypes = [
                ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ]
            lib.er_edges.restype = ctypes.c_int64
            lib.er_edges.argtypes = [
                ctypes.c_int64, ctypes.c_double, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
            ]
            _lib = lib
        except (subprocess.CalledProcessError, OSError) as e:
            _load_error = str(e)
            stderr = getattr(e, "stderr", None)
            if stderr:
                _load_error += "\n" + stderr.decode(errors="replace")


def native_available() -> bool:
    _ensure_built()
    return _lib is not None


def _as_seed(seed) -> int:
    if seed is None:
        return int.from_bytes(os.urandom(8), "little")
    if isinstance(seed, np.random.Generator):
        return int(seed.integers(0, 2**63))
    return int(seed) & (2**64 - 1)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def native_random_regular(n: int, d: int, seed) -> np.ndarray:
    """A simple d-regular edge list, shape [n*d/2, 2]."""
    _ensure_built()
    if _lib is None:
        raise RuntimeError(f"native sampler unavailable: {_load_error}")
    E = n * d // 2
    u = np.empty(E, np.int32)
    v = np.empty(E, np.int32)
    rc = _lib.rrg_edges(n, d, _as_seed(seed), _ptr(u), _ptr(v))
    if rc != 0:
        raise RuntimeError(f"rrg_edges failed (rc={rc})")
    return np.stack([u, v], axis=1).astype(np.int64)


def native_erdos_renyi(n: int, p: float, seed) -> np.ndarray:
    """A G(n, p) edge list, shape [m, 2]."""
    _ensure_built()
    if _lib is None:
        raise RuntimeError(f"native sampler unavailable: {_load_error}")
    mean = n * (n - 1) / 2 * p
    cap = int(mean + 8 * np.sqrt(mean + 1) + 64)
    while True:
        u = np.empty(cap, np.int32)
        v = np.empty(cap, np.int32)
        m = _lib.er_edges(n, float(p), _as_seed(seed), _ptr(u), _ptr(v), cap)
        if m >= 0:
            return np.stack([u[:m], v[:m]], axis=1).astype(np.int64)
        cap *= 2
