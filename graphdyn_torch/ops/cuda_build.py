"""Build and load the port's CUDA kernels: ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes.

A library is built at its first CUDA use, never at import, so importing the
package needs no ``nvcc``. It lands in ``build/graphdyn_torch/`` at the repo
root, named by the source's stem and a hash of the source and the flags, and
is installed through a temporary name and ``os.replace``; the hash covers
the shared headers (``csrc/*.cuh``) too. The compiler's
``-Xptxas -v`` report (registers and spills per kernel) is kept beside it as
``<library>.log``. A missing ``nvcc`` or a failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "graphdyn_torch")
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc`` when ``CUDA_HOME`` is
    set, else the one on PATH, else ``/usr/local/cuda/bin/nvcc``; "" when
    none exists."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        path = os.path.join(cuda_home, "bin", "nvcc")
        return path if os.path.exists(path) else ""
    return shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc") else ""
    )


def build(source: str, flags: tuple[str, ...]) -> str:
    """Compile ``csrc/<source>`` with ``flags`` unless this source and these
    flags are built already; return the library's path."""
    src = os.path.join(CSRC, source)
    compiler = nvcc()
    if not compiler:
        raise RuntimeError(
            f"graphdyn_torch: nvcc not found (PATH, or CUDA_HOME/bin); the "
            f"CUDA kernel {source} cannot be built"
        )
    text = b""
    # the source and every shared header it may include
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            text += f.read()
    key = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}-{key}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler, *flags, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"graphdyn_torch: nvcc failed (exit {proc.returncode}) building "
            f"{src}:\n{proc.stdout}{proc.stderr}"
        )
    with open(f"{tmp}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(f"{tmp}.log", f"{lib_path}.log")
    os.replace(tmp, lib_path)
    return lib_path


def load(source: str, flags: tuple[str, ...]) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>``; loaded
    once per process."""
    with _lock:
        path = build(source, flags)
        if path not in _loaded:
            _loaded[path] = ctypes.CDLL(path)
        return _loaded[path]


def ptxas_summary(lib_path: str) -> dict:
    """The register and spill figures of every kernel instantiation, from
    the compiler report that :func:`build` kept beside ``lib_path``."""
    with open(f"{lib_path}.log") as f:
        report = f.read()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)]
    if not regs:
        raise RuntimeError(f"no ptxas register report in {lib_path}.log")
    return {"kernels": len(regs), "registers_min": min(regs),
            "registers_max": max(regs), "spill_bytes_max": max(spills or [0])}
