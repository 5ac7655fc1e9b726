"""Random-row gather ``out[i] = src[idx[i]]`` over rows of 4-byte words: the
port of the row-gather probe's kernel P (``scripts/pallas_gather_probe.py:
63``, ``pallas_gather``).

Words are ``torch.int32`` carrying the JAX probe's ``uint32`` bit patterns
(the port's convention for packed words); indices are int32, as in the
probe. :func:`row_gather_plain` is the plain version, ``index_select``;
:func:`row_gather` dispatches as :func:`graphdyn_torch.ops.bdcm.class_mode`
does: ``'auto'`` takes the CUDA kernel (:mod:`graphdyn_torch.ops.
gather_cuda`, ``csrc/row_gather.cu``) for CUDA tensors and the plain version
for CPU tensors, ``'cuda'`` requires the kernel, ``'plain'`` runs the plain
version anywhere. On CUDA tensors a failed build or launch raises; there is
no fallback.
"""

from __future__ import annotations

import torch

KERNELS = ("auto", "cuda", "plain")


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src.index_select(0, idx)`` on any device."""
    return src.index_select(0, idx)


def row_gather(src: torch.Tensor, idx: torch.Tensor, *, kernel: str = "auto",
               depth: int | None = None) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` for ``src`` int32 ``[n_src, W]`` and ``idx``
    int32 ``[n_idx]``. Indices must lie in ``[0, n_src)`` (the kernel does
    not check them). ``depth``: rows in flight per thread of the kernel
    (``gather_cuda.DEPTHS``; None takes ``gather_cuda.launch_plan``'s for
    the row width)."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "plain" or (kernel == "auto" and src.device.type == "cpu"):
        return row_gather_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"kernel={kernel!r} launches the CUDA row-gather "
                         f"kernel; the tensors are on {src.device}")
    from graphdyn_torch.ops import gather_cuda

    return gather_cuda.row_gather_cuda(
        src, idx, depth=depth)
