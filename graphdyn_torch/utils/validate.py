"""Numerical sanitizers, the port's counterparts of
``graphdyn/utils/validate.py``.

The JAX package compiles float checks into a jitted program
(``checkify.float_checks``) and has ``jax_debug_nans`` raise at the op that
made a NaN. The port's programs are eager PyTorch and hand-written kernels,
so the checks read what a function returns:

- :func:`checked` wraps ``fn`` to raise ``FloatingPointError`` at a NaN or
  an Inf in any floating-point tensor (or array) it returns, nested in
  tuples, lists, dicts and NamedTuples. The JAX package raises
  ``JaxRuntimeError``, which the port cannot import.
- :func:`debug_nans` is the scope that turns that check on: a
  :func:`checked` function checks its outputs inside the scope only, and
  outside it returns them untouched, with no host read.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

_local = threading.local()


def debugging() -> bool:
    """True inside a :func:`debug_nans` scope on this thread."""
    return getattr(_local, "depth", 0) > 0


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """``with debug_nans():`` turns on the NaN/Inf check of every
    :func:`checked` function called in the scope (restored on exit, also
    on an exception)."""
    prev = getattr(_local, "depth", 0)
    _local.depth = prev + 1 if enable else 0
    try:
        yield
    finally:
        _local.depth = prev


def _bad_leaves(x, path: str = "out"):
    """``(path, kind)`` of each returned floating-point leaf holding a NaN
    or an Inf (one host read per float tensor)."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point() or x.is_complex():
            if bool(torch.isnan(x).any()):
                yield path, "NaN"
            elif bool(torch.isinf(x).any()):
                yield path, "Inf"
        return
    if isinstance(x, np.ndarray) or isinstance(x, np.floating):
        a = np.asarray(x)
        if np.issubdtype(a.dtype, np.inexact):
            if np.isnan(a).any():
                yield path, "NaN"
            elif np.isinf(a).any():
                yield path, "Inf"
        return
    if isinstance(x, float):
        if x != x:
            yield path, "NaN"
        elif x in (float("inf"), float("-inf")):
            yield path, "Inf"
        return
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _bad_leaves(v, f"{path}[{k!r}]")
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for k, v in zip(x._fields, x):
            yield from _bad_leaves(v, f"{path}.{k}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _bad_leaves(v, f"{path}[{i}]")


def check_finite(out, name: str = "out"):
    """Raise ``FloatingPointError`` naming the first NaN/Inf leaf of
    ``out``; return ``out``."""
    for path, kind in _bad_leaves(out, name):
        raise FloatingPointError(
            f"non-finite value ({kind.lower()}) in {path}")
    return out


def checked(fn):
    """``fn`` with its outputs checked for NaN and Inf inside
    :func:`debug_nans`: a callable of the same signature that, in the
    scope, raises ``FloatingPointError`` when a floating-point output holds
    one (one host read per float tensor), and outside it returns ``fn``'s
    outputs as they are."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not debugging():
            return out
        return check_finite(out, getattr(fn, "__name__", "out"))

    return wrapper
