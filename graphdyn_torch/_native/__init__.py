"""The port's native (C++) graph samplers, loaded through ctypes: its own
copy of the JAX package's ``graphgen.cpp`` (the port never imports
``graphdyn._native``)."""

from graphdyn_torch._native.build import (  # noqa: F401
    native_available,
    native_erdos_renyi,
    native_random_regular,
)
