"""Native (C++) host-side kernels with build-on-first-use ctypes bindings.

The compute path of the framework is JAX/XLA on device; host-side
preprocessing hot spots (mesh topology extraction) get native C++
implementations here, compiled once into a cached shared library. Every
native entry point has a NumPy fallback so the package works without a
toolchain.
"""

from .build import get_lib, native_available
from .topology import first_encounter_unique_native

__all__ = ["get_lib", "native_available", "first_encounter_unique_native"]
