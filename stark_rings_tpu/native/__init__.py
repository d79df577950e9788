"""Native host runtime (C++ via ctypes).

Build-on-demand shared library with fast CPU Goldilocks kernels: the
high-speed oracle for large-degree device verification plus host-side digit
decomposition.  See csrc/stark_rings_host.cpp."""

from .host import HostGoldilocks, HostRing, get_host_lib

__all__ = ["HostGoldilocks", "HostRing", "get_host_lib"]
