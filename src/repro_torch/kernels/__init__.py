"""Hand-written Hopper kernels of the port and their plain versions.

Nothing here builds or imports a CUDA toolchain at import time: the
kernel library is built by ``_build.library()`` on the first CUDA launch.
"""
