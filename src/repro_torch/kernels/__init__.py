"""Hand-written CUDA kernels for Hopper (sm_90a).

Each kernel lives in its own package with its CUDA source under
``csrc/`` and an ``ops.py`` holding the Python wrapper, the plain
PyTorch version of the same function, and the kernel's launch count.
``build.py`` compiles a source with ``nvcc`` at first use and binds its
plain C entries with ``ctypes``.
"""
