"""Hand-written CUDA kernels for the H100 (sm_90a).

``build.py`` compiles every ``<package>/csrc/*.cu`` with nvcc into
build/kernels/ and loads it with ctypes at first use.  Each kernel
package has:
  csrc/*.cu -- the CUDA C++ sources, one plain C entry point each
  ops.py    -- public wrappers (validation, device dispatch, launch
               counts, the C entry points' argtypes)
  ref.py    -- plain PyTorch versions (CPU path, tests, on-card parity)
"""
