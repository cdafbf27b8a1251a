"""Hand-written CUDA kernels for the H100 (sm_90a).

Each kernel package has:
  csrc/*.cu -- the CUDA C++ sources, one plain C entry point each
  build.py  -- nvcc into build/kernels/, loaded with ctypes at first use
  ops.py    -- public wrappers (validation, device dispatch, launch counts)
  ref.py    -- plain PyTorch versions (CPU path, tests, on-card parity)
"""
