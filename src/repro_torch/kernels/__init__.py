"""Hand-written CUDA kernels for the port's hot loop.

local_sdca.py   LocalSDCA over dense rows (csrc/local_sdca.cu)
sparse_sdca.py  LocalSDCA over padded-ELL rows with the fused prox
                (csrc/sparse_sdca.cu)
ops.py          both as CoCoA+ local solvers (`sdca_kernel`,
                `sdca_sparse_kernel`)
ref.py          the plain PyTorch versions they are held against
build.py        nvcc at first use into build/, loaded with ctypes

Nothing is compiled at import time.
"""
