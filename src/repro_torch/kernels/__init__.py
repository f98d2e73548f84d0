"""Hand-written CUDA kernels of the port.

local_sdca.py       LocalSDCA over dense rows (csrc/local_sdca.cu)
sparse_sdca.py      LocalSDCA over padded-ELL rows with the fused prox and a
                    prefetch ring (csrc/sparse_sdca_pipelined.cu), and the
                    feature-sharded z-exchange schedule
                    (csrc/sparse_sdca_zx.cu)
autotune.py         the sparse kernels' launch configuration
flash_attention.py  causal GQA flash attention (csrc/flash_attention.cu)
ssm_scan.py         the mamba-1 selective scan (csrc/ssm_scan.cu)
ops.py              the SDCA kernels as CoCoA+ local solvers (`sdca_kernel`,
                    `sdca_sparse_kernel`)
ref.py              the plain PyTorch versions they are held against
build.py            nvcc at first use into build/, loaded with ctypes

Nothing is compiled at import time.
"""
