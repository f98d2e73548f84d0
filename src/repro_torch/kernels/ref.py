"""The plain PyTorch versions the CUDA kernels are held against
(`repro.kernels.ref` counterparts: same visit order, same arithmetic)."""
from .local_sdca import local_sdca_plain as local_sdca_ref
from .sparse_sdca import sparse_local_sdca_plain as sparse_local_sdca_ref
