"""The plain PyTorch versions the CUDA kernels are held against
(`repro.kernels.ref` counterparts: same visit order, same arithmetic)."""
from .flash_attention import flash_attention_plain as flash_attention_ref
from .local_sdca import local_sdca_plain as local_sdca_ref
from .sparse_sdca import sparse_local_sdca_plain as sparse_local_sdca_ref
from .sparse_sdca import sparse_local_sdca_zx_plain as sparse_local_sdca_zx_ref
from .ssm_scan import ssm_scan_plain as ssm_scan_ref
