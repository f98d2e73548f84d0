"""PyTorch/CUDA port of the CoCoA+ reproduction (Ma et al., ICML 2015).

Same layout and names as the JAX package `repro`, so each module has a
counterpart there:

    core/     losses, regularizers, duality certificates, the LocalSolver
              registry and the Algorithm-1 driver (`core.cocoa.solve`)
    comm/     the (gamma, sigma') aggregation, the flat reduce and the
              identity compressor
    data/     the numpy generators (equal arrays to the reference) and the
              padded-ELL `SparseShards`
    kernels/  hand-written CUDA kernels for LocalSDCA, dense and sparse,
              with their plain PyTorch versions
    launch/   the `cocoa_train` CLI

Everything that makes tensors takes an explicit `device` and defaults to
`cuda`; asking for `cuda` without a card raises (nothing falls back to the
CPU). Pass `device="cpu"` to run the plain PyTorch versions on the host.
"""
from .device import resolve_device
