"""Re-export shim: update compression lives in `repro_torch.comm.compress`
(`repro.optim.compress` counterpart).

The pytree error-feedback API (`EFState` / `ef_init` / `compress` /
`compressed_bytes`) is there, beside the per-worker vector compressors.
Nothing in the port imports this module; importing it warns with a
DeprecationWarning, as the reference's shim does.
"""
import warnings

from ..comm.compress import EFState, compress, compressed_bytes, ef_init

warnings.warn(
    "repro_torch.optim.compress is a deprecated re-export shim; import "
    "from repro_torch.comm.compress (or repro_torch.comm) instead",
    DeprecationWarning, stacklevel=2)

__all__ = ["EFState", "compress", "compressed_bytes", "ef_init"]
