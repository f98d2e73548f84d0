"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface and loaded with `ctypes` -- no PyTorch headers, so
a build takes seconds. Libraries go to `build/` at the root of the
checkout, named by a hash of the kernel's `.cu`, the headers it includes
and the flags, so an edit rebuilds what it touches and an unchanged tree
reuses what is there. Nothing is built when a module is imported: `load`
builds on first use, `build_all` builds every kernel at once (one `nvcc`
per source, all started together).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
from typing import Dict, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
KERNELS = ("local_sdca", "sparse_sdca_pipelined", "sparse_sdca_zx",
           "sparse_sdca_zx_block", "flash_attention", "ssm_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def counting() -> bool:
    """Whether a step counter runs (`launch.hlo_analysis.StepCounter`, the
    dry run): only there does a wrapper take "meta" tensors."""
    from ..obs import cost
    return bool(cost.COUNTERS)


def declared(stats: dict, *outputs):
    """A wrapper's answer on "meta" tensors inside a step counter, where
    nothing launches: its outputs' shapes, and its cost from `obs.cost`'s
    formulas added to the counter."""
    from ..obs import cost
    cost.declare(stats)
    return outputs[0] if len(outputs) == 1 else outputs


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    name: str
    path: pathlib.Path
    seconds: float          # nvcc wall time (0.0 when the library existed)
    log: str                # nvcc's output, with -Xptxas -v's usage lines


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> Tuple[pathlib.Path, ...]:
    """`csrc/<name>.cu` and every header it includes from csrc/, directly or
    through another header, in the order first reached."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        src = todo.pop(0)
        if src in seen:
            continue
        seen.append(src)
        todo += [CSRC / inc for inc in
                 _LOCAL_INCLUDE.findall(src.read_text())]
    return tuple(seen)


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for src in sources(name):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[pathlib.Path, pathlib.Path,
                               subprocess.Popen]:
    target = _target(name)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def build_all(names=KERNELS) -> Dict[str, BuildInfo]:
    """Build every kernel that is not built yet, all `nvcc`s in parallel.
    Raises RuntimeError with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    infos, running = {}, []
    for name in names:
        target = _target(name)
        if target.exists():
            infos[name] = BuildInfo(name, target, 0.0, "(cached)")
        else:
            running.append((name, time.perf_counter(), *_start(name)))
    failed = []
    for name, t0, target, tmp, proc in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)      # atomic: concurrent builds agree
        infos[name] = BuildInfo(name, target, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return infos


def is_loaded(name: str) -> bool:
    """Whether this process has loaded kernel `name`'s library."""
    return name in _LIBS


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        info = build_all((name,))[name]
        lib = ctypes.CDLL(str(info.path))
        _bind(name, lib)
        _LIBS[name] = lib
    return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "local_sdca":
        lib.local_sdca_launch.argtypes = [P] * 8 + [I] * 4 + [F, I, F, I,
                                                              I, P]
        lib.local_sdca_launch.restype = I
        lib.local_sdca_smem_bytes.argtypes = [I] * 3
        lib.local_sdca_smem_bytes.restype = ctypes.c_longlong
        lib.local_sdca_max_clusters.argtypes = [I] * 3 + [ctypes.POINTER(I)]
        lib.local_sdca_max_clusters.restype = I
    elif name == "sparse_sdca_pipelined":
        lib.sparse_sdca_pipelined_launch.argtypes = ([P] * 9 + [I] * 5
                                                     + [F, I, F, I, F, I, I,
                                                        I, I, P])
        lib.sparse_sdca_pipelined_launch.restype = I
    elif name == "sparse_sdca_zx":
        lib.sparse_sdca_zx_launch.argtypes = ([P] * 10 + [I] * 7
                                              + [F, I, F, I, F, I, P])
        lib.sparse_sdca_zx_launch.restype = I
        lib.sparse_sdca_zx_smem_bytes.argtypes = [I] * 5
        lib.sparse_sdca_zx_smem_bytes.restype = ctypes.c_longlong
        lib.sparse_sdca_zx_max_clusters.argtypes = [I] * 5 + [
            ctypes.POINTER(I)]
        lib.sparse_sdca_zx_max_clusters.restype = I
        lib.sparse_sdca_zx_grid_launch.argtypes = ([P] * 10 + [I] * 7
                                                   + [F, I, F, I, F, I, I,
                                                      P])
        lib.sparse_sdca_zx_grid_launch.restype = I
        lib.sparse_sdca_zx_grid_smem_bytes.argtypes = [I] * 5
        lib.sparse_sdca_zx_grid_smem_bytes.restype = ctypes.c_longlong
        lib.sparse_sdca_zx_grid_resident.argtypes = [I] * 5 + [
            ctypes.POINTER(I)]
        lib.sparse_sdca_zx_grid_resident.restype = I
    elif name == "sparse_sdca_zx_block":
        lib.sparse_sdca_zx_block_launch.argtypes = ([P] * 11 + [I] * 9
                                                    + [F, I, F, I, F, P])
        lib.sparse_sdca_zx_block_launch.restype = I
        lib.sparse_sdca_zx_block_round.argtypes = ([P] * 10 + [I] * 7
                                                   + [F, I, F, I, F, P])
        lib.sparse_sdca_zx_block_round.restype = I
    elif name == "flash_attention":
        lib.flash_attention_launch.argtypes = [P] * 4 + [I] * 6 + [F, P]
        lib.flash_attention_launch.restype = I
        lib.flash_attention_smem_bytes.argtypes = [I, I]
        lib.flash_attention_smem_bytes.restype = I
    elif name == "ssm_scan":
        lib.ssm_scan_launch.argtypes = [P] * 7 + [I] * 5 + [P]
        lib.ssm_scan_launch.restype = I
        lib.ssm_scan_smem_bytes.argtypes = [I] * 2
        lib.ssm_scan_smem_bytes.restype = ctypes.c_longlong
    else:
        raise KeyError(f"unknown kernel {name!r}; have {KERNELS}")
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [I]
    err_fn.restype = ctypes.c_char_p


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise when a DTensor reaches a kernel's wrapper: the kernel takes
    this rank's local tensors (`models.shards.local_kernel` hands them
    over), and a DTensor must not run the plain version either."""
    import torch
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name} takes local tensors, not DTensors: call it "
                        f"through models.shards.local_kernel")


def refuse_grad(name: str, flag: str, *tensors) -> None:
    """Raise when a forward-only kernel is asked for a graph: grad mode on
    and an input that requires grad. The reference's Pallas kernels have
    no VJP either (`jax.grad` through one fails); the caller trains on the
    plain path instead, never silently routed there."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward, like the reference's Pallas kernel: "
            f"train with {flag}=False, or call it under torch.no_grad()")
