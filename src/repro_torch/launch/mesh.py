"""Meshes of the port (`repro.launch.mesh` counterpart).

Two forms of one `Mesh`:

  * one card (`make_test_mesh`): a value naming the axes, their sizes
    and the card. The reference lays its (data=K, model=M) mesh over K M
    devices; on one card the port runs the same rounds as one grid of
    K M thread blocks (the z-exchange kernel) or K blocks (the 1-D
    kernels), on the tensors' leading axes.
  * processes (`make_process_mesh`): one rank per mesh position, each on
    its own device (on one card, every rank on `cuda:0`; in the tests,
    every rank on the CPU). The rank holds its coordinates, and the mesh
    builds the `torch.distributed` subgroups along any set of axes -- a
    data row (the ranks of one model shard), a model column (the shards
    of one worker), a hier pod -- which `comm.Topology.from_mesh` reads.
    Ranks are laid out row-major over the axes, so the ranks of a data
    row are in worker order.

The transport is gloo (`comm.collectives`): NCCL will not put two ranks
on one device. `initialize_distributed` joins the process group from
torchrun's environment or an explicit address, and `spawn_ranks` starts
P ranks on this host from Python, each joining through a file store.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device
    rank: Optional[int] = None          # this process's position (the
                                        # process form); None on one card
    _groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as the reference's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def is_process(self) -> bool:
        return self.rank is not None

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> index of `rank` (default: this process's)."""
        rank = self.rank if rank is None else rank
        out = {}
        for name, size in zip(reversed(self.axis_names),
                              reversed(self.sizes)):
            rank, out[name] = divmod(rank, size)
        return {a: out[a] for a in self.axis_names}

    def rank_at(self, coords: Dict[str, int]) -> int:
        r = 0
        for name, size in zip(self.axis_names, self.sizes):
            r = r * size + coords[name]
        return r

    def partition_group(self, key, parts: Sequence[Sequence[int]]):
        """This rank's subgroup of a partition of the ranks into `parts`,
        built once per `key`. Every rank builds every part, in one order,
        so every rank must ask for the same keys in the same order."""
        if key not in self._groups:
            import torch.distributed as dist
            mine, _ = dist.new_subgroups_by_enumeration(
                [sorted(p) for p in parts], backend="gloo")
            self._groups[key] = mine
        return self._groups[key]

    def subgroup(self, axes: Sequence[str]):
        """The ranks that differ from this one along `axes` only: the data
        row of `subgroup(data_axes)`, the model column of
        `subgroup((model_axis,))`."""
        axes = tuple(axes)
        rest = [a for a in self.axis_names if a not in axes]
        shape = self.shape
        parts = []
        for fixed in itertools.product(*(range(shape[a]) for a in rest)):
            base = dict(zip(rest, fixed))
            parts.append([self.rank_at({**base, **dict(zip(axes, moving))})
                          for moving in itertools.product(
                              *(range(shape[a]) for a in axes))])
        return self.partition_group(("axes", axes), parts)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's shape: 16 x 16 (data, model), or 2 x 16 x 16
    (pod, data, model). Shape only (no rank, on "meta"): the sharding
    rules read its axes and sizes (`launch.sharding`), as the
    reference's spec tests read their device-free stand-in."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, torch.device("meta"))


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device=DEFAULT_DEVICE) -> Mesh:
    """A (data, model) mesh on one card: `shape[i]` blocks along
    `axes[i]`."""
    shape, axes = _check_shape(shape, axes)
    return Mesh(axes, shape, resolve_device(device))


def make_process_mesh(shape=(2, 2), axes=("data", "model"),
                      device=DEFAULT_DEVICE) -> Mesh:
    """A mesh across the ranks of the initialized process group, one rank
    per position, this rank's tensors on `device`. The world size must
    equal the mesh's size. Builds the subgroup of every single axis here
    (a collective: every rank calls this with the same arguments)."""
    import torch.distributed as dist
    shape, axes = _check_shape(shape, axes)
    if not dist.is_initialized():
        raise ValueError("a process mesh needs torch.distributed "
                         "initialized first (initialize_distributed)")
    mesh = Mesh(axes, shape, resolve_device(device), rank=dist.get_rank())
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"the mesh {dict(zip(axes, shape))} has "
                         f"{mesh.size} positions but the process group "
                         f"has {dist.get_world_size()} ranks")
    for a in axes:
        mesh.subgroup((a,))
    return mesh


def device_mesh(mesh: Mesh, layout=None):
    """The `torch.distributed` DeviceMesh of a process mesh, on the mesh's
    device type (on one card every rank's is `cuda:0`): one dim a mesh
    axis, or a dim a group of adjacent axes in `layout` (named by the
    axes joined with "+"), laid out row-major as `Mesh.coords`. Built
    once per layout (a collective: every rank asks for the same layouts
    in one order). Over gloo, DTensor's collectives go through the port's
    calls (`comm.collectives.route_dtensor_collectives`, which rebinds
    torch's for the whole process)."""
    if not mesh.is_process:
        raise ValueError("a DeviceMesh needs a process mesh "
                         "(make_process_mesh), one rank a position")
    layout = (tuple(tuple(g) for g in layout) if layout is not None
              else tuple((a,) for a in mesh.axis_names))
    if sum(layout, ()) != mesh.axis_names:
        raise ValueError(f"layout {layout} must group the axes "
                         f"{mesh.axis_names} in order")
    key = ("device_mesh", layout)
    if key not in mesh._groups:
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from ..comm.collectives import route_dtensor_collectives
        if dist.get_backend() == "gloo":
            route_dtensor_collectives()
        shape = mesh.shape
        sizes = [math.prod(shape[a] for a in g) for g in layout]
        ranks = torch.arange(mesh.size).reshape(sizes)
        mesh._groups[key] = DeviceMesh(
            mesh.device.type, ranks,
            mesh_dim_names=tuple("+".join(g) for g in layout))
    return mesh._groups[key]


def _check_shape(shape, axes):
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up "
                         f"with distinct names")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    return shape, axes


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=DEFAULT_DEVICE) -> Tuple[int, int]:
    """Join the gloo process group; returns (rank, world).

    `coordinator` is "host:port" (a TCP store on that address), or a URL
    `torch.distributed` takes ("tcp://...", "file:///path"). Without one,
    torchrun's environment is read: MASTER_ADDR / MASTER_PORT, WORLD_SIZE,
    RANK (`python -m torch.distributed.run` sets them). With neither, or
    a world of 1, nothing is initialized and (0, 1) is returned, as the
    reference's single-process fallback. `num_processes` and `process_id`
    override WORLD_SIZE and RANK. `device` is checked (a CUDA device must
    exist) and made the current CUDA device: on one card every rank's is
    `cuda:0`."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", "1"))
    rank = int(process_id if process_id is not None
               else env.get("RANK", "0"))
    if coordinator is None and "MASTER_ADDR" not in env:
        if world != 1:
            raise ValueError(f"a world of {world} needs a coordinator "
                             f"address (or MASTER_ADDR / MASTER_PORT)")
        return 0, 1
    if world == 1:
        return 0, 1
    if coordinator is None:
        init = "env://"
    elif "://" in coordinator:
        init = coordinator
    else:
        init = f"tcp://{coordinator}"
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    return dist.get_rank(), dist.get_world_size()


def _rank_main(target, rank, world, init, results, args):
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank)
        out = target(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:                 # reported to the parent, which
        results.put((rank, False, traceback.format_exc()))   # fails the run
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(target: Callable, world: int, args: tuple = (), *,
                timeout: float) -> list:
    """Run `target(rank, world, *args)` in `world` spawned processes
    joined in one gloo process group (through a file store in a temporary
    directory), and return the ranks' results in rank order. `target` is a module-level function; its results are
    pickled back, so keep them to numpy arrays and Python values.

    Raises RuntimeError with the traceback of the first rank that failed,
    and TimeoutError when a rank has not finished within `timeout`
    seconds; either way every rank still running is killed first."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(target, r, world, init, results,
                                   tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, failure = {}, None
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(got))} of "
                        f"{world} not finished within {timeout} s")
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if not dead:
                        continue
                    try:
                        # a rank that exited just after the wait above
                        # may have left its result in the pipe
                        rank, ok, out = results.get(timeout=5.0)
                    except queue.Empty:
                        failure = RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                        continue
                if ok:
                    got[rank] = out
                else:
                    failure = RuntimeError(f"rank {rank} of {world} "
                                           f"failed:\n{out}")
        finally:
            for p in procs:
                if p.is_alive() and (failure is not None or len(got) < world):
                    p.kill()
            for p in procs:
                p.join(timeout=30)
        if failure is not None:
            raise failure
    return [got[r] for r in range(world)]
