"""Multi-pod dry run (`repro.launch.dryrun` counterpart): every
(architecture x input-shape) cell of `launch.specs.all_cells()`, and the
paper's CoCoA+ round, run once as rank 0 of the production meshes, with
one JSON record a cell of what one device computes, moves and holds.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh-shape 2x2 \\
        --steps '[{"name": "p", "arch": "stablelm-1.6b", "kind": "prefill",
                   "B": 4, "S": 1024, "flash": true}]'

The meshes are fake worlds (`launch.mesh.make_production_mesh(fake=
True)`): a `torch.distributed` default group of 256 (16 x 16, data x
model) or 512 (2 x 16 x 16, pod x data x model) ranks on the "fake"
backend, this process rank 0, every tensor on "meta". The step is the
one a real run calls (`launch.train.make_jitted_train_step`,
`launch.serve.make_jitted_serve_fns`), with the hooks the reference's
dry run installs (the act and logits constraints and the FSDP gather,
`launch.sharding.installed`; the expert-parallel MoE context,
`models.layers.set_moe_ctx`, when the config has experts and the mode
data axes) and the same routed collectives, so a dry run of a step and a
real run of it make the same collectives (`comm.collectives`' tally).
The step runs once under `launch.hlo_analysis.count_step`, which counts
rank 0's local ops. `REPRO_DRYRUN_DEVICES` set (to anything) shrinks the
meshes to 2 x 2 and 2 x 2 x 2, as the reference's test hook.

The hand-written kernels cannot launch on "meta": each wrapper there
returns its outputs' shapes and declares its cost from `obs.cost`'s
formulas (`kernels.build.declared`: flash attention's causal products,
the scan's steps, the dense SDCA walk's rows), which the counter adds in
the kernel's place. No plain version runs there: the paper cell's walk
alone is 32,768 dependent steps, each a handful of ops to count.

`--steps` runs named steps of full-width configs (cut in depth, at any
batch and length) on a small fake world, each record with its tally:
`chip_smoke.py` holds those tallies to the same steps' on a real mesh.

A record has the reference's keys. `lower_s` is the placing of the
inputs on the mesh (the in_shardings) and `compile_s` the counted call:
there is no lowering or compile. `memory_analysis` holds the rank's
argument and output bytes from its local shards and the bytes of the
outputs that are inputs updated in place (`alias_size_in_bytes`); there
is no temp size (no compiled buffer plan). `xla_cost_flops` and
`xla_cost_bytes` have no analogue and read -1, as the reference writes a
missing field. A decode cell writes position S - 1 (the reference's is
an abstract scalar). No analogue either: HLO text, GSPMD's propagation.

Output: one JSON a cell under `build/dryrun_torch/` (ignored by git),
never `benchmarks/results/dryrun/`.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import time
import traceback

import torch

from . import mesh as meshlib
from . import sharding as Sh
from . import specs as Sp
from .hlo_analysis import count_step

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun_torch"

_MESHES: dict = {}


def _mesh(name: str):
    """The fake world of `name` ("single" or "multi"), built once; a world
    of another size in this process is torn down first."""
    import torch.distributed as dist
    if name in _MESHES:
        return _MESHES[name]
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ValueError(f"the dry run needs a process of its own; this "
                             f"one has a {dist.get_backend()} group")
        dist.destroy_process_group()
        _MESHES.clear()
    if os.environ.get("REPRO_DRYRUN_DEVICES"):
        mesh = (meshlib.make_fake_mesh((2, 2), ("data", "model"))
                if name == "single" else
                meshlib.make_fake_mesh((2, 2, 2), ("pod", "data", "model")))
    else:
        mesh = meshlib.make_production_mesh(multi_pod=(name == "multi"),
                                            fake=True)
    _MESHES[name] = mesh
    return mesh


def _bytes(tree) -> int:
    """Bytes of the tensors of a tree, each a DTensor's local shard."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    return 0


def global_param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def moe_ctx_for(cfg, mesh, mode: str, gather: bool) -> dict:
    """The `set_moe_ctx` arguments of a step: expert parallelism when the
    config has experts and the mode data axes, else the portable
    default."""
    ax = Sh.axes_for(mesh, mode)
    if cfg.n_experts and ax.dp:
        return dict(mesh=mesh, dp=ax.dp, tp="model", fsdp=ax.fsdp,
                    gather_weights=gather)
    return {}


def step_inputs(cfg, kind: str, B: int, S: int, S_cache=None):
    """The "meta" stand-ins of a step's inputs at batch B and length S,
    as `specs.cell_inputs` makes a cell's: (model, opt, batch) to train,
    (model, batch, cache) to prefill, (model, cache, tokens, None) to
    decode (the position is set by `prepare_step`); the cache holds
    `S_cache` positions (default S)."""
    params = Sp.abstract_params(cfg)
    cache_len = S if S_cache is None else int(S_cache)
    if kind == "train":
        return (params, Sp.abstract_opt(params),
                Sp.train_batch_specs(cfg, B, S))
    if kind == "prefill":
        return (params, Sp.prefill_batch_specs(cfg, B, S),
                Sp.abstract_cache(cfg, B, cache_len))
    return (params, Sp.abstract_cache(cfg, B, cache_len),
            torch.empty((B, 1), dtype=torch.int32, device="meta"), None)


def prepare_step(kind: str, cfg, mesh, mode: str, args):
    """(step, step_args, in-place outputs): the step of a cell as a real
    run calls it, its inputs placed on the mesh (the model, the AdamW
    state, the batch, the cache: the in_shardings; the placement inside
    the step is then a no-op)."""
    from ..models import model as M
    from . import serve as SV
    from . import train as T
    layout = Sh.layout_for(mesh, mode)
    model = args[0]
    Sh.place_model(model, Sh.param_specs(model, cfg, mesh, mode), mesh,
                   layout=layout)
    if kind == "train":
        _, opt, batch = args
        opt = Sh.place_opt(opt, Sh.opt_specs(Sh.param_specs(
            model, cfg, mesh, mode)), mesh, layout)
        batch = Sh.place_tree(batch, Sh.batch_specs(batch, cfg, mesh, mode),
                              mesh, layout)
        return (T.make_jitted_train_step(cfg, mesh), (model, opt, batch),
                (model, opt))
    pre, dec = SV.make_jitted_serve_fns(cfg, mesh, mode)
    if kind == "prefill":
        _, batch, cache = args
        step = pre(cache, batch)
        batch = Sh.place_tree(batch, Sh.batch_specs(batch, cfg, mesh, mode),
                              mesh, layout)
        cache = Sh.place_tree(cache, Sh.cache_specs(cache, cfg, mesh, mode),
                              mesh, layout)
        return step, (model, batch, cache), (cache,)
    _, cache, tokens, _pos = args
    step = dec(cache)
    cache = Sh.place_tree(cache, Sh.cache_specs(cache, cfg, mesh, mode),
                          mesh, layout)
    tokens = Sh.place_tree({"tokens": tokens}, Sh.batch_specs(
        {"tokens": tokens}, cfg, mesh, mode), mesh, layout)["tokens"]
    S = (cache["self"]["k"].shape[2] if isinstance(cache, dict)
         else _cache_len(cache))
    pos = (min(S, M.MAX_WHISPER_DEC) - 1 if cfg.is_encdec() else S - 1)
    return step, (model, cache, tokens, pos), (cache,)


def _cache_len(cache) -> int:
    """The sequence length of a decoder cache: its longest k/v leaf's."""
    lens = [layer["k"].shape[1] for layer in cache if "k" in layer]
    return max(lens) if lens else 1


def lower_step(cfg, kind: str, mode: str, args, mesh) -> dict:
    """Run one step (`prepare_step`) on the mesh under the counter, with
    the MoE context the mode takes (`moe_ctx_for`): the record's numbers,
    and the step's tally ({"kind/group/routed": [count, result bytes,
    bytes handed over]})."""
    from ..models import layers as Ly
    gather = kind in ("train", "prefill")
    gbytes = global_param_bytes(args[0])
    Ly.set_moe_ctx(**moe_ctx_for(cfg, mesh, mode, gather))
    try:
        t0 = time.time()
        step, step_args, in_place = prepare_step(kind, cfg, mesh, mode,
                                                 args)
        arg_bytes = _bytes(step_args)
        t1 = time.time()
        out, st, records = count_step(step, *step_args)
        t2 = time.time()
    finally:
        Ly.set_moe_ctx()
    return {
        "mesh_shape": dict(mesh.shape), "kind": kind,
        "lower_s": round(t1 - t0, 2), "compile_s": round(t2 - t1, 2),
        "flops_per_device": st["dot_flops"],
        "hbm_bytes_per_device": st["hbm_bytes"],
        "collectives": st["collectives"],
        "collective_wire_bytes_per_device": st["collective_wire_bytes"],
        "xla_cost_flops": -1.0,
        "xla_cost_bytes": -1.0,
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": _bytes(out),
            "alias_size_in_bytes": _bytes(in_place)},
        "global_param_bytes": gbytes,
        "n_devices": mesh.size,
        "tally": {f"{k}/{g}/{int(r)}": list(v)
                  for (k, g, r), v in sorted(records.items())},
    }


def lower_cell(cell: Sp.Cell, mesh, mesh_name: str) -> dict:
    kind, args = Sp.cell_inputs(cell)
    mode = ("train" if kind == "train"
            else ("serve_long" if cell.kind == "decode_long" else "serve"))
    rec = {"arch": cell.arch, "shape": cell.shape, "mesh": mesh_name}
    rec.update(lower_step(cell.cfg, kind, mode, args, mesh))
    return rec


def run_steps(steps: list, shape, outdir: pathlib.Path) -> int:
    """`--steps`: each step {"name", "arch", "kind", "B", "S"} (optional
    "S_cache": the cache's length, default S; "n_layers"; "flash":
    use_flash_attention; "mode": serve_long for a decode over
    sequence-sharded caches) of a full-width config in serve or train mode on
    a fake world of `shape` ((data, model) or (pod, data, model)); one
    record a step, `step__<name>.json`, with its tally. Returns the
    failures."""
    import dataclasses
    from ..configs import get_config
    axes = (("data", "model") if len(shape) == 2
            else ("pod", "data", "model"))
    mesh = meshlib.make_fake_mesh(shape, axes)
    outdir.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    for st in steps:
        cfg = get_config(st["arch"])
        over = {"use_flash_attention": bool(st.get("flash", False))}
        if st.get("n_layers"):
            over["n_layers"] = int(st["n_layers"])
        cfg = dataclasses.replace(cfg, **over)
        kind, B, S = st["kind"], int(st["B"]), int(st["S"])
        args = step_inputs(cfg, kind, B, S, st.get("S_cache"))
        mode = st.get("mode", "train" if kind == "train" else "serve")
        try:
            rec = {"name": st["name"], "arch": st["arch"], "B": B, "S": S}
            rec.update(lower_step(cfg, kind, mode, args, mesh))
            print(f"[ok]   {st['name']}: flops/dev="
                  f"{rec['flops_per_device']:.3e} collective bytes "
                  f"handed={sum(v[2] for v in rec['tally'].values())}",
                  flush=True)
        except Exception as e:
            n_fail += 1
            rec = {"name": st["name"], "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"[FAIL] {st['name']}: {e}", flush=True)
        (outdir / f"step__{st['name']}.json").write_text(
            json.dumps(rec, indent=1))
    return n_fail


def run_cell(cell: Sp.Cell, mesh_name: str, outdir: pathlib.Path) -> dict:
    outdir.mkdir(parents=True, exist_ok=True)
    out = outdir / f"{cell.arch}__{cell.shape}__{mesh_name}.json"
    if cell.skip:
        rec = {"arch": cell.arch, "shape": cell.shape, "mesh": mesh_name,
               "skipped": cell.skip}
        out.write_text(json.dumps(rec, indent=1))
        print(f"[skip] {cell.arch} x {cell.shape} ({mesh_name}): {cell.skip}")
        return rec
    try:
        mesh = _mesh(mesh_name)
        rec = lower_cell(cell, mesh, mesh_name)
        print(f"[ok]   {cell.arch} x {cell.shape} ({mesh_name}): "
              f"compile={rec['compile_s']}s flops/dev="
              f"{rec['flops_per_device']:.3e} "
              f"hbm={rec['hbm_bytes_per_device']:.3e} "
              f"wire={rec['collective_wire_bytes_per_device']:.3e}B",
              flush=True)
    except Exception as e:
        rec = {"arch": cell.arch, "shape": cell.shape, "mesh": mesh_name,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(f"[FAIL] {cell.arch} x {cell.shape} ({mesh_name}): {e}",
              flush=True)
    out.write_text(json.dumps(rec, indent=1))
    return rec


def paper_round(mesh, K: int, nk: int, d: int, device):
    """(round_fn, state, X, y, mask, order) of one CoCoA+ round of
    `configs.paper_svm` on a process mesh whose every axis is a worker
    axis, as this rank's block: (1, nk, d) dense rows through the dense
    kernel solver ("sdca_kernel", row 1), K = the mesh's size."""
    from ..configs.paper_svm import CONFIG as W
    from ..core.cocoa import CoCoAConfig, init_state, make_round_sharded
    daxes = tuple(mesh.axis_names)
    cfg = CoCoAConfig(loss=W.loss, lam=W.lam, gamma=1.0, sigma_p=float(K),
                      H=W.H, backend="shard_map", solver="sdca_kernel",
                      data_axis=daxes if len(daxes) > 1 else daxes[0])
    round_fn = make_round_sharded(cfg, mesh, False, float(W.n))
    state = init_state(d, 1, nk, device=device)
    X = torch.empty((1, nk, d), dtype=torch.float32, device=device)
    y = torch.empty((1, nk), dtype=torch.float32, device=device)
    mask = torch.empty((1, nk), dtype=torch.float32, device=device)
    order = torch.empty((1, nk), dtype=torch.int64, device=device)
    return round_fn, state, X, y, mask, order


def run_paper_cell(mesh_name: str, outdir: pathlib.Path) -> dict:
    """Dry-run the paper's own workload: one CoCoA+ round on the mesh,
    every rank a worker (the paper scales in K; Fig. 2)."""
    from ..configs.paper_svm import CONFIG as W
    mesh = _mesh(mesh_name)
    K = mesh.size
    nk, d = W.n // K, W.d
    t0 = time.time()
    round_fn, state, X, y, mask, order = paper_round(
        mesh, K, nk, d, torch.device("meta"))
    _, st, _ = count_step(round_fn, state, X, y, mask, order)
    t1 = time.time()
    rec = {
        "arch": "paper-svm", "shape": f"n{W.n}_d{W.d}_H{W.H}",
        "mesh": mesh_name, "kind": "cocoa_round",
        "compile_s": round(t1 - t0, 2),
        "flops_per_device": st["dot_flops"],
        "ew_flops_per_device": st["ew_flops"],
        "hbm_bytes_per_device": st["hbm_bytes"],
        "collectives": st["collectives"],
        "collective_wire_bytes_per_device": st["collective_wire_bytes"],
        "xla_cost_flops": -1.0,
        "memory_analysis": {"argument_size_in_bytes": _bytes(
            (state.w, state.alpha, state.alpha_bar, state.ef, X, y, mask,
             order))},
        "n_devices": mesh.size, "K_workers": K, "nk": nk, "d": d,
    }
    out = outdir / f"paper-svm__round__{mesh_name}.json"
    outdir.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(f"[ok]   paper-svm round ({mesh_name}): "
          f"flops/dev={rec['flops_per_device']:.3e} "
          f"ew={rec['ew_flops_per_device']:.3e} "
          f"wire={rec['collective_wire_bytes_per_device']:.3e}B", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--paper", action="store_true",
                    help="also dry-run the CoCoA+ round cell")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--steps", help="JSON list of steps to run on a fake "
                    "world of --mesh-shape (see run_steps)")
    ap.add_argument("--mesh-shape", default="2x2",
                    help="the fake world of --steps: DxM or PxDxM")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    n_fail = 0
    t0 = time.time()
    if args.steps:
        shape = tuple(int(n) for n in args.mesh_shape.split("x"))
        n_fail += run_steps(json.loads(args.steps), shape, outdir)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    cells = []
    if args.all:
        cells = Sp.all_cells()
    elif args.arch:
        shapes = [args.shape] if args.shape else list(Sp.SHAPES)
        cells = [Sp.cell_for(args.arch, s) for s in shapes]

    for mesh_name in meshes:
        for cell in cells:
            rec = run_cell(cell, mesh_name, outdir)
            n_fail += 1 if "error" in rec else 0
        if args.paper or args.all:
            try:
                run_paper_cell(mesh_name, outdir)
            except Exception as e:
                n_fail += 1
                print(f"[FAIL] paper-svm ({mesh_name}): {e}")
                traceback.print_exc()
    print(f"done; failures={n_fail} in {time.time() - t0:.1f} s")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
