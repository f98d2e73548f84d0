#!/usr/bin/env python3
"""What one serve_long decode step hands to the collectives, for any
checkout, by the dry run on the host's CPU (no card).

    python3 tools/long_decode_bytes.py [--src PATH] [--arch gemma3-27b]
        [--layers 12] [--lengths 131072,524288] [--mesh 2x2]

Imports `repro_torch` from --src (default this checkout's src/), so a
parent unpacked with `git archive` and this checkout read the same step
with their own code. For each cache length S: the full-width config cut
to --layers layers, batch 1, one decode step at position S - 1 with the
KV caches in serve_long's layout (the sequence over "data"), lowered by
`launch.dryrun.lower_step` on a fake world of --mesh on "meta". Prints,
a line each S, the bytes handed to the collectives (the tally, what a
real run hands to gloo), the wire bytes a device (the ring model), the
dot FLOPs a device and the collective calls; then one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--arch", default="gemma3-27b")
    ap.add_argument("--layers", type=int, default=12,
                    help="layers of the config kept (0: all of them)")
    ap.add_argument("--lengths", default="131072,524288")
    ap.add_argument("--mesh", default="2x2")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    warnings.filterwarnings("ignore")
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_fake_mesh

    shape = tuple(int(n) for n in args.mesh.split("x"))
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    mesh = make_fake_mesh(shape, axes)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    out = []
    for S in (int(s) for s in args.lengths.split(",")):
        rec = D.lower_step(cfg, "decode", "serve_long",
                           D.step_inputs(cfg, "decode", 1, S), mesh)
        handed = sum(v[2] for v in rec["tally"].values())
        calls = sum(v[0] for v in rec["tally"].values())
        print(f"{args.arch} at {cfg.n_layers} layers, S {S}, mesh "
              f"{args.mesh}: {handed} B handed to the collectives in "
              f"{calls} calls, {rec['collective_wire_bytes_per_device']:.0f}"
              f" wire B a device, {rec['flops_per_device']:.4e} dot FLOPs a "
              f"device ({args.src})")
        out.append({"S": S, "handed": handed, "calls": calls,
                    "wire": rec["collective_wire_bytes_per_device"],
                    "flops": rec["flops_per_device"]})
    print(json.dumps({"arch": args.arch, "layers": cfg.n_layers,
                      "mesh": args.mesh, "src": args.src, "steps": out}))


if __name__ == "__main__":
    main()
