#!/usr/bin/env python3
"""whisper-large-v3's first AdamW training steps from random weights, at
full width, over depths, dtypes and learning rates.

    python3 tools/whisper_lr_sweep.py [--layers 32,8,2] \
        [--dtypes bfloat16,float32] [--rates 3e-4,1e-4,1e-5]

For each depth L (L encoder and L decoder layers), dtype and rate it
builds the port's model anew from seed 0, takes 3 `train_step`s (remat
on, TF32 off) on one repeated batch of 2 streams x 1,500 random frame
embeddings x 448 TokenStream tokens, then one forward, and prints each
step's loss and grad norm, the loss after and the seconds it took. The batch is drawn with numpy from the seed, so
a run on the CPU (`--device cpu`, a cut depth) sees the same batch as
one on the card. Prints the card's name and power limit last.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAMES, B, STEPS, SEED = 1_500, 2, 3, 0


def _floats(s):
    return [float(x) for x in s.split(",")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", default="32",
                    type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--dtypes", default="bfloat16",
                    type=lambda s: s.split(","))
    ap.add_argument("--rates", default="3e-4,1e-4,1e-5", type=_floats)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import train as T
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(a.device)
    full = get_config("whisper-large-v3")
    rng = np.random.default_rng(SEED + 1)
    frames = torch.from_numpy(rng.standard_normal(
        (B, FRAMES, full.d_model)).astype(np.float32))
    toks = TokenStream(full.vocab, B, M.MAX_WHISPER_DEC,
                       seed=SEED).tensors_at(0, dev)
    for L in a.layers:
        for dtype in a.dtypes:
            cfg = dataclasses.replace(full, enc_layers=L, dec_layers=L,
                                      dtype=dtype)
            batch = {"frames": frames.to(dev, getattr(torch, dtype)),
                     **toks}
            for lr in a.rates:
                t0 = time.perf_counter()
                model = M.init_params(cfg, seed=SEED, device=dev)
                opt = T.init_opt(model)
                steps = []
                for _ in range(STEPS):
                    model, opt, m = T.train_step(model, opt, batch,
                                                 cfg=cfg, lr=lr)
                    steps.append(f"{float(m['loss']):.4f} (grad norm "
                                 f"{float(m['grad_norm']):.3f})")
                with torch.no_grad():
                    after = float(M.forward_train(model, batch, cfg)[0])
                print(f"L {L} + {L} {dtype} lr {lr:g}: step losses "
                      f"{', '.join(steps)}; after {after:.4f} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
                del model, opt
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())


if __name__ == "__main__":
    main()
