"""Batched serving on the PyTorch port: prefill a batch of prompts, then
greedy-decode continuations with the ring/linear caches (the same
`launch.serve` steps the decode dry-run cells run).

    PYTHONPATH=src python examples/torch_serve_batched.py [--arch gemma2-27b]
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu

Uses the reduced smoke config of the chosen architecture with random
weights from the seed; on a process mesh the same steps run sharded
through `launch.serve.make_jitted_serve_fns`.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.device import resolve_device, synchronize  # noqa: E402
from repro_torch.launch.serve import prefill_step, serve_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def prompts_for(cfg, B: int, P: int):
    """(prompt tokens (B, P), prompt embeddings (B, P, d) or None) from
    seed 0; an embeddings model is prefilled from the embeddings."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (B, P)).astype(np.int32)
    emb = (rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
           if cfg.input_mode != "tokens" else None)
    return prompts, emb


def generate(model, cfg, prompts, emb, G: int, device):
    """Prefill then G - 1 greedy decode steps: (the prefill's last logits
    (B, V), the generated tokens (B, G), prefill s, decode s)."""
    dev = resolve_device(device)
    B, P = prompts.shape
    cache = M.init_cache(cfg, B, P + G, device=dev)
    batch = ({"tokens": torch.from_numpy(prompts).to(dev)} if emb is None
             else {"embeds": torch.from_numpy(emb).to(dev)})
    t0 = time.perf_counter()
    logits, cache = prefill_step(model, batch, cache, cfg=cfg)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    synchronize(dev)
    pre_s = time.perf_counter() - t0
    outs = [tok]
    t0 = time.perf_counter()
    for t in range(P, P + G - 1):
        tok, cache = serve_step(model, cache, tok, t, cfg=cfg)
        outs.append(tok)
    synchronize(dev)
    return (logits[:, -1].float().cpu(), torch.cat(outs, 1).cpu(), pre_s,
            time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-27b",
                    choices=[a for a in ARCHS if a != "whisper-large-v3"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    if cfg.input_mode != "tokens":
        print(f"{args.arch} uses an embeddings frontend stub; serving the "
              "token backbone with random prompt embeddings")
    model = M.init_params(cfg, seed=0, device=args.device)
    B, P, G = args.batch, args.prompt_len, args.gen
    prompts, emb = prompts_for(cfg, B, P)
    _, gen, pre_s, dec_s = generate(model, cfg, prompts, emb, G, args.device)
    print(f"prefill {B}x{P}: {pre_s:.2f}s")
    print(f"decode {G-1} steps: {dec_s:.2f}s "
          f"({B*(G-1)/dec_s:.1f} tok/s batch)")
    for b in range(B):
        print(f"req{b}: prompt={prompts[b][:8].tolist()}... "
              f"-> {gen[b][:12].tolist()}...")


if __name__ == "__main__":
    main()
