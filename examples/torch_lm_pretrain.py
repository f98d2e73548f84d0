"""End-to-end LM pretraining on synthetic token data, on the PyTorch
port.

    PYTHONPATH=src python examples/torch_lm_pretrain.py           # ~20M params
    PYTHONPATH=src python examples/torch_lm_pretrain.py --params 100m \\
        --steps 300
    PYTHONPATH=src python examples/torch_lm_pretrain.py --device cpu \\
        --steps 20

Demonstrates the full training substrate: model factory, AdamW with f32
masters, checkpoint/restart (kill it mid-run and re-invoke -- it resumes
from the newest checkpoint), deterministic data pipeline. Checkpoints go
under `build/torch_lm_ckpt/<model>` in this checkout unless `--ckpt`
names another directory. On a process mesh the same step runs sharded
through `launch.train.make_jitted_train_step`.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.train import init_opt, train_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import Block, ModelConfig  # noqa: E402

CKPT = ROOT / "build" / "torch_lm_ckpt"
LR = 3e-4
LOG_EVERY, CKPT_EVERY = 10, 50


def config(size: str) -> ModelConfig:
    if size == "100m":
        return ModelConfig(name="lm100m", family="dense", n_layers=10,
                           d_model=640, n_heads=10, n_kv=10, head_dim=64,
                           d_ff=2560, vocab=32_000,
                           pattern=(Block(mlp="swiglu"),),
                           tie_embeddings=True, dtype="float32",
                           q_chunk=128, loss_chunk=128, remat=False)
    return ModelConfig(name="lm20m", family="dense", n_layers=6, d_model=384,
                       n_heads=6, n_kv=6, head_dim=64, d_ff=1536,
                       vocab=8_000, pattern=(Block(mlp="swiglu"),),
                       tie_embeddings=True, dtype="float32",
                       q_chunk=128, loss_chunk=128, remat=False)


def pretrain(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
             ckpt, device, model=None, log_every: int = LOG_EVERY,
             ckpt_every: int = CKPT_EVERY):
    """Train `cfg` (a seed-0 model, or `model`) on `TokenStream` batches to
    step `steps`, resuming from the newest checkpoint under `ckpt/<name>`
    and saving one every `ckpt_every` steps. Returns (model, the logged
    losses {step: loss})."""
    dev = resolve_device(device)
    model = model if model is not None else M.init_params(cfg, seed=0,
                                                          device=dev)
    opt = init_opt(model)
    mgr = CheckpointManager(pathlib.Path(ckpt) / cfg.name, keep=2)
    start = 0
    if mgr.latest_step():
        (state, opt), man = mgr.restore((model.state_dict(), opt))
        model.load_state_dict(state)
        start = man["step"]
        print(f"resumed from checkpoint step {start}")
    stream = TokenStream(cfg.vocab, batch, seq, seed=0)
    losses = {}
    t0 = time.perf_counter()
    for t in range(start, steps):
        # a pure function of the step -> exact resume
        model, opt, metrics = train_step(model, opt,
                                         stream.tensors_at(t, dev),
                                         cfg=cfg, lr=LR)
        if (t + 1) % log_every == 0:
            loss = float(metrics["loss"])       # waits for the card
            tok_s = batch * seq * log_every / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            losses[t + 1] = loss
            print(f"step {t+1:4d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"tok/s={tok_s:.0f}")
        if (t + 1) % ckpt_every == 0:
            mgr.save(t + 1, (model.state_dict(), opt))
    mgr.wait()
    print("done; checkpoint at", mgr.dir)
    return model, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="20m", choices=["20m", "100m"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = config(args.params)
    print(f"model: {M.count_params(cfg)/1e6:.1f}M params")
    pretrain(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
             ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
