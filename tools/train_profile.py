#!/usr/bin/env python3
"""Where a training step's time goes on the card: stablelm-1.6b at full
width, one TokenStream batch of B 4 x S 2,048, the plain attention and
remat "nothing" (`chip_smoke.py` phase 20's step).

    python3 tools/train_profile.py

Needs one NVIDIA card; run from the root of a checkout. Builds the model
and its AdamW state (seed 0), takes one cold `train_step`, then:

  1. times 3 rounds of 4 warm steps in turns with float32 matmuls in full
     float32 (as `chip_smoke.py` sets them) and in TF32, host clock after
     a synchronize; the plain attention's scores are the only float32
     matmuls of the step;
  2. traces one warm step (full float32) with torch.profiler and prints
     the device time by kernel and by launching op (the 25 largest of
     each), the device time of the `train/step` and `train/adamw` ranges
     it opens, and the step's device-busy share of its host time.

Prints the card's name and power limit last.
"""
from __future__ import annotations

import dataclasses
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 3                # rounds of warm steps, each full float32, TF32,
                         # TF32, full float32


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    if not torch.cuda.is_available():
        sys.exit("train_profile: no card (torch.cuda.is_available() is "
                 "False)")
    dev = torch.device("cuda:0")
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), remat=True,
                              remat_policy="nothing",
                              use_flash_attention=False)
    model = M.init_params(cfg, seed=0, device=dev)
    opt = T.init_opt(model)
    batch = TokenStream(cfg.vocab, 4, 2048, seed=0).tensors_at(0, dev)
    n = sum(p.numel() for p in model.parameters())
    print(f"train_profile: stablelm-1.6b, {cfg.n_layers} layers, {n} "
          f"params, B=4 S=2048, remat 'nothing'", flush=True)

    def step():
        nonlocal model, opt
        model, opt, _ = T.train_step(model, opt, batch, cfg=cfg)

    def timed(tf32):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed(False)                                     # cold
    secs = {False: [], True: []}
    for _ in range(STEPS):
        for tf32 in (False, True, True, False):
            secs[tf32].append(timed(tf32))
    for tf32, s in secs.items():
        what = "TF32" if tf32 else "full float32"
        print(f"  warm step, float32 matmuls in {what}: median "
              f"{statistics.median(s):.3f} s of {len(s)} "
              f"({', '.join(f'{x:.3f}' for x in s)}); "
              f"{4 * 2048 / statistics.median(s):.0f} tokens/s", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    real_update = T.adamw_update

    def adamw_in_range(*a, **kw):
        with record_function("train/adamw"):
            return real_update(*a, **kw)

    T.adamw_update = adamw_in_range
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("train/step"):
                step()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    finally:
        T.adamw_update = real_update
    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    ranges = {e.key: e.self_device_time_total for e in on_card
              if e.key.startswith("train/")}
    kernels = [e for e in on_card if not e.key.startswith("train/")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"  traced warm step: {host_s:.3f} s on the host clock, device "
          f"busy {busy_us / 1e6:.3f} s -> idle share "
          f"{1 - busy_us / 1e6 / host_s:.3f}; ranges on the device "
          f"timeline: " + ", ".join(f"{k} {v / 1e3:.1f} ms"
                                   for k, v in sorted(ranges.items())),
          flush=True)
    ops = [e for e in events if e.device_type != DeviceType.CUDA
           and e.self_device_time_total > 0]
    for what, rows in (("kernel", kernels), ("launching op", ops)):
        print(f"  device time by {what}, the 25 largest:")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:25]:
            t = e.self_device_time_total
            print(f"    {t / 1e3:9.2f} ms  {100 * t / busy_us:5.1f}%  "
                  f"x{e.count:<6d} {e.key[:100]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
