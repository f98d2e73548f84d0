#!/usr/bin/env python3
"""whisper-large-v3's first AdamW training steps, the port against the
reference, at full width and a cut depth, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/whisper_lr_witness.py \
        [--rates 3e-4,1e-4] [--weights reference|port]

Both sides start from the same weights: the reference's draw (PRNGKey 0)
carried into the port by `params_from_reference`, or with `--weights
port` the port's own draw (seed 0, on the CPU) stacked into the
reference's tree. Both take 3 float32 `train_step`s at each rate
on one repeated batch, drawn as `tools/whisper_lr_sweep.py` draws it
(B 2 x 1,500 numpy frames x 448 TokenStream tokens), then one forward.
It prints each side's step losses and grad norms, the loss after, and the
largest loss gap between the two. Run from the root of a checkout; at
4 + 4 layers it takes ~12 GB and a few minutes a rate. Too large for the
suite: tests/test_torch_encdec.py holds the same steps at smoke size.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAMES, B, LAYERS, STEPS = 1_500, 2, 4, 3


def _reference_tree(model):
    """The port's weights as the reference's tree: the layers' leaves
    ("enc.<i>.attn.wq") stacked on a leading axis."""
    import jax.numpy as jnp
    import numpy as np
    tree = {}
    for name, p in model.state_dict().items():
        parts = name.split(".")
        stacked = parts[0] in ("enc", "dec")
        if stacked:
            parts = [parts[0]] + parts[2:]
        node = tree
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        a = p.detach().numpy()
        node[parts[-1]] = (node.get(parts[-1], []) + [a] if stacked else a)

    def done(node):
        if isinstance(node, dict):
            return {k: done(v) for k, v in node.items()}
        return jnp.asarray(np.stack(node) if isinstance(node, list)
                           else node)
    return done(tree)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rates", default="3e-4,1e-4",
                    type=lambda s: [float(x) for x in s.split(",")])
    ap.add_argument("--weights", default="reference",
                    choices=("reference", "port"))
    a = ap.parse_args()
    for p in (ROOT, ROOT / "src", ROOT / "tests"):
        sys.path.insert(0, str(p))
    import conftest  # noqa: F401  (the reference's jax shim)
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.configs import get_config
    from repro.launch.train import train_step as ref_train_step
    from repro.models import model as RM
    from repro.optim.adamw import adamw_init
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import init_opt, train_step
    from repro_torch.models import model as TM
    from torch_parity import tree_to_numpy

    cfg = dataclasses.replace(get_config("whisper-large-v3"),
                              enc_layers=LAYERS, dec_layers=LAYERS,
                              dtype="float32", remat=False)
    toks = TokenStream(cfg.vocab, B, TM.MAX_WHISPER_DEC, seed=0).batch_at(0)
    batch = {"frames": np.random.default_rng(1).standard_normal(
                 (B, FRAMES, cfg.d_model)).astype(np.float32),
             "tokens": toks["tokens"].astype(np.int32),
             "labels": toks["labels"].astype(np.int32)}
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    if a.weights == "port":
        want = jax.tree.structure(params)
        params = _reference_tree(TM.init_params(cfg, seed=0, device="cpu"))
        assert jax.tree.structure(params) == want
    weights = tree_to_numpy(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    ref_loss = jax.jit(lambda p, b: RM.forward_train(p, b, cfg)[0])
    for lr in a.rates:
        t0 = time.perf_counter()
        step = jax.jit(lambda p, o, b: ref_train_step(p, o, b, cfg=cfg,
                                                      lr=lr))
        p, o, ref = params, adamw_init(params), []
        for _ in range(STEPS):
            p, o, m = step(p, o, jb)
            ref.append((float(m["loss"]), float(m["grad_norm"])))
        ref_after = float(ref_loss(p, jb))
        del p, o
        t1 = time.perf_counter()
        model = TM.params_from_reference(weights, cfg, device="cpu")
        opt, port = init_opt(model), []
        for _ in range(STEPS):
            model, opt, m = train_step(model, opt, tb, cfg=cfg, lr=lr)
            port.append((float(m["loss"]), float(m["grad_norm"])))
        with torch.no_grad():
            port_after = float(TM.forward_train(model, tb, cfg)[0])
        del model, opt
        gap = max(abs(r[0] - q[0]) for r, q in zip(ref + [(ref_after, 0)],
                                                   port + [(port_after, 0)]))
        for side, ls, after, s in (("reference", ref, ref_after, t1 - t0),
                                   ("port", port, port_after,
                                    time.perf_counter() - t1)):
            print(f"L {LAYERS} + {LAYERS} float32 lr {lr:g} {side}: "
                  "step losses " + ", ".join(
                      f"{x:.4f} (grad norm {g:.3f})" for x, g in ls)
                  + f"; after {after:.4f} ({s:.0f} s)", flush=True)
        print(f"  largest loss gap {gap:.2e}", flush=True)


if __name__ == "__main__":
    main()
