"""Continuous-batching serving runtime (`repro.launch.serving_runtime`
counterpart): a slot-based request scheduler over the prefill and decode
steps.

A fixed pool of B slots holds in-flight requests; every engine step
decodes one token for all active slots. Finished or empty slots are refilled
from the queue, one slot's prompt prefilled at a time into that slot's rows
of the cache. The decode runs the whole pool at the *maximum* live position
-- the reference's approximation, kept as it is so both engines give the
same tokens: a slot at a lower position writes its new K/V at that maximum
and attends over the gap left in its rows.

Slot caches are dense (S_max per slot), rings of `window` slots for
sliding-window blocks (min(S_max, window) slots; a ring when that is the
window), and updated in place: a slot's prefill writes through views of
its rows, a prompt past the window rolled into its ring. A refilled slot
keeps the last request's K/V rows past its prompt, as the reference's
does; its SSM or RG-LRU state (h and the conv tail) is zeroed first,
since a prefill continues from whatever state it is given.

Under MoE the decode runs all B slots, dead ones included, as one batch
of T = B tokens, so each expert has C = ceil(B · capacity_factor / E)
slots in a step (1 for llama4-scout's 16 experts at 4 slots, and for
maverick's 128): when two slots route to one expert, the later slot
gets only the shared expert, and a dead slot ahead of a live one can
take the capacity. That is the reference's engine
(`repro.launch.serving_runtime`), kept so both give the same tokens. A
prefill runs one slot, B = 1 and T = the prompt's length, so its
capacity follows the prompt.

The engine serves token models. An "embeddings" model (qwen2-vl) has no
prompt tokens to prefill from, as the reference's engine has none (its
slot prefill passes `{"tokens": ...}`): it is refused here, and served
through `launch.serve.prefill_step` with `{"embeds", "positions"}` and
`serve_step`. So is an encoder-decoder (whisper), which the reference's
engine refuses too ("token LMs only"): `launch.serve.prefill_step`
with `{"frames"}`, then `serve_step`.

`submit` and `step` run under `torch.inference_mode()`: the weights are
trainable parameters, and a serving step records no autograd graph.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models import model as M
from ..models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ModelConfig, model: M.Decoder, *, slots: int = 4,
                 s_max: int = 256, eos: Optional[int] = None,
                 device=DEFAULT_DEVICE):
        if cfg.is_encdec() or cfg.input_mode != "tokens":
            raise NotImplementedError(
                "token LMs only: serve an embeddings model or an "
                "encoder-decoder (whisper) through launch.serve."
                "prefill_step and serve_step")
        self.device = torch.empty(0, device=resolve_device(device)).device
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.cfg, self.model = cfg, model
        self.B, self.S = slots, s_max
        self.eos = eos
        self.cache = M.init_cache(cfg, slots, s_max, self.device)
        self.pos = np.zeros(slots, np.int32)        # next write index per slot
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: "deque[Request]" = deque()
        self.last_tok = np.zeros((slots, 1), np.int32)

    def _prefill_slot(self, tokens, slot: int):
        """Prefill one slot: run the prompt through, writing that slot's
        rows of the cache. tokens: (1, P)."""
        sub = [{k: c[slot:slot + 1] for k, c in layer.items()}
               for layer in self.cache]
        for layer in sub:
            if "h" in layer:        # a request starts from a zero state
                layer["h"].zero_()
                layer["conv"].zero_()
        logits, _ = M.prefill(self.model, {"tokens": tokens}, sub, self.cfg)
        return logits

    # --- public API ---------------------------------------------------------
    @torch.inference_mode()
    def submit(self, prompt: np.ndarray, max_new: int = 32) -> Request:
        r = Request(rid=len(self.queue) + 1000, prompt=np.asarray(prompt),
                    max_new=max_new)
        self.queue.append(r)
        return r

    def _fill_slots(self):
        for b in range(self.B):
            if self.active[b] is not None or not self.queue:
                continue
            r = self.queue.popleft()
            toks = torch.from_numpy(r.prompt[None].astype(np.int64)).to(
                self.device)
            logits = self._prefill_slot(toks, b)
            nxt = int(torch.argmax(logits[0, -1]))
            r.out.append(nxt)
            self.active[b] = r
            self.pos[b] = len(r.prompt)
            self.last_tok[b, 0] = nxt

    @torch.inference_mode()
    def step(self) -> int:
        """One engine step: refill slots, decode one token for all live
        slots. Returns the number of live requests."""
        self._fill_slots()
        live = [b for b in range(self.B) if self.active[b] is not None]
        if not live:
            return 0
        pos = int(self.pos.max())
        toks = torch.from_numpy(self.last_tok.astype(np.int64)).to(
            self.device)
        logits, self.cache = M.decode_step(self.model, self.cache, toks, pos,
                                           self.cfg)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32).cpu()
        nxt = nxt.numpy()
        for b in live:
            r = self.active[b]
            r.out.append(int(nxt[b]))
            self.last_tok[b, 0] = int(nxt[b])
            self.pos[b] += 1
            if (len(r.out) >= r.max_new
                    or (self.eos is not None and nxt[b] == self.eos)
                    or self.pos[b] >= self.S - 1):
                r.done = True
                self.active[b] = None
        return len(live)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                return
