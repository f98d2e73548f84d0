"""The language-model seed (`repro.models` counterpart): decoder-only
attention and mamba-1 stacks as `nn.Module`s, prefill and decode with
caches, and the scoring forward."""
