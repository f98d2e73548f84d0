"""Optimizer substrate (`repro.optim` counterpart): AdamW, CoCoA-DP
(`localdp`); `compress` is the deprecated shim over `comm.compress`."""
from .adamw import adamw_init, adamw_update
