"""The port's `launch/specs.py` held against the reference's for all 40
(architecture x shape) cells: the cells and their skip reasons, and every
abstract argument of `cell_inputs` by shape and dtype: the weights and the
AdamW state under `params_from_reference`'s names (`reference_state`),
the batches by key, the caches layer by layer. The port's stand-ins are
tensors on the "meta" device; the reference's `ShapeDtypeStruct`s become
zero-stride numpy views, so no cell allocates its size."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import specs as TSp
from repro_torch.models import model as TM

from torch_parity import reference_cache_layers

jax = pytest.importorskip("jax")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch import specs as RSp  # noqa: E402

CELLS = [(a, s) for a in REF_ARCHS for s in RSp.SHAPES]


def _views(tree):
    """A tree of ShapeDtypeStructs as zero-stride numpy arrays."""
    return jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)


def _sig(x):
    """(shape, dtype name) of a meta tensor or a numpy view."""
    if isinstance(x, torch.Tensor):
        assert x.device.type == "meta"
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), np.dtype(x.dtype).name


def _same(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for name in got:
        assert _sig(got[name]) == _sig(want[name]), (what, name)


def _same_params(model, tree, cfg):
    _same(dict(model.named_parameters()),
          TM.reference_state(_views(tree), cfg), "params")


def _same_cache(got, want, cfg):
    want = _views(want)
    if cfg.is_encdec():
        for part in ("self", "cross"):
            _same(got[part], want[part], part)
        return
    layers = reference_cache_layers(want, cfg)
    assert len(got) == len(layers) == cfg.n_layers
    for i, (g, w) in enumerate(zip(got, layers)):
        _same(g, w, f"cache layer {i}")


@pytest.fixture(scope="module")
def built():
    """Each arch's abstract weights, built once a side for its four
    cells: {arch: (port meta model, reference ShapeDtypeStruct tree)}."""
    return {}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_inputs_match_reference(arch, shape, built, monkeypatch):
    if arch not in built:
        cfg = tconfigs.get_config(arch)
        built[arch] = (TSp.abstract_params(cfg), RSp.abstract_params(cfg))
    port_params, ref_params = built[arch]
    monkeypatch.setattr(TSp, "abstract_params", lambda cfg: port_params)
    monkeypatch.setattr(RSp, "abstract_params", lambda cfg: ref_params)
    cell, ref_cell = TSp.cell_for(arch, shape), RSp.cell_for(arch, shape)
    assert (cell.arch, cell.shape, cell.kind, cell.skip) == (
        ref_cell.arch, ref_cell.shape, ref_cell.kind, ref_cell.skip)
    assert dataclasses.asdict(cell.cfg) == dataclasses.asdict(ref_cell.cfg)
    cfg = cell.cfg
    kind, args = TSp.cell_inputs(cell)
    ref_kind, ref_args = RSp.cell_inputs(ref_cell)
    assert kind == ref_kind and len(args) == len(ref_args)
    assert args[0] is port_params
    _same_params(args[0], ref_args[0], cfg)
    if kind == "train":
        opt, ref_opt = args[1], ref_args[1]
        for field in ("master", "m", "v"):
            _same(getattr(opt, field),
                  TM.reference_state(_views(getattr(ref_opt, field)), cfg),
                  field)
        assert _sig(opt.step) == _sig(_views(ref_opt.step))
        _same(args[2], _views(ref_args[2]), "batch")
    elif kind == "prefill":
        _same(args[1], _views(ref_args[1]), "batch")
        _same_cache(args[2], ref_args[2], cfg)
    else:
        _same_cache(args[1], ref_args[1], cfg)
        assert _sig(args[2]) == _sig(_views(ref_args[2]))    # tokens
        assert _sig(args[3]) == _sig(_views(ref_args[3]))    # pos


def test_all_cells_and_skips_match_reference():
    """40 cells in the reference's order of shapes, its six skips (the
    pure full-attention archs and whisper at long_500k) with their
    reasons."""
    assert TSp.SHAPES == RSp.SHAPES
    got = {(c.arch, c.shape): (c.kind, c.skip) for c in TSp.all_cells()}
    want = {(c.arch, c.shape): (c.kind, c.skip) for c in RSp.all_cells()}
    assert got == want and len(got) == 40
    skips = {a for (a, s), (_, skip) in got.items() if skip}
    assert len(skips) == 6
    assert "enc-dec" in got[("whisper-large-v3", "long_500k")][1]


def test_encdec_batches_carry_frames_and_the_decoder_context():
    cfg = tconfigs.get_config("whisper-large-v3")
    train = TSp.train_batch_specs(cfg, 4, 1500)
    assert {k: tuple(v.shape) for k, v in train.items()} == {
        "frames": (4, 1500, 1280), "tokens": (4, 448), "labels": (4, 448)}
    assert list(TSp.prefill_batch_specs(cfg, 4, 1500)) == ["frames"]
    cache = TSp.abstract_cache(cfg, 4, 1500)
    assert tuple(cache["self"]["k"].shape) == (32, 4, 448, 20, 64)
    assert tuple(cache["cross"]["v"].shape) == (32, 4, 1500, 20, 64)
