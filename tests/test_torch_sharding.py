"""The port's sharding rules (`launch/sharding.py`) held against the
reference's `repro.launch.sharding`, leaf by leaf.

For every non-skipped (architecture x shape) cell of `launch/specs.py`,
on the two production meshes (16 x 16 (data, model) and 2 x 16 x 16
(pod, data, model); the port's shape-only `make_production_mesh`, the
reference's device-free stand-in as its `tests/test_specs.py` has it),
the param, AdamW, batch and cache specs equal the reference's. The
port's leaves are unstacked: a weight under `reference_state`'s name
takes the reference's stacked spec without its leading None, a decoder
cache layer its period's. Then the modes (`axes_for`), the use-site
specs, the activation spec, the three k/v cache branches, and the
placements of a spec on a DeviceMesh layout.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch import configs as tconfigs
from repro_torch.launch import sharding as TSh
from repro_torch.launch import specs as TSp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as TM

jax = pytest.importorskip("jax")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch import sharding as RSh  # noqa: E402
from repro.launch import specs as RSp  # noqa: E402
from repro.models import model as RM  # noqa: E402


class FakeMesh:
    """Shape-compatible stand-in for the production mesh (no devices)."""
    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names
        self.size = int(np.prod(shape))


MESHES = {"single": (make_production_mesh(),
                     FakeMesh((16, 16), ("data", "model"))),
          "multi": (make_production_mesh(multi_pod=True),
                    FakeMesh((2, 16, 16), ("pod", "data", "model")))}
MODES = ("train", "serve", "serve_long")


class _Stacked:
    """A reference spec standing in for a stacked leaf: indexing it (as
    `reference_state` unstacks) gives the spec without its leading
    axis."""
    def __init__(self, spec):
        self.spec = tuple(spec)

    def __getitem__(self, i):
        return self.spec[1:]


def _ref_specs(tree):
    return jax.tree.map(_Stacked, tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def _plain(spec):
    return spec.spec if isinstance(spec, _Stacked) else tuple(spec)


def _same_params(got: dict, ref_tree, cfg, what):
    want = {k: _plain(v)
            for k, v in TM.reference_state(_ref_specs(ref_tree), cfg).items()}
    assert got.keys() == want.keys(), what
    for name, spec in got.items():
        assert tuple(spec) == want[name], (what, name, spec, want[name])


def _same_cache(got, ref_tree, cfg):
    if cfg.is_encdec():
        for part in ("self", "cross"):
            for k in ("k", "v"):
                assert tuple(got[part][k]) == tuple(ref_tree[part][k]), part
        return
    P = len(cfg.pattern)
    n_full = cfg.n_layers // P
    want = [None] * cfg.n_layers
    for j, period in enumerate(ref_tree.get("scan", ())):
        for i in range(n_full):
            want[i * P + j] = {k: tuple(v)[1:] for k, v in period.items()}
    for i, layer in enumerate(ref_tree["rest"]):
        want[n_full * P + i] = {k: tuple(v) for k, v in layer.items()}
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert {k: tuple(v) for k, v in g.items()} == w, f"layer {i}"


@pytest.fixture(scope="module")
def built():
    """Each arch's abstract weights, built once a side: {arch: (port meta
    model, reference ShapeDtypeStruct tree)}."""
    return {}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_cell_specs_match_reference(arch, mesh_name, built, monkeypatch):
    mesh, fake = MESHES[mesh_name]
    if arch not in built:
        cfg = tconfigs.get_config(arch)
        built[arch] = (TSp.abstract_params(cfg), RSp.abstract_params(cfg))
    port_params, ref_params = built[arch]
    monkeypatch.setattr(TSp, "abstract_params", lambda cfg: port_params)
    monkeypatch.setattr(RSp, "abstract_params", lambda cfg: ref_params)
    for shape in TSp.SHAPES:
        cell = TSp.cell_for(arch, shape)
        if cell.skip:
            continue
        cfg = cell.cfg
        kind, args = TSp.cell_inputs(cell)
        _, ref_args = RSp.cell_inputs(RSp.cell_for(arch, shape))
        mode = ("train" if kind == "train"
                else ("serve_long" if cell.kind == "decode_long" else "serve"))
        pspecs = TSh.param_specs(args[0], cfg, mesh, mode)
        ref_pspecs = RSh.param_specs(ref_args[0], cfg, fake, mode)
        _same_params(pspecs, ref_pspecs, cfg, shape)
        if kind == "train":
            opt, ref_opt = (TSh.opt_specs(pspecs),
                            RSh.opt_specs(ref_pspecs))
            for field in ("master", "m", "v"):
                _same_params(getattr(opt, field), getattr(ref_opt, field),
                             cfg, field)
            assert tuple(opt.step) == tuple(ref_opt.step) == ()
            got = TSh.batch_specs(args[2], cfg, mesh, mode)
            want = RSh.batch_specs(ref_args[2], cfg, fake, mode)
            assert {k: tuple(v) for k, v in got.items()} == {
                k: tuple(v) for k, v in want.items()}, shape
        else:
            cache, ref_cache = ((args[2], ref_args[2]) if kind == "prefill"
                                else (args[1], ref_args[1]))
            _same_cache(TSh.cache_specs(cache, cfg, mesh, mode),
                        RSh.cache_specs(ref_cache, cfg, fake, mode), cfg)
            if kind == "prefill":
                got = TSh.batch_specs(args[1], cfg, mesh, mode)
                want = RSh.batch_specs(ref_args[1], cfg, fake, mode)
                assert {k: tuple(v) for k, v in got.items()} == {
                    k: tuple(v) for k, v in want.items()}, shape


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_axes_and_activation_spec_match_reference(mesh_name, mode):
    mesh, fake = MESHES[mesh_name]
    assert dataclasses.asdict(TSh.axes_for(mesh, mode)) == \
        dataclasses.asdict(RSh.axes_for(fake, mode))
    assert tuple(TSh.activation_spec(mesh, mode)) == tuple(
        RSh.activation_spec(fake, mode))


def test_axes_for_refuses_an_unknown_mode():
    with pytest.raises(ValueError):
        TSh.axes_for(make_production_mesh(), "decode")


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "falcon-mamba-7b",
                                  "recurrentgemma-9b",
                                  "llama4-scout-17b-a16e"])
def test_use_specs_are_the_storage_specs_without_fsdp(arch):
    """The use-site spec of every weight is its storage spec with the fsdp
    axes replicated, as the reference's rule under fsdp=None gives."""
    mesh, fake = MESHES["multi"]
    cfg = tconfigs.get_config(arch)
    model = TSp.abstract_params(cfg)
    ax = TSh.axes_for(mesh, "train")
    ref_ax = dataclasses.replace(RSh.axes_for(fake, "train"), fsdp=None)
    store = TSh.param_specs(model, cfg, mesh, "train")
    use = TSh.use_specs(model, cfg, mesh, "train")
    for name, t in model.named_parameters():
        assert tuple(use[name]) == tuple(
            None if e == ax.fsdp else e for e in store[name]), name
        assert tuple(use[name]) == tuple(RSh._param_rule(
            name.replace(".", "/"), tuple(t.shape), ref_ax, fake)), name
    assert any(ax.fsdp in s for s in store.values())
    assert not any(ax.fsdp in s for s in use.values())


@pytest.mark.parametrize("arch,mode,want", [
    ("stablelm-1.6b", "serve", ("data", None, "model", None)),   # KV heads
    ("recurrentgemma-9b", "serve", ("data", "model", None, None)),  # seq
    ("recurrentgemma-9b", "serve_long", (None, "data", None, "model")),
])
def test_cache_spec_branches(arch, mode, want):
    """The k/v rule's three branches: the KV heads over model; else (MQA,
    one KV head) the sequence; else (serve_long, the sequence on data)
    head_dim. The batch is 16 and the cache 4,096 positions (the window
    of a ring is 2,048)."""
    mesh, fake = MESHES["single"]
    cfg = tconfigs.get_config(arch)
    cache = TSp.abstract_cache(cfg, 16, 4096)
    got = TSh.cache_specs(cache, cfg, mesh, mode)
    attn = next(i for i, b in enumerate(cfg.blocks()) if b.mixer == "attn")
    ref = RSh.cache_specs(jax.eval_shape(lambda: RM.init_cache(cfg, 16, 4096)),
                          cfg, fake, mode)
    _same_cache(got, ref, cfg)
    assert tuple(got[attn]["k"]) == want


def test_placements_follow_the_layout():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    layout = TSh.layout_for(mesh, "train")
    assert layout == (("pod", "data"), ("model",))
    assert TSh.layout_for(mesh, "serve") == (("pod",), ("data",),
                                              ("model",))
    spec = TSh.P(("pod", "data"), "model")
    assert TSh.placements(mesh, spec, layout) == (Shard(0), Shard(1))
    assert TSh.placements(mesh, spec) == (Shard(0), Shard(0), Shard(1))
    assert TSh.placements(mesh, TSh.P()) == (Replicate(),) * 3
    with pytest.raises(ValueError):      # data alone splits a merged dim
        TSh.placements(mesh, TSh.P("data"), layout)
    with pytest.raises(ValueError):      # axes out of mesh order
        TSh.placements(mesh, TSh.P(("data", "pod")))


def test_local_slices_are_row_major_over_the_axes():
    mesh = make_production_mesh(multi_pod=True)
    spec = TSh.P(("pod", "data"), "model")
    got = TSh.local_slices((64, 32, 3), spec, mesh,
                           {"pod": 1, "data": 2, "model": 5})
    assert got == (slice(36, 38), slice(10, 12), slice(None))
    with pytest.raises(ValueError):
        TSh.local_slices((63, 32), spec, mesh,
                         {"pod": 0, "data": 0, "model": 0})
