"""The expert-parallel MoE and the grouped dispatch against the reference
(`repro.models.layers`).

The reference's `_moe_forward_shardmap` and its portable `moe_forward`
in G groups run once in a child with 4 forced host devices and a (data
2, model 2) mesh of Auto axes (jax 0.9's default Explicit axes break the
reference's sharding constraints; ROADMAP.md Queue 3), on smoke
llama4-scout's weights from `init_moe(PRNGKey(1))` and tokens (4, 16, d)
from `default_rng(0)`: both weight modes (gather_weights True and False)
at capacity_factor 1.25 (tokens dropped) and 64 (none dropped), float32.
The port's expert parallelism runs on 4 spawned gloo CPU ranks of the
same mesh shape on the same weights and tokens, each rank on its local
shards, the output gathered whole. Tolerances: the output within 2e-5
absolute (summation order of the partial products over fsdp and tp;
read up to ~1e-6), aux within 1e-6.

An expert-parallel train step on 4 gloo CPU ranks is held to the
one-process grouped twin within 1e-5 relative, loss and grad norm: G = 2,
each data shard's tokens routed as its own group, as the sharded step
routes them, and the aux the mean of the groups' aux, as the sharded
step's pmean over the shards (`torch_parity._group_mean_aux`; the
portable path's own aux, the reference's, pools the means over all
groups, and read 2.0162 against the sharded 2.0526 summed over the two
layers, 5.8e-5 of the loss). Every grad leaf is held within 1e-4 of its
largest entry.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_test_mesh, spawn_ranks
from repro_torch.models import layers as L

import torch_parity as tp

ARCH = "llama4-scout-17b-a16e"
B, S = 4, 16
MODES = [(True, 1.25), (False, 1.25), (True, 64.0), (False, 64.0)]
GROUPS = (2, 4)
OUT_ATOL = 2e-5
AUX_ATOL = 1e-6
TRAIN_RTOL = 1e-5
GRAD_REL = 1e-4       # every grad leaf, against its largest entry

_REF = """
import dataclasses
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import smoke_config
from repro.models import layers as L
cfg0 = smoke_config("llama4-scout-17b-a16e")
rng = np.random.default_rng(0)
x = rng.standard_normal((4, 16, cfg0.d_model)).astype(np.float32)
p = L.init_moe(jax.random.PRNGKey(1), cfg0, cfg0.d_ff, jnp.float32)
for k in ("router", "wi", "wg", "wo"):
    out["p_" + k] = np.asarray(p[k])
for k, v in p["shared"].items():
    out["p_shared_" + k] = np.asarray(v)
out["x"] = x
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
for gather in (True, False):
    for cf in (1.25, 64.0):
        cfg = dataclasses.replace(cfg0, capacity_factor=cf)
        L.set_moe_ctx(mesh=mesh, dp="data", tp="model", fsdp="data",
                      gather_weights=gather)
        o, a = jax.jit(lambda p, x: L.moe_forward(p, x, cfg, cfg.d_ff))(
            p, jnp.asarray(x))
        out[f"ep_{gather}_{cf}"] = np.asarray(o)
        out[f"ep_aux_{gather}_{cf}"] = np.asarray(a)
for G in (2, 4):
    L.set_moe_ctx(groups=G)
    o, a = L.moe_forward(p, jnp.asarray(x), cfg0, cfg0.d_ff)
    out[f"grouped_{G}"] = np.asarray(o)
    out[f"grouped_aux_{G}"] = np.asarray(a)
L.set_moe_ctx()
"""


@pytest.fixture(scope="module")
def reference():
    return tp.reference_in_child(_REF, devices=4)


def _params(ref):
    p = {k: ref["p_" + k] for k in ("router", "wi", "wg", "wo")}
    p["shared"] = {k: ref["p_shared_" + k] for k in ("wi", "wg", "wo")}
    return p


@pytest.fixture(scope="module")
def port_ranks(reference):
    jobs = [dict(params=_params(reference), x=reference["x"], gather=g,
                 cf=cf) for g, cf in MODES]
    train = [dict(B=4, S=16)]
    out = spawn_ranks(tp.moe_ep_on_ranks, 4,
                      (jobs, (2, 2), ("data", "model"), train), timeout=300)
    return out[0]


@pytest.mark.parametrize("mode", range(len(MODES)),
                         ids=[f"gather{g}-cf{cf}" for g, cf in MODES])
def test_expert_parallel_moe_matches_the_reference(reference, port_ranks,
                                                   mode):
    gather, cf = MODES[mode]
    got = port_ranks[0][mode]
    want = reference[f"ep_{gather}_{cf}"]
    assert got["out"].shape == want.shape
    np.testing.assert_allclose(got["out"], want, rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(got["aux"], reference[f"ep_aux_{gather}_{cf}"],
                               rtol=0, atol=AUX_ATOL)


@pytest.mark.parametrize("G", GROUPS)
def test_grouped_dispatch_matches_the_reference(reference, G):
    got = tp.moe_ep_job(dict(params=_params(reference), x=reference["x"],
                             cf=1.25, groups=G))
    np.testing.assert_allclose(got["out"], reference[f"grouped_{G}"],
                               rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(got["aux"], reference[f"grouped_aux_{G}"],
                               rtol=0, atol=AUX_ATOL)
    assert L.MOE_CTX["groups"] == 1 and L.MOE_CTX["mesh"] is None


def test_expert_parallel_train_step_matches_the_grouped_twin(port_ranks):
    got = port_ranks[1][0]
    twin = tp.moe_train_job(dict(B=4, S=16, groups=2))
    for k in ("loss", "grad_norm", "xent"):
        np.testing.assert_allclose(got[k], twin[k], rtol=TRAIN_RTOL,
                                   err_msg=k)
    assert set(got["grads"]) == set(twin["grads"])
    for k, g in twin["grads"].items():
        scale = float(np.abs(g).max()) or 1.0
        assert float(np.abs(got["grads"][k] - g).max()) <= GRAD_REL * scale, k


def test_expert_parallel_context_never_takes_the_portable_path():
    """With a mesh in MOE_CTX the MoE runs expert-parallel or raises: a
    one-card mesh (no ranks) and plain tensors are refused."""
    cfg = smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    p = L.init_moe(gen, cfg, cfg.d_ff, torch.float32)
    x = torch.zeros((2, 4, cfg.d_model))
    try:
        L.set_moe_ctx(mesh=make_test_mesh((2, 2), device="cpu"), dp="data",
                      fsdp="data")
        with pytest.raises(ValueError, match="process mesh"):
            L.moe_forward(p, x, cfg, cfg.d_ff)
    finally:
        L.set_moe_ctx()
    assert L.MOE_CTX == {"groups": 1, "spec": None, "mesh": None, "dp": None,
                         "tp": "model", "fsdp": None, "gather_weights": True}
