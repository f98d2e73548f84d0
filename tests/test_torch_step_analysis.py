"""The step analysis (`launch.hlo_analysis`), the collective tally
(`comm.collectives`) and `obs.prof.analyze_jit`, held by hand and against
the reference's `repro.launch.hlo_analysis.collective_stats`.

A fake world runs in a child process (its default group must not share
a process with the gloo tests): a DTensor product counted on the rank's
shard, and one call of each of the port's collectives, whose tally is
priced against the reference's ring model on one-line HLO modules of the
same kind, bytes and group, as `tests/test_hlo_analysis.py` builds them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.launch.hlo_analysis import collective_stats as ref_collective_stats
from repro_torch.launch import hlo_analysis as H
from repro_torch.obs import prof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FAKE = """
import json, torch, torch.distributed as dist
from repro_torch.comm import collectives as col
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import device_mesh, make_fake_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
mesh = make_fake_mesh((2, 2), ("data", "model"))
dm = device_mesh(mesh)
x = DTensor.from_local(torch.empty(32, 4096, device="meta"), dm,
                       [Shard(0), Replicate()], run_check=False)
w = DTensor.from_local(torch.empty(4096, 1024, device="meta"), dm,
                       [Replicate(), Replicate()], run_check=False)
_, st, _ = H.count_step(lambda a, b: a @ b, x, w)
out = {"dot_flops": st["dot_flops"], "global": list(x.shape)}
snap = col.tally()
t = torch.empty(8, 16, device="meta")
world = dist.group.WORLD
col.all_reduce(t, world)
col.all_gather(t, world)
col.reduce_scatter(torch.empty(64, device="meta"), world)
col.all_gather_dim(t, mesh.subgroup(("data",)), 1)
y = DTensor.from_local(torch.empty(8, 16, device="meta"), dm,
                       [Shard(0), Replicate()], run_check=False)
y.redistribute(dm, [Replicate(), Replicate()])
out["tally"] = [[k[0], k[1], int(k[2])] + list(v)
                for k, v in sorted(col.tally_since(snap).items())]
out["dtensor_bytes"] = col.dtensor_bytes_sent()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_FAKE)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_matmul_flops_and_bytes_by_hand():
    x, w = torch.randn(8, 16), torch.randn(16, 4)
    out, st, records = H.count_step(torch.mm, x, w)
    assert out.shape == (8, 4) and records == {}
    assert st["dot_flops"] == 2 * 8 * 4 * 16
    assert st["ew_flops"] == 0 and st["flops"] == st["dot_flops"]
    assert st["hbm_bytes"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    # a view is free; an add is one FLOP and three tensors' bytes a element
    _, st, _ = H.count_step(lambda a: a.T + 1.0, x)
    assert st["ew_flops"] == 8 * 16 and st["dot_flops"] == 0
    assert st["hbm_bytes"] == 4 * 2 * 8 * 16
    assert st["collectives"] == {} and st["collective_wire_bytes"] == 0


def test_a_dtensor_product_is_counted_per_device(fake):
    """x (64, 4096) split over "data" (2), w (4096, 1024) replicated: rank
    0's product is (32, 4096) @ (4096, 1024), not the global one."""
    assert fake["global"] == [64, 4096]
    assert fake["dot_flops"] == 2 * 32 * 4096 * 1024


def _hlo(line: str) -> str:
    return ("HloModule t\n\nENTRY %main (x: f32[8,16]) -> f32[8,16] {\n"
            "  %x = f32[8,16] parameter(0)\n  " + line + "\n}\n")


# the reference's one-line modules for the port's calls in `_FAKE`, in
# the tally's (kind, group) order
_LINES = {
    ("all-gather", 2): "ROOT %c = f32[8,32] all-gather(%x), "
                       "replica_groups={{0,2}}, dimensions={1}",
    ("all-gather", 4): "ROOT %c = f32[4,8,16] all-gather(%x), "
                       "replica_groups={{0,1,2,3}}, dimensions={0}",
    ("all-reduce", 4): "ROOT %c = f32[8,16] all-reduce(%x), "
                       "replica_groups={{0,1,2,3}}, to_apply=%add",
    ("reduce-scatter", 4): "ROOT %c = f32[16] reduce-scatter(%x), "
                           "replica_groups={{0,1,2,3}}, dimensions={0}, "
                           "to_apply=%add",
}


def test_wire_bytes_match_the_reference_ring_model(fake):
    records = {}
    for kind, g, routed, count, b, handed in fake["tally"]:
        records[(kind, g, bool(routed))] = (count, b, handed)
    # the routed DTensor gather (S(0) -> R over data, 2 ranks) and the
    # direct calls; every kind and group the port issued
    assert ("all-gather", 2, True) in records
    assert fake["dtensor_bytes"] == records[("all-gather", 2, True)][2]
    direct = {(k, g): v for (k, g, r), v in records.items() if not r}
    assert set(direct) == set(_LINES)
    for (kind, g), (count, b, _) in direct.items():
        port = H.collective_stats({(kind, g, False): (count, b, 0)})[kind]
        ref = ref_collective_stats(_hlo(_LINES[(kind, g)]))[kind]
        assert (port["count"], port["bytes"]) == (ref["count"], ref["bytes"])
        assert port["wire_bytes"] == pytest.approx(ref["wire_bytes"],
                                                   rel=1e-12)


@pytest.mark.parametrize("kind,line", [
    ("all-to-all", "ROOT %c = f32[8,16] all-to-all(%x), "
                   "replica_groups={{0,1,2,3}}, dimensions={0}"),
    ("collective-permute", "ROOT %c = f32[8,16] collective-permute(%x), "
                           "source_target_pairs={{0,1},{1,0}}"),
])
def test_kinds_the_port_does_not_issue_price_as_the_reference(kind, line):
    ref = ref_collective_stats(_hlo(line))[kind]
    g = 4 if kind == "all-to-all" else 2
    port = H.collective_stats({(kind, g, False): (1, 8 * 16 * 4, 0)})[kind]
    assert port == pytest.approx(ref)
    assert H.total_wire_bytes({kind: port}) == pytest.approx(
        ref["wire_bytes"])


def test_analyze_jit_and_profile_fn_without_stats():
    x = torch.randn(64, 64)
    fn, stats, first_s = prof.analyze_jit(torch.mm, x, x)
    assert fn is torch.mm and first_s > 0
    assert stats["dot_flops"] == 2 * 64 ** 3
    assert stats["hbm_bytes"] == 3 * 4 * 64 ** 2
    p = prof.profile_fn(torch.mm, x, x, name="mm", iters=2)
    assert p.flops == stats["flops"] and p.hbm_bytes == stats["hbm_bytes"]
    assert p.compile_s > 0 and p.wall_s > 0
    prof.validate_profile(p.to_dict())


def test_kernels_declare_their_cost_on_meta():
    """On "meta" (the dry run) nothing launches: each wrapper returns its
    outputs' shapes and declares `obs.cost`'s formula, which the counter
    takes in the kernel's place."""
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.local_sdca import local_sdca
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.obs import cost

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def same(st, want):
        assert st["dot_flops"] == want["dot_flops"]
        assert st["flops"] == want["flops"]
        assert st["hbm_bytes"] == want["hbm_bytes"]

    q = meta(2, 64, 8, 32, dtype=torch.bfloat16)
    kv = meta(2, 64, 2, 32, dtype=torch.bfloat16)
    out, st, _ = H.count_step(flash_attention, q, kv, kv)
    assert out.shape == q.shape and out.device.type == "meta"
    same(st, cost.flash_attention(2, 64, 8, 2, 32, 2))
    assert st["dot_flops"] == 4 * 32 * 2 * 8 * 64 * 65 // 2

    B, S, di, N = 2, 16, 64, 8
    y, st, _ = H.count_step(ssm_scan, meta(B, S, di), meta(B, S, di),
                            meta(B, S, N), meta(B, S, N), meta(di, N),
                            meta(di))
    assert y.shape == (B, S, di)
    same(st, cost.ssm_scan(B, S, di, N))

    K, nk, d = 2, 16, 24
    (dalpha, du), st, _ = H.count_step(
        local_sdca, meta(K, nk, d), meta(K, nk), meta(K, nk), meta(K, nk),
        meta(d), 0.5, meta(K, nk, dtype=torch.int32), loss=get_loss("hinge"))
    assert dalpha.shape == (K, nk) and du.shape == (K, d)
    same(st, cost.dense_walk(K, nk, d))
