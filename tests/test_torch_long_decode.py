"""Decode attention over a sequence-sharded KV cache
(`models.shards.decode_over_shards`, serve_long's layout) on 4 gloo CPU
ranks, a (data 2, model 2) process mesh, against one process.

Each rank scores only its own cache slots and the ranks combine their
softmax statistics (flash-decoding's split KV), so nothing that crosses
the wire grows with the cache. Float32, within TOL = 1e-5 relative:
- the attention core alone on cache layouts of every branch of
  `launch.sharding._cache_rule`: the sequence over "data" with KV heads
  over "model", the sequence over "data" with head_dim over "model" (MQA,
  the partial scores summed over "model" first), the sequence over
  "model" (serve's rule when KV does not divide it); a linear cache, a
  window that straddles the shard boundary, a position whose second
  shard holds no valid slot, a wrapped ring, a softcap; and the decode
  step's one-row write, which lands on the owning shard only;
- whole decode steps of smoke gemma3-27b (rings of 32 and a global
  cache), gemma2-27b (softcap) and recurrentgemma-9b (MQA ring, head_dim
  over "model", RG-LRU state) over a cache of 64 filled from the seed, at
  positions across the global cache's shard boundary and the rings'
  wrap: logits at every step and the whole cache after.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch.launch.mesh import spawn_ranks

import torch_parity as tp

TOL = 1e-5
_CASE = dict(B=2, S=64, KV=2, H=4, hd=16, ring=False, write=40)
CASES = [dict(_CASE, **c) for c in (
    dict(name="seq-data_kv-model", spec=(None, "data", "model", None),
         pos=40, seed=1),
    dict(name="second-shard-empty", spec=(None, "data", "model", None),
         pos=10, write=10, seed=2),
    dict(name="window-straddles", spec=(None, "data", "model", None),
         pos=40, window=24, seed=3),
    dict(name="head-dim-model_mqa_softcap", KV=1,
         spec=(None, "data", None, "model"), pos=50, softcap=5.0, seed=4),
    dict(name="seq-model", KV=1, spec=(None, "model", None, None), pos=37,
         seed=5),
    dict(name="ring-wrapped", S=32, ring=True, spec=(None, "data", "model",
                                                     None),
         pos=70, write=70 % 32, seed=6),
    dict(name="ring-head-dim-model", S=32, KV=1, ring=True,
         spec=(None, "data", None, "model"), pos=45, write=45 % 32, seed=7),
)]
POSITIONS = [30, 31, 32, 33, 45, 63]
JOBS = [dict(arch=a, B=1, S_max=64, positions=POSITIONS)
        for a in ("gemma3-27b", "gemma2-27b", "recurrentgemma-9b")]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.fixture(scope="module")
def world4():
    return spawn_ranks(tp.long_decode_on_ranks, 4,
                       (CASES, JOBS, (2, 2), ("data", "model")),
                       timeout=600)[0]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_attention_over_shards_matches_one_process(world4, case):
    got, want = world4["cases"][case], tp.long_case_plain(CASES[case])
    assert _rel(got["out"], want["out"]) <= TOL
    np.testing.assert_array_equal(got["written"], want["written"])


@pytest.mark.parametrize("job", range(len(JOBS)),
                         ids=[j["arch"] for j in JOBS])
def test_decode_steps_match_one_process(world4, job):
    got, want = world4["jobs"][JOBS[job]["arch"]], tp.long_decode_job(
        JOBS[job])
    assert got["logits"].shape == want["logits"].shape
    for i, pos in enumerate(POSITIONS):
        assert _rel(got["logits"][i], want["logits"][i]) <= TOL, pos
    assert got["cache"].keys() == want["cache"].keys()
    for n in want["cache"]:
        assert _rel(got["cache"][n], want["cache"][n]) <= TOL, n
    assert got["handed"] > 0
