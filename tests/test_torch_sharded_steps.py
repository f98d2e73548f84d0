"""The sharded LM steps (`launch.train.make_jitted_train_step`,
`launch.serve.make_jitted_serve_fns`, `run_training` on a process mesh)
held against the one-process port run on the same weights and inputs.

One spawned world of 4 gloo CPU ranks, a (data 2, model 2) process mesh,
runs every rule family at its smoke config: stablelm-1.6b (attention,
MLP; remat and the flash path), falcon-mamba-7b (mamba; the fused scan's
scoring forward), recurrentgemma-9b (RG-LRU, MQA ring attention, mode
serve_long: the sequence over data, head_dim over model), llama4-scout
(experts, the portable dispatch), qwen2-vl-7b (embeddings, M-RoPE
positions) and whisper-large-v3 (the encoder-decoder's caches): 2 train
steps, a prefill and 4 teacher-forced decode steps each
(`torch_parity.lm_job`). One world of 8 ranks, (pod 2, data 2, model 2),
runs a stablelm train step with dp = (pod, data).

Tolerances, float32: losses, grad norms, the step-1 grads of every leaf,
the prefill logits and the caches within 1e-5 relative (to the leaf's
largest magnitude); the next tokens equal. The parameters after the
steps within 1e-5 relative and 0.2 lr absolute: AdamW's first update of
an element is lr g / (|g| + eps), and where |g| is near eps = 1e-8 the
order of the sums alone moves it by a fraction of lr, while a wrong
sharded grad moves it by about 2 lr.

The reference's own sharded step (`repro.launch.train.
make_jitted_train_step` on a 2 x 2 mesh of 4 host devices) stops in an
XLA CPU all-reduce rendezvous on jax 0.9 (ROADMAP.md Queue 3); the last
test holds that break and holds the port's sharded step to the
reference's one-device `train_step` on the reference's weights, which is
what the jitted step computes.
"""
import concurrent.futures
import pickle

import numpy as np
import pytest
import torch

import torch_parity as tp
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import model as TM

TOL = 1e-5
LR = 3e-4
PARAM_ATOL = 0.2 * LR

_BASE = dict(B=4, S=16, steps=2, decode=4, S_max=24, mode="serve")
JOBS = [dict(_BASE, **j) for j in (
    dict(arch="stablelm-1.6b", cfg=dict(remat=True),
         serve_cfg=dict(use_flash_attention=True), run_training=2,
         checks=True),
    dict(arch="falcon-mamba-7b", score_cfg=dict(use_fused_ssm=True)),
    dict(arch="recurrentgemma-9b", mode="serve_long", S_max=40),
    dict(arch="llama4-scout-17b-a16e"),
    dict(arch="qwen2-vl-7b"),
    dict(arch="whisper-large-v3", S_max=16),
)]
for _j in JOBS:
    _j["name"] = _j["arch"]
ARCHS = [j["arch"] for j in JOBS]
POD_JOB = dict(name="pod", arch="stablelm-1.6b", B=4, S=16, steps=1)
REF_ARCH = "stablelm-1.6b"

# the reference's sharded step, in a child with 4 host devices; short
# rendezvous timeouts, so its break on jax 0.9 shows in seconds
REF_SHARDED = """
    import os, pickle
    os.environ["XLA_FLAGS"] += (
        " --xla_cpu_collective_call_warn_stuck_timeout_seconds=3"
        " --xla_cpu_collective_call_terminate_timeout_seconds=6")
    import jax, jax.numpy as jnp
    from repro.configs import smoke_config
    from repro.launch.train import make_jitted_train_step
    from repro.optim.adamw import adamw_init
    params, batch = pickle.loads(bytes(np.load({path!r})))
    params = jax.tree.map(jnp.asarray, params)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    step = make_jitted_train_step(smoke_config({arch!r}), mesh)
    new, _, m = step(params, adamw_init(params),
                     {{k: jnp.asarray(v) for k, v in batch.items()}})
    out["loss"] = np.asarray(m["loss"])
    out["grad_norm"] = np.asarray(m["grad_norm"])
    out["params"] = np.frombuffer(pickle.dumps(jax.tree.map(np.asarray, new)),
                                  np.uint8)
"""
RENDEZVOUS_BREAK = "Termination timeout for `all reduce"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want), initial=0.0)
                 / max(float(np.max(np.abs(want), initial=0.0)), 1e-30))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's weights and one-device train step on the
    stablelm smoke config, and its sharded step started in a child."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import smoke_config as ref_smoke
    from repro.launch.train import train_step as ref_train_step
    from repro.models import model as RM
    from repro.optim.adamw import adamw_init as ref_adamw_init

    cfg = ref_smoke(REF_ARCH)
    params = RM.init_params(jax.random.PRNGKey(3), cfg)
    init = tp.tree_to_numpy(params)
    batch = {k: tp.to_np(v) for k, v in
             tp.lm_batch(smoke_config(REF_ARCH), 4, 16, 0).items()}
    path = tmp_path_factory.mktemp("ref") / "in.npy"
    np.save(path, np.frombuffer(pickle.dumps((init, batch)), np.uint8))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    child = pool.submit(_child_outcome,
                        REF_SHARDED.format(path=str(path), arch=REF_ARCH))
    new, _, m = jax.jit(lambda p, o, b: ref_train_step(p, o, b, cfg=cfg))(
        params, ref_adamw_init(params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    yield dict(init=init, params=tp.tree_to_numpy(new),
               loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               child=child)
    pool.shutdown(wait=True)


def _child_outcome(code):
    try:
        return tp.reference_in_child(code, devices=4, timeout=300), None
    except RuntimeError as e:
        return None, str(e)


@pytest.fixture(scope="module")
def world4(reference):
    cfg = smoke_config(REF_ARCH)
    ref_job = dict(name="reference", arch=REF_ARCH, B=4, S=16, steps=1,
                   ref_state=TM.reference_state(reference["init"], cfg))
    return spawn_ranks(tp.lm_jobs_on_ranks, 4,
                       (JOBS + [ref_job], (2, 2), ("data", "model")),
                       timeout=600)[0]


@pytest.fixture(scope="module")
def one_process():
    torch.set_num_threads(1)
    return {j["name"]: tp.lm_job(j) for j in JOBS + [POD_JOB]}


@pytest.fixture(scope="module")
def world8():
    return spawn_ranks(tp.lm_jobs_on_ranks, 8,
                       ([POD_JOB], (2, 2, 2), ("pod", "data", "model")),
                       timeout=600)[0]


def _same_train(got, want, steps):
    for s in range(steps):
        for key in (f"loss{s}", f"grad_norm{s}"):
            assert _rel(got[key], want[key]) <= TOL, (key, got[key],
                                                     want[key])
    assert got["grads"].keys() == want["grads"].keys()
    for n in want["grads"]:
        assert _rel(got["grads"][n], want["grads"][n]) <= TOL, n
    assert got["params"].keys() == want["params"].keys()
    for n in want["params"]:
        np.testing.assert_allclose(got["params"][n], want["params"][n],
                                   rtol=TOL, atol=PARAM_ATOL, err_msg=n)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_steps_match_one_process(world4, one_process, arch):
    _same_train(world4[arch], one_process[arch], 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_one_process(world4, one_process,
                                                      arch):
    got, want = world4[arch], one_process[arch]
    if np.any(want["prefill_logits"]):
        assert _rel(got["prefill_logits"], want["prefill_logits"]) <= TOL
    else:                                      # the encoder-decoder's zeros
        assert not np.any(got["prefill_logits"])
    np.testing.assert_array_equal(got["next_tokens"], want["next_tokens"])
    assert got["cache"].keys() == want["cache"].keys()
    for n in want["cache"]:
        assert _rel(got["cache"][n], want["cache"][n]) <= TOL, n


def test_sharded_fused_scan_scoring_matches_one_process(world4, one_process):
    arch = "falcon-mamba-7b"
    assert _rel(world4[arch]["score"], one_process[arch]["score"]) <= TOL


def test_run_training_on_a_process_mesh(world4, one_process):
    got, want = world4["stablelm-1.6b"], one_process["stablelm-1.6b"]
    assert _rel(got["run_training_loss"], want["run_training_loss"]) <= TOL
    for n, w in want["run_training_params"].items():
        np.testing.assert_allclose(got["run_training_params"][n], w,
                                   rtol=TOL, atol=PARAM_ATOL, err_msg=n)


def test_the_step_updates_its_inputs_in_place(world4):
    """The update in place that stands in for the reference's donation:
    the step returns the model and the AdamW masters it was given, and
    the model's parameters have moved."""
    assert world4["stablelm-1.6b"]["updated_in_place"] is True


def test_shard_state_then_gather_state_is_the_whole_state(world4):
    assert world4["stablelm-1.6b"]["state_round_trip"] is True


def test_kernels_refuse_dtensors(world4):
    assert world4["stablelm-1.6b"]["kernels_refuse_dtensors"] is True


def test_pod_mesh_train_step_matches_one_process(world8, one_process):
    _same_train(world8["pod"], one_process["pod"], 1)


def test_sharded_step_against_the_reference(world4, reference):
    """The port's sharded step on the reference's weights against the
    reference's `train_step`; the reference's own sharded step either
    matches too or stops at its jax 0.9 rendezvous break."""
    cfg = smoke_config(REF_ARCH)
    got = world4["reference"]
    assert _rel(got["loss0"], reference["loss"]) <= TOL
    assert _rel(got["grad_norm0"], reference["grad_norm"]) <= 1e-4
    want = TM.reference_state(reference["params"], cfg)
    for n, w in want.items():
        np.testing.assert_allclose(got["params"][n], w, rtol=TOL,
                                   atol=PARAM_ATOL, err_msg=n)
    sharded, failure = reference["child"].result()
    if sharded is None:
        assert RENDEZVOUS_BREAK in failure, failure[-2000:]
        return
    assert _rel(got["loss0"], sharded["loss"]) <= TOL
    new = pickle.loads(sharded["params"].tobytes())
    for n, w in TM.reference_state(new, cfg).items():
        np.testing.assert_allclose(got["params"][n], w, rtol=TOL,
                                   atol=PARAM_ATOL, err_msg=n)
