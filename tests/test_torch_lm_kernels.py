"""The port's LM kernels, held against the reference's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; these are held
against `flash_attention(interpret=True)` and `layers.chunked_attention`,
and against `ssm_scan_pallas(interpret=True)` and `ref.ssm_scan_ref`, on
the same numpy inputs. Tolerance rtol 2e-4, atol 2e-5 in float32 (the
reference's own kernel tests): the online softmax and the recurrence take
their float32 sums in another order than XLA's. bfloat16 at rtol/atol
5e-2, as the reference's bf16 test: one bf16 rounding of p and of the
output is ~4e-3 relative.

The module runs torch single-threaded, as tests/test_torch_losses_regs.py
does. In a process where the reference's jitted calls had just run, the
first call of the plain flash version once came back with 16 of 65,536
outputs past the tolerance (5.5e-5 from a second call on the same
inputs), while the reference gave the same outputs on both calls: the
signature of the conj-logistic case there, whose cause was one OpenMP
worker's chunk. One thread keeps the comparison on the path whose
float32 rounding the tolerance states.

The `cuda` tests build the CUDA kernels and hold them against the plain
versions on the card -- flash's bfloat16 instance (tensor cores) at every
head dim, the scan at every G and its edge shapes -- and skip where there
is no card or nvcc. Run them on the card with `PYTHONPATH=src python -m
pytest -q -m cuda tests/test_torch_lm_kernels.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa, ref as port_ref
from repro_torch.kernels import ssm_scan as ss

RTOL, ATOL = 2e-4, 2e-5
FLASH_SHAPES = [            # tests/test_kernels.py's four cases
    (2, 128, 4, 2, 64, None),
    (1, 256, 8, 2, 32, None),
    (2, 200, 4, 4, 64, 50.0),    # ragged tail + softcap (gemma2-style)
    (1, 96, 6, 1, 128, None),    # MQA
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jref():
    """The JAX reference, imported only where a test asks for it."""
    pytest.importorskip("jax")
    import types
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.ssm_scan import ssm_scan_pallas
    from repro.models.layers import chunked_attention
    return types.SimpleNamespace(jnp=jnp, flash=flash_attention,
                                 chunked=chunked_attention, ref=ref,
                                 scan=ssm_scan_pallas)


def _qkv(rng, B, S, H, KV, hd):
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


@pytest.mark.parametrize("B,S,H,KV,hd,cap", FLASH_SHAPES)
def test_flash_plain_matches_pallas_and_chunked(jref, B, S, H, KV, hd, cap):
    rng = np.random.default_rng(B * S + H)
    q, k, v = _qkv(rng, B, S, H, KV, hd)
    jq, jk, jv = (jref.jnp.asarray(a) for a in (q, k, v))
    pos = jref.jnp.broadcast_to(jref.jnp.arange(S, dtype=jref.jnp.int32),
                                (B, S))
    pallas = np.asarray(jref.flash(jq, jk, jv, softcap=cap, q_block=64,
                                   k_block=64, interpret=True))
    chunked = np.asarray(jref.chunked(jq, jk, jv, pos, softcap=cap,
                                      q_chunk=64))
    before = fa.LAUNCHES
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), softcap=cap)
    assert fa.LAUNCHES == before            # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), chunked, rtol=RTOL, atol=ATOL)


def test_flash_plain_bf16(jref):
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 1, 128, 4, 2, 64
    q, k, v = _qkv(rng, B, S, H, KV, hd)
    jq, jk, jv = (jref.jnp.asarray(a, jref.jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jref.flash(jq, jk, jv, q_block=64, k_block=64,
                                 interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


def test_flash_plain_matches_port_chunked_attention():
    """The plain version against the port's own `chunked_attention` (the
    `use_flash_attention=False` path) on a GQA ragged shape."""
    from repro_torch.models.layers import chunked_attention
    rng = np.random.default_rng(11)
    B, S, H, KV, hd = 2, 77, 8, 2, 32
    q, k, v = map(torch.from_numpy, _qkv(rng, B, S, H, KV, hd))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    torch.testing.assert_close(
        fa.flash_attention_plain(q, k, v, softcap=30.0),
        chunked_attention(q, k, v, pos, softcap=30.0, q_chunk=16),
        rtol=RTOL, atol=ATOL)


def test_flash_wrapper_rejects_what_the_kernel_cannot_run():
    q = torch.zeros(1, 8, 6, 64)
    kv = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError, match="multiple of n_kv"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(*(t.to("meta") for t in (q, q, q)))


def _scan_inputs(rng, B, S, di, N):
    xin = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = (0.1 * np.abs(rng.standard_normal((B, S, di)))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    A = -np.abs(rng.standard_normal((di, N))).astype(np.float32)
    D = rng.standard_normal(di).astype(np.float32)
    return xin, dt, Bm, Cm, A, D


@pytest.mark.parametrize("B,S,di,N,block_d", [
    (2, 24, 256, 16, 128),
    (1, 37, 128, 8, 128),        # ragged S, the smoke config's N
    (2, 16, 512, 4, 256),
    (1, 9, 128, 1, 128),         # N = 1, below a thread's G
    (3, 11, 128, 5, 128),        # B = 3, N = 5 (not dividing G)
    (2, 1, 256, 16, 128),        # S = 1
])
def test_ssm_scan_plain_matches_pallas_and_ref(jref, B, S, di, N, block_d):
    rng = np.random.default_rng(S + di)
    ins = _scan_inputs(rng, B, S, di, N)
    jins = [jref.jnp.asarray(a) for a in ins]
    pallas = np.asarray(jref.scan(*jins, block_d=block_d, interpret=True))
    oracle = np.asarray(jref.ref.ssm_scan_ref(*jins))
    before = ss.LAUNCHES
    got = ss.ssm_scan(*map(torch.from_numpy, ins))
    assert ss.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL, atol=ATOL)


def test_ssm_scan_wrapper_checks_shapes():
    rng = np.random.default_rng(0)
    xin, dt, Bm, Cm, A, D = map(torch.from_numpy,
                                _scan_inputs(rng, 1, 4, 32, 4))
    with pytest.raises(ValueError, match="A must be"):
        ss.ssm_scan(xin, dt, Bm, Cm, A[:, :2], D)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ss.ssm_scan(*(t.to("meta") for t in (xin, dt, Bm, Cm, A, D)))


def test_ref_module_exports_the_plain_versions():
    assert port_ref.flash_attention_ref is fa.flash_attention_plain
    assert port_ref.ssm_scan_ref is ss.ssm_scan_plain


def test_build_hashes_each_kernel_with_its_own_headers():
    from repro_torch.kernels import build
    assert {k: [p.name for p in build.sources(k)] for k in build.KERNELS} == {
        "local_sdca": ["local_sdca.cu", "sdca_common.cuh"],
        "sparse_sdca_pipelined": ["sparse_sdca_pipelined.cu",
                                  "sdca_common.cuh"],
        "sparse_sdca_zx": ["sparse_sdca_zx.cu", "sdca_common.cuh"],
        "flash_attention": ["flash_attention.cu"],
        "ssm_scan": ["ssm_scan.cu"]}
    assert len({build._target(k).name for k in build.KERNELS}) == 5


def test_flash_smem_fits_every_head_dim():
    assert max(fa.smem_bytes(hd, dt) for hd in fa.HEAD_DIMS
               for dt in fa.DTYPES) <= 232_448


@pytest.fixture
def card():
    """A CUDA device with nvcc, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with "
                    "`python -m pytest -m cuda tests/test_torch_lm_kernels.py`")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,cap", FLASH_SHAPES + [
    (1, 300, 4, 4, 256, None), (2, 65, 4, 2, 64, 20.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_matches_plain_on_the_card(card, B, S, H, KV, hd, cap,
                                              dtype):
    """Kernel vs plain on the card: float32 at rtol 2e-4 / atol 2e-5 (sum
    order); bfloat16 at rtol 2e-2 / atol 2e-3 (one output rounding, and p
    rounded to bf16 on either side of a tie)."""
    rng = np.random.default_rng(S * H + hd)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(card, dt)
               for a in _qkv(rng, B, S, H, KV, hd))
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, softcap=cap)
    assert fa.LAUNCHES == before + 1
    want = fa.flash_attention_plain(q, k, v, softcap=cap)
    tol = (RTOL, ATOL) if dtype == "float32" else (2e-2, 2e-3)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])


# the state-group kernel's edges: N below, not dividing and equal to G;
# S around the 64-step chunk and past the second edge; B = 3; di past a
# 32-channel block (203: the 4-byte copies and stores)
SCAN_CUDA_CASES = [(2, 130, 256, 16), (1, 64, 8192, 16), (3, 17, 128, 8),
                   (1, 70, 256, 1), (1, 70, 256, 5), (1, 1, 256, 16),
                   (1, 63, 256, 16), (1, 65, 256, 16), (1, 129, 256, 16),
                   (3, 70, 200, 16), (2, 33, 203, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("group", ss.GROUPS)
@pytest.mark.parametrize("B,S,di,N", SCAN_CUDA_CASES)
def test_cuda_ssm_scan_matches_plain_on_the_card(card, B, S, di, N, group):
    """Kernel vs plain on the card at every G, rtol 2e-4 / atol 2e-5 (FMA
    contraction, and y's sum over the state taken in a thread's registers
    and then across its channel's partials)."""
    rng = np.random.default_rng(di + S)
    ins = [torch.from_numpy(a).to(card)
           for a in _scan_inputs(rng, B, S, di, N)]
    before = ss.LAUNCHES
    got = ss.ssm_scan(*ins, group=group)
    assert ss.LAUNCHES == before + 1
    torch.testing.assert_close(got, ss.ssm_scan_plain(*ins), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.cuda
def test_cuda_ssm_scan_smem_bytes_match_the_library(card):
    from repro_torch.kernels import build
    lib = build.load("ssm_scan")
    for N in (1, 5, 8, 16):
        for g in ss.GROUPS:
            assert lib.ssm_scan_smem_bytes(N, g) == ss.smem_bytes(N, g)
    assert lib.ssm_scan_smem_bytes(17, 4) == -1
    assert lib.ssm_scan_smem_bytes(0, 4) == -1
    assert lib.ssm_scan_smem_bytes(16, 2) == -1


# the bfloat16 instance (tensor cores) at every head dim: S around the
# 64-row tile and a prefill's length, GQA 4, MQA, softcap 50
FLASH_TC_CASES = [(1, S, 8, 2, None) for S in (1, 63, 64, 65, 200, 1345)] \
    + [(2, 130, 8, 1, None), (1, 200, 4, 4, 50.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("B,S,H,KV,cap", FLASH_TC_CASES)
def test_cuda_flash_bf16_tensor_cores_match_plain(card, hd, B, S, H, KV,
                                                  cap):
    """The mma.sync kernel against the plain version in bf16, at
    chip_smoke.py's FLASH_TOL for bf16 (rtol 2e-2, atol 2e-3: the output's
    bf16 rounding, and p rounded against another running max where the
    kernel's key tile is 32)."""
    rng = np.random.default_rng(S * hd + H)
    q, k, v = (torch.from_numpy(a).to(card, torch.bfloat16)
               for a in _qkv(rng, B, S, H, KV, hd))
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, softcap=cap)
    assert fa.LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    want = fa.flash_attention_plain(q, k, v, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-3)


@pytest.mark.cuda
def test_cuda_flash_smem_bytes_match_the_library(card):
    from repro_torch.kernels import build
    lib = build.load("flash_attention")
    for dt, code in fa.DTYPES.items():
        for hd in fa.HEAD_DIMS:
            assert lib.flash_attention_smem_bytes(hd, code) == \
                fa.smem_bytes(hd, dt)
    q = torch.zeros(1, 9, 2, 64, dtype=torch.bfloat16, device=card)
    buf = torch.zeros(1 + q.numel(), dtype=torch.bfloat16, device=card)
    shifted = buf[1:].view(1, 9, 2, 64)        # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(shifted, q, q)


@pytest.mark.cuda
def test_cuda_flash_grid_limit_follows_the_dtype(card):
    """float32 puts B * H on grid.y (at most 65,535 rows) and refuses more;
    bfloat16 puts B * H on grid.x and its q tiles on grid.y, so it runs
    65,536 heads, held to the plain version at the bf16 tolerance."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(a).to(card)
               for a in _qkv(rng, 4_096, 2, 16, 16, 32))
    with pytest.raises(ValueError, match="B \\* H = 65536"):
        fa.flash_attention(q, k, v)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-3)
