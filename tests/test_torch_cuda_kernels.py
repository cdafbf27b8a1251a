"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; run
them on the GPU machine with ``pytest -m cuda tests/test_torch_cuda_kernels.py``.
The file imports no JAX, which that machine does not have."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402


def decode_case(seed, b, hkv, g, d, page, n_pages, kv_len):
    """Pools of 1 + b*n_pages pages, each sequence owning n_pages of them
    in shuffled order; a sequence with kv_len 0 keeps an all-zero (idle)
    table row."""
    rng = np.random.default_rng(seed)
    pool = (1 + b * n_pages, page, hkv, d)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    k_pages = rng.standard_normal(pool).astype(np.float32)
    v_pages = rng.standard_normal(pool).astype(np.float32)
    table = (1 + rng.permutation(b * n_pages)).reshape(b, n_pages).astype(np.int32)
    kv_len = np.asarray(kv_len, dtype=np.int32)
    table[kv_len == 0] = 0
    return q, k_pages, v_pages, table, kv_len


def as_torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CUDA_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            # f32 results rounded once to bf16 may land one ulp apart (at most
            # 2**-7 of the value): rtol allows two ulps, atol values near zero
            torch.bfloat16: dict(rtol=1.6e-2, atol=2e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 40])
def test_cuda_paged_decode_attention_matches_plain(cuda, dtype, window):
    q, kp, vp, table, kl = decode_case(6, 8, 8, 4, 64, 16, 8, [0, 128, 17, 1, 64, 100, 33, 127])
    args = [t.to(cuda) for t in as_torch(q, kp, vp, table, kl)]
    args[:3] = [t.to(dtype) for t in args[:3]]
    before = ops.LAUNCHES["paged_decode_attention"]
    out = ops.paged_decode_attention(*args, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode_attention"] == before + 1
    plain = ref.paged_decode_attention_ref(*args, window=window)
    torch.testing.assert_close(out.float(), plain.float(), **CUDA_TOL[dtype])
    assert torch.all(out[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_kv_append_matches_plain(cuda, dtype):
    _, kp, vp, table, _ = decode_case(7, 8, 8, 1, 64, 16, 8, [5] * 8)
    rng = np.random.default_rng(8)
    new = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    pos = rng.integers(0, 128, size=8).astype(np.int32)
    table[7] = 0  # idle slot: scratch page 0
    tk, tv, tkp, tvp, tt, tpos = [t.to(cuda) for t in as_torch(new[0], new[1], kp, vp, table, pos)]
    tk, tv, tkp, tvp = [t.to(dtype) for t in (tk, tv, tkp, tvp)]
    want_k, want_v = ref.paged_kv_append_ref(tk, tv, tkp.clone(), tvp.clone(), tt, tpos)
    got_k, got_v = ops.paged_kv_append(tk, tv, tkp, tvp, tt, tpos)
    torch.cuda.synchronize()
    assert torch.equal(got_k[1:], want_k[1:]) and torch.equal(got_v[1:], want_v[1:])


# The SSD kernel and its plain version both compute in f32 from the same
# f32 (or bf16-valued) inputs, in other summation orders, so the error
# grows with the outputs: at mamba2-370m FULL widths chip_smoke.py reads a
# max error of 1.2e-5 of the largest |y| (PERF.md).  rtol 1e-4 allows
# about 8x that per element; atol covers outputs near zero.
SSD_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 256, 4, 64, 128, 64), (1, 48, 8, 16, 16, 16)],
                         ids=["full_widths", "smoke_widths"])
def test_cuda_ssd_chunked_matches_plain(cuda, bc_dtype, shape):
    b, t, h, p, n, chunk = shape
    rng = np.random.default_rng(9)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32) * 0.1
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, h)) - 3.0))).astype(np.float32)
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    tx, ta, tb, tc, ts = [v.to(cuda) for v in as_torch(x, a, bm, cm, s0)]
    tb, tc = tb.to(bc_dtype), tc.to(bc_dtype)
    for state in (None, ts):
        before = ssd_scan.LAUNCHES["ssd_chunked"]
        y, s = ssd_scan.ssd_chunked(tx, ta, tb, tc, chunk, state)
        torch.cuda.synchronize()
        assert ssd_scan.LAUNCHES["ssd_chunked"] == before + 1
        y_ref, s_ref = ssd_scan.ssd_chunked_ref(tx, ta, tb, tc, chunk, state)
        torch.testing.assert_close(y, y_ref, **SSD_TOL)
        torch.testing.assert_close(s, s_ref, **SSD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 8, 8, 6), (256, 64, 128, 256)],
                         ids=["chunk_not_multiple_of_4", "tiles_beyond_shared_memory"])
def test_cuda_ssd_chunked_refuses_shapes_it_cannot_tile(cuda, shape):
    """Shapes the kernel cannot take are refused without a launch, and the
    wrapper raises instead of running anything else."""
    t, p, n, chunk = shape
    assert ssd_scan.ops.smem_bytes(64, 128, 64) <= 232448  # FULL fits one block
    x = torch.zeros((1, t, 2, p), device=cuda)
    a = torch.ones((1, t, 2), device=cuda)
    bc = torch.zeros((1, t, n), device=cuda)
    before = ssd_scan.LAUNCHES["ssd_chunked"]
    with pytest.raises(RuntimeError, match="cannot tile"):
        ssd_scan.ssd_chunked(x, a, bc, bc, chunk)
    assert ssd_scan.LAUNCHES["ssd_chunked"] == before
