"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; run
them on the GPU machine with ``pytest -m cuda tests/test_torch_cuda_kernels.py``.
The file imports no JAX, which that machine does not have."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
