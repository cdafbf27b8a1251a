"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; run
them on the GPU machine with ``pytest -m cuda tests/test_torch_cuda_kernels.py``.
The file imports no JAX, which that machine does not have."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.config import get_arch  # noqa: E402
from repro_torch.kernels import flash_attention, moe_gating, ssd_scan, tcmm_assign  # noqa: E402
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import unembed  # noqa: E402
from repro_torch.serving import ContinuousBatcher, PagedSpec, Request  # noqa: E402


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 16])
def test_cuda_decode_attention_masks_at_the_query_position(cuda, dtype, window):
    """B2 and B3 with q_pos, as the model calls them: rows at their cache
    end, rows whose query sits below it, and idle-slot rows whose position
    lies past the window (no key left: every row of the table weighs the
    same), each against its plain version."""
    kv_len = np.array([100, 64, 3, 1, 128, 40, 17, 9], dtype=np.int32)
    q_pos = np.array([99, 20, 90, 50, 127, 39, 60, 8], dtype=np.int32)
    q, kp, vp, table, kl = decode_case(20, 8, 8, 4, 128, 16, 8, kv_len)
    tq, tkp, tvp, tt, tkl, tqp = [t.to(cuda) for t in as_torch(q, kp, vp, table, kl, q_pos)]
    tq, tkp, tvp = (t.to(dtype) for t in (tq, tkp, tvp))
    kc = ref.gather_pages(tkp, tt).contiguous()
    vc = ref.gather_pages(tvp, tt).contiguous()
    paged = ops.paged_decode_attention(tq, tkp, tvp, tt, tkl, window=window, q_pos=tqp)
    dense = ops.decode_attention(tq, kc, vc, tkl, window=window, q_pos=tqp)
    plain = ref.paged_decode_attention_ref(tq, tkp, tvp, tt, tkl, window=window, q_pos=tqp)
    torch.cuda.synchronize()
    torch.testing.assert_close(paged.float(), plain.float(), **CUDA_TOL[dtype])
    torch.testing.assert_close(dense.float(), plain.float(), **CUDA_TOL[dtype])


@pytest.mark.cuda
def test_cuda_paged_kv_append_row_named_twice_takes_the_last_slot(cuda):
    """Eight idle slots on one row of scratch page 0, and two live slots on
    one row: the last slot's row lands, equal to the plain version's,
    page 0 included."""
    _, kp, vp, table, _ = decode_case(18, 16, 8, 1, 128, 16, 4, [5] * 16)
    table[8:] = 0
    table[1] = table[0]
    pos = np.full(16, 7, dtype=np.int32)
    rng = np.random.default_rng(19)
    new = rng.standard_normal((2, 16, 8, 128)).astype(np.float32)
    tk, tv, tkp, tvp, tt, tpos = [t.to(cuda) for t in as_torch(new[0], new[1], kp, vp, table, pos)]
    want_k, want_v = ref.paged_kv_append_ref(tk, tv, tkp.clone(), tvp.clone(), tt, tpos)
    got_k, got_v = ops.paged_kv_append(tk, tv, tkp, tvp, tt, tpos)
    torch.cuda.synchronize()
    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)
    assert torch.equal(got_k[0, 7], tk[15]) and torch.equal(got_v[table[0, 0], 7], tv[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window", [(1024, 0), (1000, 0), (1024, 128), (1000, 37)])
def test_cuda_dense_decode_attention_matches_plain(cuda, dtype, s, window):
    """B3 at llama3.2-1b's heads over 16 rows of ragged lengths: empty,
    full, past the cache (clamped on the card to S, so held against the
    plain version at min(kv_len, S)) and partial."""
    rng = np.random.default_rng(12)
    kv_len = np.array([0, s, s + 7, 1, 31, 32, 33, 100, 129, 500, 513, 700, 999, 2, 64, 300])
    q = rng.standard_normal((16, 32, 64)).astype(np.float32)
    kc = rng.standard_normal((16, s, 8, 64)).astype(np.float32)
    vc = rng.standard_normal((16, s, 8, 64)).astype(np.float32)
    tq, tk, tv = [t.to(cuda).to(dtype) for t in as_torch(q, kc, vc)]
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(tq, tk, tv, lens, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    plain = ref.decode_attention_ref(tq, tk, tv, lens.clamp(max=s), window=window)
    torch.testing.assert_close(out.float(), plain.float(), **CUDA_TOL[dtype])
    assert torch.all(out[0] == 0)


SPLIT = ops.SPLIT_ROWS  # key rows a block of B2 and B3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("page", [8, 48])
def test_cuda_split_decode_matches_plain(cuda, dtype, d, g, page):
    """B2 and B3 at the edges of their key splits, over 128-page tables of
    pages that do not divide the split: kv_len 0, split - 1, split,
    split + 1, 2 * split + 1, 500 and the full table; a window of 130,
    which leaves whole splits before it; and the model's q_pos, where row
    5's query sits 300 past its cache end, so with the window it keeps no
    key and attends uniformly to every row of its table (row 0, kv_len 0,
    does so with any window).  Each call against its plain version, two
    calls bit-equal, one launch counted a call, and B3 over the gathered
    cache against B2."""
    n_pages = 128
    kv_len = [0, SPLIT - 1, SPLIT, SPLIT + 1, n_pages * page, 500, 2 * SPLIT + 1, 1]
    q, kp, vp, table, kl = decode_case(30 + g, 8, 2, g, d, page, n_pages, kv_len)
    q_pos = np.maximum(np.asarray(kv_len) - 1, 0).astype(np.int32)
    q_pos[5] = kv_len[5] - 1 + 300
    tq, tkp, tvp, tt, tkl, tqp = [t.to(cuda) for t in as_torch(q, kp, vp, table, kl, q_pos)]
    tq, tkp, tvp = (t.to(dtype) for t in (tq, tkp, tvp))
    kc = ref.gather_pages(tkp, tt).contiguous()
    vc = ref.gather_pages(tvp, tt).contiguous()
    for qp, window in ((None, 0), (None, 130), (tqp, 0), (tqp, 130)):
        before = dict(ops.LAUNCHES)
        paged = ops.paged_decode_attention(tq, tkp, tvp, tt, tkl, window=window, q_pos=qp)
        again = ops.paged_decode_attention(tq, tkp, tvp, tt, tkl, window=window, q_pos=qp)
        dense = ops.decode_attention(tq, kc, vc, tkl, window=window, q_pos=qp)
        plain = ref.paged_decode_attention_ref(tq, tkp, tvp, tt, tkl, window=window, q_pos=qp)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["paged_decode_attention"] == before["paged_decode_attention"] + 2
        assert ops.LAUNCHES["decode_attention"] == before["decode_attention"] + 1
        torch.testing.assert_close(paged.float(), plain.float(), **CUDA_TOL[dtype])
        torch.testing.assert_close(dense.float(), plain.float(), **CUDA_TOL[dtype])
        torch.testing.assert_close(dense.float(), paged.float(), **CUDA_TOL[dtype])
        assert torch.equal(paged, again), "two calls on the same inputs differ"
        if qp is None:
            assert torch.all(paged[0] == 0) and torch.all(dense[0] == 0)


@pytest.mark.cuda
def test_cuda_split_decode_refuses_what_it_cannot_take(cuda):
    """A head dim the kernels are not compiled for, and q or a cache that
    does not start on a 16-byte boundary (each lane loads 16 bytes)."""
    q, kp, vp, table, kl = (t.to(cuda) for t in as_torch(*decode_case(40, 2, 2, 2, 64, 16, 2,
                                                                        [5, 20])))
    kc = ref.gather_pages(kp, table).contiguous()
    with pytest.raises(ValueError, match="head dims"):
        ops.paged_decode_attention(q[..., :48], kp[..., :48].contiguous(),
                                   vp[..., :48].contiguous(), table, kl)
    with pytest.raises(ValueError, match="16-byte"):
        shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)  # 4 bytes in
        ops.paged_decode_attention(shifted, kp, vp, table, kl)
    with pytest.raises(ValueError, match="16-byte"):
        ops.decode_attention(q, torch.empty(kc.numel() + 1, device=cuda)[1:].view(kc.shape),
                             kc, kl)


FLASH_CASES = [  # (t, s, causal, window, q_offset)
    (1, 1, True, 0, 0), (32, 32, True, 0, 0), (200, 200, True, 0, 0), (512, 512, True, 128, 0),
    (64, 320, True, 0, 256), (16, 64, True, 32, 128), (200, 77, False, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s,causal,window,q_offset", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda, dtype, t, s, causal, window, q_offset):
    """B4 at llama3.2-1b's heads (32 over 8, D 64), B = 2, against its plain
    version; the (16, 64, q_offset 128, window 32) case keeps no key for
    any row, so its output must be exactly zero."""
    rng = np.random.default_rng(13)
    q = rng.standard_normal((2, t, 32, 64)).astype(np.float32)
    k = rng.standard_normal((2, s, 8, 64)).astype(np.float32)
    v = rng.standard_normal((2, s, 8, 64)).astype(np.float32)
    tq, tk, tv = [x.to(cuda).to(dtype) for x in as_torch(q, k, v)]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention.LAUNCHES["flash_attention"]
    out = flash_attention.flash_attention(tq, tk, tv, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["flash_attention"] == before + 1
    plain = flash_attention.attention_ref(tq, tk, tv, **kw)
    torch.testing.assert_close(out.float(), plain.float(), **CUDA_TOL[dtype])
    if (t, s, window, q_offset) == (16, 64, 32, 128):
        assert torch.all(out == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,window", [(32, 0), (512, 0), (512, 128), (300, 16)])
def test_cuda_flash_attention_at_mixtral_heads_matches_plain(cuda, dtype, t, window):
    """B4 at mixtral-8x7b's heads (32 over 8, D 128: the instantiations
    that take 115,456 (f32) and 87,040 (bf16) bytes of shared memory),
    B = 1, causal, T = S."""
    rng = np.random.default_rng(15)
    q = rng.standard_normal((1, t, 32, 128)).astype(np.float32)
    k = rng.standard_normal((1, t, 8, 128)).astype(np.float32)
    v = rng.standard_normal((1, t, 8, 128)).astype(np.float32)
    tq, tk, tv = [x.to(cuda).to(dtype) for x in as_torch(q, k, v)]
    before = flash_attention.LAUNCHES["flash_attention"]
    out = flash_attention.flash_attention(tq, tk, tv, window=window)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["flash_attention"] == before + 1
    plain = flash_attention.attention_ref(tq, tk, tv, window=window)
    torch.testing.assert_close(out.float(), plain.float(), **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_at_mixtral_heads_matches_plain(cuda, dtype):
    """B2 over pages and B3 over a linear cache at mixtral-8x7b's heads
    (32 over 8, D 128), 8 rows of ragged lengths with an empty one."""
    q, kp, vp, table, kl = decode_case(16, 8, 8, 4, 128, 16, 8, [0, 128, 17, 1, 64, 100, 33, 127])
    args = [t.to(cuda) for t in as_torch(q, kp, vp, table, kl)]
    args[:3] = [t.to(dtype) for t in args[:3]]
    out = ops.paged_decode_attention(*args, window=40)
    plain = ref.paged_decode_attention_ref(*args, window=40)
    kc = ref.gather_pages(args[1], args[3]).contiguous()
    vc = ref.gather_pages(args[2], args[3]).contiguous()
    dense = ops.decode_attention(args[0], kc, vc, args[4], window=40)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain.float(), **CUDA_TOL[dtype])
    torch.testing.assert_close(dense.float(), plain.float(), **CUDA_TOL[dtype])
    assert torch.all(out[0] == 0) and torch.all(dense[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,window,limit", [(torch.float32, 64, 0, 1e-4),
                                                  (torch.bfloat16, 64, 64, 4e-3),
                                                  (torch.bfloat16, 128, 64, 4e-3)])
def test_cuda_flash_attention_rows_sum_to_one(cuda, dtype, d, window, limit):
    """v all ones: every row is 1 up to f32 sums, and in bf16 the output's
    rounding to 1's lower neighbour (2**-8 below it) at most."""
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.standard_normal((1, 300, 32, d)).astype(np.float32)).to(cuda)
    k = torch.from_numpy(rng.standard_normal((1, 300, 8, d)).astype(np.float32)).to(cuda)
    q, k = q.to(dtype), k.to(dtype)
    out = flash_attention.flash_attention(q, k, torch.ones_like(k), window=window)
    torch.cuda.synchronize()
    assert (out.float() - 1).abs().max().item() <= limit


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_it_cannot_take(cuda):
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    k = torch.zeros((1, 8, 2, 64), device=cuda)
    before = flash_attention.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention.flash_attention(q, k.half(), k)
    with pytest.raises(ValueError, match="head size"):
        flash_attention.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                        k[..., :48].contiguous())
    qb, kb = q.bfloat16(), k.bfloat16()
    shifted = torch.zeros(qb.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(qb.shape)
    with pytest.raises(ValueError, match="aligned"):  # contiguous, 2 bytes off
        flash_attention.flash_attention(shifted, kb, kb)
    assert flash_attention.LAUNCHES["flash_attention"] == before


# B4's bfloat16 instantiation (tensor cores) at every head size, with one,
# two (the SMOKE configs), four (llama3.2-1b and mixtral-8x7b FULL) and
# eight query heads a KV head, ragged lengths (none a multiple of 16 or
# 64), a chunk at an offset, a window, a chunk whose every row is masked
# (exactly 0) and a non-causal case.
BF16_FLASH_CASES = [  # (t, s, causal, window, q_offset)
    (1, 1, True, 0, 0), (17, 17, True, 0, 0), (200, 200, True, 0, 0), (513, 513, True, 0, 0),
    (200, 513, True, 0, 313), (17, 200, True, 64, 183), (513, 513, True, 100, 0),
    (16, 64, True, 32, 128), (513, 200, False, 0, 0)]


def flash_case(seed, t, s, hkv, g, d, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, t, hkv * g, d)).astype(np.float32) * q_scale
    k = rng.standard_normal((1, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((1, s, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("t,s,causal,window,q_offset", BF16_FLASH_CASES)
def test_cuda_flash_attention_bf16_tensor_cores_match_plain(cuda, d, g, t, s, causal, window,
                                                            q_offset):
    tq, tk, tv = [x.to(cuda).to(torch.bfloat16) for x in as_torch(*flash_case(21, t, s, 2, g, d))]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    plain = flash_attention.attention_ref(tq, tk, tv, **kw)
    before = flash_attention.LAUNCHES["flash_attention"]
    out = flash_attention.flash_attention(tq, tk, tv, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), plain.float(), **CUDA_TOL[torch.bfloat16])
    if (t, s, window, q_offset) == (16, 64, 32, 128):
        assert torch.all(out == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [0, 100])
def test_cuda_flash_attention_bf16_large_scores(cuda, d, window):
    """q scaled by 8: scores of about 8 sqrt(D) / sqrt(D) * N(0, 1) spread
    over tens of units, so the running max moves often and most weights
    underflow; still within the bf16 tolerance."""
    q, k, v = flash_case(22, 513, 513, 8, 4, d, q_scale=8.0)
    tq, tk, tv = [x.to(cuda).to(torch.bfloat16) for x in as_torch(q, k, v)]
    out = flash_attention.flash_attention(tq, tk, tv, window=window)
    plain = flash_attention.attention_ref(tq, tk, tv, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain.float(), **CUDA_TOL[torch.bfloat16])


# C1 on the card: idle slots' cache positions run on as the reference's.
# The CPU tests hold the port's tokens to the reference's on these inputs
# (tests/test_torch_serving.py); here the card's kernel path must serve the
# same tokens as the CPU's plain path on one seeded set of weights.
C1_GROUPS = {
    "dense": (dict(slots=2), [[([7, 8, 9], 12), ([4, 5, 6, 1, 2], 6)],
                              [([3, 1], 12)], [([2, 2, 5], 12)], [([9], 12)]]),
    "paged": (dict(slots=3, paged=PagedSpec(num_pages=13, page_size=4)),
              [[([31, 143, 255, 248, 59], 12), ([383, 492, 47, 371, 150], 5),
                ([141, 371, 82, 165, 496], 4)],
               [([149, 59], 12)], [([319, 233], 12)], [([185, 313, 395], 12)]]),
}


def serve_in_turn(device, kind):
    """mixtral SMOKE at f32 and capacity factor 1.25, max_len 16: each
    group served to the end before the next.  Returns the outputs and the
    slots' final cache positions."""
    kw, groups = C1_GROUPS[kind]
    cfg = get_arch("mixtral-8x7b", smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    model = build_model(cfg, compute_dtype=torch.float32, device=device)
    params = model.init(torch.Generator().manual_seed(0))
    b = ContinuousBatcher(model, params, max_len=16, **kw)
    outputs = []
    for group in groups:
        reqs = [Request(prompt=list(p), max_new_tokens=n) for p, n in group]
        for r in reqs:
            b.submit(r)
        b.run_until_drained()
        outputs += [r.output for r in reqs]
    return outputs, b._cache_pos.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_cuda_idle_slot_positions_run_on_as_on_the_cpu(cuda, kind):
    ops.reset_launches()
    card = serve_in_turn(cuda, kind)
    decode = "decode_attention" if kind == "dense" else "paged_decode_attention"
    assert ops.LAUNCHES[decode] > 0
    assert card == serve_in_turn("cpu", kind)
    assert min(card[1][1:]) > 16, "the idle slots ran past their cache"


class OutputDtypes(TorchDispatchMode):
    """Records the dtype and shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        result = func(*args, **(kwargs or {}))
        for t in result if isinstance(result, (tuple, list)) else (result,):
            if isinstance(t, torch.Tensor):
                self.seen.append((t.dtype, tuple(t.shape)))
        return result


@pytest.mark.cuda
def test_cuda_bf16_unembed_sums_in_f32(cuda):
    """C2 on the card: llama3.2-1b SMOKE's tied unembed on bf16 operands
    (the CPU test's draws) gives f32 logits with no bf16 logits tensor on
    the way, equal to the f32 product of the widened operands to f32
    accumulation (64 exact products: atol 1e-5, as on the CPU)."""
    cfg = get_arch("llama3.2-1b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        x = torch.randn((1, 16, 64), generator=gen, dtype=torch.bfloat16)
        tok = 0.02 * torch.randn((512, 64), generator=gen, dtype=torch.bfloat16)
        with OutputDtypes() as rec:
            got = unembed({"tok": tok.to(cuda)}, x.to(cuda), cfg)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (1, 16, 512)
        # no bf16 tensor of 16 rows x 512 logits (the table's views are 64 x 512)
        assert not [s for dt, s in rec.seen
                    if dt == torch.bfloat16 and s[-1] == 512 and np.prod(s[:-1]) == 16]
        torch.testing.assert_close(got.cpu(), x.float() @ tok.float().t(), rtol=0, atol=1e-5)


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


# B7 and its plain version sum d2 in one fixed order with one rounding per
# operation (ref.py), so d2 is bit-equal and the indices equal: no tolerance.
TCMM_CASES = [(512, 64, 4, 64), (1024, 512, 8, 100), (256, 16, 128, 16), (512, 128, 4, 1),
              (4096, 512, 4, 512), (1, 512, 4, 512), (1, 512, 4, 300), (1, 512, 4, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,f,n_valid", TCMM_CASES)
def test_cuda_tcmm_assign_equals_plain_bit_for_bit(cuda, n, m, f, n_valid, dtype):
    rng = np.random.default_rng(10)
    pts = (rng.standard_normal((n, f)) * 3).astype(np.float32)
    cents = (rng.standard_normal((m, f)) * 3).astype(np.float32)
    tp, tc = [t.to(cuda).to(dtype) for t in as_torch(pts, cents)]
    valid = (torch.arange(m) < n_valid).to(cuda)
    before = tcmm_assign.LAUNCHES["tcmm_assign"]
    idx, d2 = tcmm_assign.tcmm_assign(tp, tc, valid)
    torch.cuda.synchronize()
    assert tcmm_assign.LAUNCHES["tcmm_assign"] == before + 1
    want_idx, want_d2 = tcmm_assign.tcmm_assign_ref(tp, tc, valid)
    assert torch.equal(idx, want_idx) and torch.equal(d2, want_d2)
    if n_valid == 0:
        assert (idx == 0).all() and torch.isinf(d2).all()
    else:
        assert (idx < n_valid).all()


@pytest.mark.cuda
def test_cuda_tcmm_assign_point_on_a_centroid_maps_to_it(cuda):
    cents = torch.from_numpy(
        (np.random.default_rng(11).standard_normal((32, 4)) * 5).astype(np.float32)).to(cuda)
    idx, d2 = tcmm_assign.tcmm_assign(cents[7].repeat(64, 1), cents,
                                      torch.ones(32, dtype=torch.bool, device=cuda))
    torch.cuda.synchronize()
    assert (idx == 7).all() and (d2.abs() <= 1e-4).all()


# B5 repeats its plain version's arithmetic operation for operation (ref.py),
# so indices, positions and keep are exact; gates to the reference test's
# rtol 1e-5 / atol 1e-6 (tests/test_kernels.py::test_moe_gating_matches_ref).
MOE_CASES = ([(n, 8, 2, cap, bn) for n in (16, 512, 2048)
              for cap in (int(n * 2 * 1.25 / 8), n * 2) for bn in (n, 256, 64)]
             + [(512, 16, 2, 80, 128), (256, 128, 1, 4, 128), (100, 8, 2, 20, 32)])


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,k,cap,block_n", MOE_CASES)
def test_cuda_moe_gating_matches_plain(cuda, n, e, k, cap, block_n):
    logits = torch.from_numpy(
        np.random.default_rng(17).standard_normal((n, e)).astype(np.float32)).to(cuda)
    before = moe_gating.LAUNCHES["moe_gating"]
    got = moe_gating.moe_gating(logits, k, cap, block_n=block_n)
    torch.cuda.synchronize()
    assert moe_gating.LAUNCHES["moe_gating"] == before + 1
    bn = moe_gating.ops.block_size(n, block_n)
    want = moe_gating.moe_gating_ref(logits, k, cap, block_n=bn)
    for name, g, w in zip(("idx", "pos", "keep"), got[::2] + got[3:], want[::2] + want[3:]):
        assert torch.equal(g, w), name
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_moe_gating_ties_go_to_the_lowest_index(cuda):
    rows = [[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0], [0.5, -1.0, 0.5, 0.5],
            [-4.0, 7.0, -4.0, 7.0]]
    logits = torch.tensor(rows * 64, device=cuda)
    idx, gates, pos, keep = moe_gating.moe_gating(logits, 2, 40, block_n=64)
    torch.cuda.synchronize()
    assert idx[:4].tolist() == [[1, 2], [0, 1], [0, 2], [1, 3]]
    want = moe_gating.moe_gating_ref(logits, 2, 40, block_n=64)
    assert torch.equal(idx, want[0]) and torch.equal(pos, want[2]) and torch.equal(keep, want[3])


@pytest.mark.cuda
def test_cuda_moe_gating_refuses_what_it_cannot_take(cuda):
    before = moe_gating.LAUNCHES["moe_gating"]
    with pytest.raises(TypeError, match="float32"):
        moe_gating.moe_gating(torch.zeros((4, 8), device=cuda, dtype=torch.bfloat16), 2, 8)
    with pytest.raises(ValueError, match="E <= 128"):
        moe_gating.moe_gating(torch.zeros((4, 256), device=cuda), 2, 8)
    with pytest.raises(ValueError, match="contiguous"):
        moe_gating.moe_gating(torch.zeros((8, 4), device=cuda).t(), 2, 8)
    assert moe_gating.LAUNCHES["moe_gating"] == before
