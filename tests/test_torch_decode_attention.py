"""The port's decode kernels (``repro_torch.kernels.decode_attention``),
paged and dense, against the reference package's Pallas kernels, run in
interpret mode on the CPU, and its oracles: on the CPU the port's
wrappers run their plain PyTorch versions (``test_torch_cuda_kernels.py``
holds the CUDA kernels against those on the card)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as jax_decode,
    paged_decode_attention as jax_paged_decode,
    paged_kv_append as jax_paged_append,
)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as jax_decode_ref,
    paged_decode_attention_ref as jax_paged_decode_ref,
    paged_kv_append_ref as jax_paged_append_ref,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import gather_pages, ops  # noqa: E402

# f32 on both sides: the same tolerance as the reference's kernel tests;
# bf16 as theirs too (tests/test_kernels.py:33).
TOL = dict(rtol=1e-5, atol=1e-5)
TOLS = {"float32": TOL, "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def decode_case(seed, b, hkv, g, d, page, n_pages, kv_len):
    """Pools of 1 + b*n_pages pages, each sequence owning n_pages of them
    in shuffled order; a sequence with kv_len 0 keeps an all-zero (idle)
    table row, as an empty batcher slot does."""
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


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("g", [1, 4])
def test_paged_decode_attention_matches_reference(g, page, window):
    n_pages = 3
    full = n_pages * page
    # ragged: empty slot, full slot, one past a page boundary, partial page
    kv_len = [0, full, page + 1, 3]
    q, kp, vp, table, kl = decode_case(0, 4, 2, g, 16, page, n_pages, kv_len)
    out = ops.paged_decode_attention(*as_torch(q, kp, vp, table, kl), window=window)
    assert out.dtype == torch.float32 and out.shape == q.shape
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, kl)]
    pallas = np.asarray(jax_paged_decode(*jargs, window=window))  # interpret on CPU
    oracle = np.asarray(jax_paged_decode_ref(*jargs, window=window))
    np.testing.assert_allclose(out.numpy(), pallas, **TOL)
    np.testing.assert_allclose(out.numpy(), oracle, **TOL)
    assert np.all(out.numpy()[0] == 0.0), "kv_len == 0 must give exactly zero"


@pytest.mark.parametrize("page", [4, 16])
def test_paged_kv_append_matches_reference(page):
    b, hkv, d, n_pages = 4, 2, 16, 3
    _, kp, vp, table, _ = decode_case(1, b, hkv, 1, d, page, n_pages, [5, 5, 5, 5])
    rng = np.random.default_rng(2)
    k_new = rng.standard_normal((b, hkv, d)).astype(np.float32)
    v_new = rng.standard_normal((b, hkv, d)).astype(np.float32)
    # first row of a page, last row of the last page, mid-page, and an
    # idle slot (all-zero table row) that lands in scratch page 0
    pos = np.array([page, n_pages * page - 1, 2, 7], dtype=np.int32)
    table[3] = 0
    tk, tv, tkp, tvp, tt, tpos = as_torch(k_new, v_new, kp, vp, table, pos)
    out_k, out_v = ops.paged_kv_append(tk, tv, tkp, tvp, tt, tpos)
    assert out_k is tkp and out_v is tvp, "the append is in place"
    jargs = [jnp.asarray(a) for a in (k_new, v_new, kp, vp, table, pos)]
    for jk, jv in (jax_paged_append(*jargs), jax_paged_append_ref(*jargs)):
        # page 0 is scratch: idle slots may race on it, so it is never compared
        np.testing.assert_array_equal(out_k.numpy()[1:], np.asarray(jk)[1:])
        np.testing.assert_array_equal(out_v.numpy()[1:], np.asarray(jv)[1:])
    untouched = np.ones(kp.shape[:2], dtype=bool)
    for i in range(3):
        untouched[table[i, pos[i] // page], pos[i] % page] = False
    untouched[0] = False
    np.testing.assert_array_equal(out_k.numpy()[untouched], kp[untouched])


def test_paged_kv_append_row_named_twice_takes_the_last_slot():
    """Idle slots (all-zero table rows) at one position name the same row
    of scratch page 0, and a live page's row may be named twice too: the
    last slot's row lands, as the reference oracle's indexed update leaves
    it, page 0 included."""
    b, hkv, d, page, n_pages = 5, 2, 8, 4, 2
    _, kp, vp, table, _ = decode_case(4, b, hkv, 1, d, page, n_pages, [3] * b)
    table[[1, 2, 4]] = 0  # three idle slots
    table[3] = table[0]   # slot 3 shares slot 0's pages
    pos = np.array([5, 2, 2, 5, 2], dtype=np.int32)  # 1, 2, 4 on page 0 row 2; 0, 3 one row
    rng = np.random.default_rng(5)
    k_new = rng.standard_normal((b, hkv, d)).astype(np.float32)
    v_new = rng.standard_normal((b, hkv, d)).astype(np.float32)
    out_k, out_v = ops.paged_kv_append(*as_torch(k_new, v_new, kp, vp, table, pos))
    jk, jv = jax_paged_append_ref(*[jnp.asarray(a) for a in (k_new, v_new, kp, vp, table, pos)])
    np.testing.assert_array_equal(out_k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(out_v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(out_k.numpy()[0, 2], k_new[4])
    np.testing.assert_array_equal(out_v.numpy()[table[0, 1], 1], v_new[3])


def masked_attention_np(q, k, v, kv_len, q_pos, window):
    """The model's plain attention for one query per row (numpy, f64):
    keys p < kv_len, p <= q_pos, p > q_pos - window; a row with no key
    left gives equal weight to every row, as a softmax over -1e30 does."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    out = np.zeros((b, h, d))
    for i in range(b):
        p = np.arange(s)
        keep = (p < kv_len[i]) & (p <= q_pos[i])
        if window > 0:
            keep &= p > q_pos[i] - window
        for j in range(h):
            kv = j // (h // hkv)
            w = np.ones(s)
            if keep.any():
                scores = k[i, :, kv].astype(np.float64) @ q[i, j] / np.sqrt(d)
                scores = np.where(keep, scores, -np.inf)
                w = np.exp(scores - scores.max())
            out[i, j] = (w / w.sum()) @ v[i, :, kv]
    return out


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_masks_at_the_query_position(window):
    """With ``q_pos`` both decode kernels' plain versions mask as the
    model's plain attention does: causal at q_pos (an idle batcher slot's
    position need not be kv_len - 1), and a row with no key left attends
    uniformly to every row (rows 2 and 3 under the window).  At q_pos =
    kv_len - 1 it is the kernels' own contract."""
    b, hkv, g, d, page, n_pages = 5, 2, 2, 8, 4, 3
    kv_len = np.array([7, 9, 3, 1, 12], dtype=np.int32)
    q_pos = np.array([6, 4, 30, 20, 11], dtype=np.int32)
    q, kp, vp, table, _ = decode_case(6, b, hkv, g, d, page, n_pages, kv_len)
    kd, vd = (gather_pages(torch.from_numpy(x), torch.from_numpy(table)).numpy()
              for x in (kp, vp))
    want = masked_attention_np(q, kd, vd, kv_len, q_pos, window)
    tq, tkp, tvp, tt, tkl, tqp = as_torch(q, kp, vp, table, kv_len, q_pos)
    paged = ops.paged_decode_attention(tq, tkp, tvp, tt, tkl, window=window, q_pos=tqp)
    dense = ops.decode_attention(tq, *as_torch(kd, vd), tkl, window=window, q_pos=tqp)
    np.testing.assert_allclose(paged.numpy(), want, **TOL)
    np.testing.assert_allclose(dense.numpy(), want, **TOL)
    at_end = ops.paged_decode_attention(tq, tkp, tvp, tt, tkl, window=window, q_pos=tkl - 1)
    np.testing.assert_array_equal(
        at_end.numpy(), ops.paged_decode_attention(tq, tkp, tvp, tt, tkl, window=window).numpy())


def _decode_args(**override):
    q, kp, vp, table, kl = decode_case(3, 2, 2, 2, 8, 4, 2, [3, 8])
    args = dict(q=q, k_pages=kp, v_pages=vp, page_table=table, kv_len=kl)
    args.update(override)
    return args


def _append_args(**override):
    _, kp, vp, table, _ = decode_case(4, 2, 2, 1, 8, 4, 2, [3, 8])
    new = np.ones((2, 2, 8), dtype=np.float32)
    args = dict(k_new=new, v_new=new, k_pages=kp, v_pages=vp, page_table=table,
                pos=np.array([0, 7], dtype=np.int32))
    args.update(override)
    return args


BAD_TABLE = np.array([[1, 2], [3, 5]], np.int32)  # page 5 of a 5-page pool
INVALID = {
    "float_kv_len": ("decode", dict(kv_len=np.array([3.0, 8.0], np.float32)), TypeError),
    "float_page_table": ("decode", dict(page_table=np.ones((2, 2), np.float32)), TypeError),
    "kv_len_past_cache": ("decode", dict(kv_len=np.array([3, 9], np.int32)), ValueError),
    "negative_kv_len": ("decode", dict(kv_len=np.array([-1, 8], np.int32)), ValueError),
    "page_id_past_pool": ("decode", dict(page_table=BAD_TABLE), ValueError),
    "float_pos": ("append", dict(pos=np.array([0.0, 1.0], np.float32)), TypeError),
    "pos_past_cache": ("append", dict(pos=np.array([0, 8], np.int32)), ValueError),
    "append_page_id_past_pool": ("append", dict(page_table=BAD_TABLE), ValueError),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_validation_errors_match_reference(case):
    kind, override, err = INVALID[case]
    if kind == "decode":
        args = _decode_args(**override)
        port_fn, jax_fn = ops.paged_decode_attention, jax_paged_decode
    else:
        args = _append_args(**override)
        port_fn, jax_fn = ops.paged_kv_append, jax_paged_append
    with pytest.raises(err):
        jax_fn(**{k: jnp.asarray(v) for k, v in args.items()})
    with pytest.raises(err):
        port_fn(**{k: torch.from_numpy(np.array(v)) for k, v in args.items()})


def test_wrappers_refuse_devices_they_cannot_serve():
    """No silent fallback: a tensor neither on the CPU nor on CUDA, or
    operands split across devices, raise instead of being copied."""
    args = {k: torch.from_numpy(np.array(v)) for k, v in _decode_args().items()}
    with pytest.raises(ValueError, match="unsupported device"):
        ops.paged_decode_attention(**{k: v.to("meta") for k, v in args.items()})
    args["q"] = args["q"].to("meta")
    with pytest.raises(ValueError, match="different devices"):
        ops.paged_decode_attention(**args)


def test_missing_compiler_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "NVCC_CANDIDATES", ("no-such-nvcc",))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("paged_decode_attention", ops.SIGNATURES["paged_decode_attention"])
    assert build._loaded == {}


def test_plain_path_counts_no_launch():
    ops.reset_launches()
    ops.paged_decode_attention(*as_torch(*decode_case(5, 2, 2, 2, 8, 4, 2, [3, 8])))
    ops.decode_attention(*as_torch(*dense_case(5, 2, 16, 2, 2, 8, [3, 16])))
    assert ops.LAUNCHES == {"paged_kv_append": 0, "paged_decode_attention": 0,
                            "decode_attention": 0}


# --- the dense decode kernel (B3) -------------------------------------------------


def dense_case(seed, b, s, hkv, g, d, kv_len):
    """q [b, hkv*g, d] and a linear cache [b, s, hkv, d], N(0, 1), with
    the given valid lengths."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, kc, vc, np.asarray(kv_len, dtype=np.int32)


def both_dense(q, kc, vc, kl, dtype="float32", **kw):
    """(port, Pallas in interpret mode, reference oracle) on the same
    inputs, each rounded to ``dtype`` first; outputs as f32 numpy."""
    port = ops.decode_attention(*[t.to(getattr(torch, dtype)) for t in as_torch(q, kc, vc)],
                                torch.from_numpy(kl), **kw)
    jargs = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in (q, kc, vc)]
    pallas = jax_decode(*jargs, jnp.asarray(kl), block_k=128, interpret=True, **kw)
    oracle = jax_decode_ref(*jargs, jnp.asarray(kl), **kw)
    assert port.dtype == getattr(torch, dtype) and port.shape == q.shape
    return (port.float().numpy(), np.asarray(pallas, dtype=np.float32),
            np.asarray(oracle, dtype=np.float32))


# tests/test_kernels.py:127-135: (b, s, h, hkv, d, window)
DENSE_CASES = [(2, 256, 8, 2, 64, 0), (1, 512, 4, 1, 128, 0), (4, 256, 8, 8, 64, 0),
               (2, 512, 8, 2, 64, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hkv,d,window", DENSE_CASES)
def test_dense_decode_attention_matches_reference(b, s, h, hkv, d, window, dtype):
    rng = np.random.default_rng(2)
    kv_len = rng.integers(1, s + 1, size=b)
    port, pallas, oracle = both_dense(*dense_case(20, b, s, hkv, h // hkv, d, kv_len),
                                      dtype=dtype, window=window)
    np.testing.assert_allclose(port, pallas, **TOLS[dtype])
    np.testing.assert_allclose(port, oracle, **TOLS[dtype])


def test_dense_decode_kv_len_zero_emits_zero():
    """A fresh slot attends to nothing: exactly zero, as the kernel's
    running softmax leaves it (tests/test_kernels.py:170)."""
    port, pallas, oracle = both_dense(*dense_case(21, 3, 256, 4, 1, 64, [0, 17, 0]))
    for out in (port, pallas, oracle):
        assert np.all(out[0] == 0.0) and np.all(out[2] == 0.0)
    assert np.abs(port[1]).max() > 0
    np.testing.assert_allclose(port, pallas, **TOL)
    np.testing.assert_allclose(port, oracle, **TOL)


@pytest.mark.parametrize("window", [0, 100])
def test_dense_decode_full_cache(window):
    """kv_len == S on every row: no off-by-one at the cache's end."""
    port, pallas, oracle = both_dense(*dense_case(22, 2, 256, 4, 1, 64, [256, 256]),
                                      window=window)
    np.testing.assert_allclose(port, pallas, **TOL)
    np.testing.assert_allclose(port, oracle, **TOL)


@pytest.mark.parametrize("s,window", [(200, 0), (1000, 0), (200, 37)])
def test_dense_decode_s_not_a_multiple_of_128(s, window):
    """The TPU wrapper falls back to a divisor of S as its block
    (align_block_k); the port takes any S, ragged lengths included."""
    kv_len = [0, 1, s // 3, s - 1, s]
    port, pallas, oracle = both_dense(*dense_case(23, 5, s, 2, 4, 32, kv_len), window=window)
    np.testing.assert_allclose(port, pallas, **TOL)
    np.testing.assert_allclose(port, oracle, **TOL)


DENSE_INVALID = {
    "float_kv_len": (np.array([4.0, 8.0], np.float32), TypeError),
    "kv_len_past_cache": (np.array([4, 129], np.int32), ValueError),
    "negative_kv_len": (np.array([-1, 4], np.int32), ValueError),
}


@pytest.mark.parametrize("case", sorted(DENSE_INVALID))
def test_dense_validation_errors_match_reference(case):
    """tests/test_kernels.py:196-211: the same inputs, the same errors."""
    kv_len, err = DENSE_INVALID[case]
    q, kc, vc, _ = dense_case(24, 2, 128, 2, 1, 64, [4, 8])
    args = dict(q=q, k_cache=kc, v_cache=vc, kv_len=kv_len)
    with pytest.raises(err):
        jax_decode(**{k: jnp.asarray(v) for k, v in args.items()}, interpret=True)
    with pytest.raises(err):
        ops.decode_attention(**{k: torch.from_numpy(np.array(v)) for k, v in args.items()})


@pytest.mark.parametrize("kv_len,window", [([32, 9, 0], 0), ([32, 17, 8], 6)])
def test_dense_decode_matches_paged_over_gathered_pages(kv_len, window):
    """tests/test_kernels.py:238: the dense wrapper over the gathered view
    of a shuffled pool equals the paged wrapper over the pool."""
    b, g, d, page, n = 3, 2, 64, 8, 4
    q, kp, vp, table, kl = decode_case(25, b, 2, g, d, page, n, kv_len)
    tq, tkp, tvp, tt, tkl = as_torch(q, kp, vp, table, kl)
    paged = ops.paged_decode_attention(tq, tkp, tvp, tt, tkl, window=window)
    dense = ops.decode_attention(tq, gather_pages(tkp, tt), gather_pages(tvp, tt), tkl,
                                 window=window)
    np.testing.assert_allclose(dense.numpy(), paged.numpy(), **TOL)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, kl)]
    np.testing.assert_allclose(dense.numpy(),
                               np.asarray(jax_paged_decode(*jargs, window=window)), **TOL)


def test_dense_wrapper_refuses_devices_it_cannot_serve():
    q, kc, vc, kl = as_torch(*dense_case(26, 2, 16, 2, 2, 8, [3, 16]))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.decode_attention(q.to("meta"), kc.to("meta"), vc.to("meta"), kl.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        ops.decode_attention(q.to("meta"), kc, vc, kl)
