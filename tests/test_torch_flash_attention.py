"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference package's Pallas kernel, run in interpret mode on
the CPU, and its oracle ``attention_ref``: on the CPU the port's wrapper
runs its plain PyTorch version (``test_torch_cuda_kernels.py`` holds the
CUDA kernel against it on the card).  Inputs are N(0, 1) from a seeded
numpy generator, rounded to the dtype under test on both sides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

# the reference's kernel-test tolerances (tests/test_kernels.py:33)
TOLS = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def qkv(seed, b, t, s, h, hkv, d, ones_v=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = (np.ones((b, s, hkv, d), np.float32) if ones_v
         else rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    return q, k, v


def port(q, k, v, dtype="float32", **kw):
    tq, tk, tv = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    out = ops.flash_attention(tq, tk, tv, **kw)
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == q.shape
    return out.float().numpy()


def reference(q, k, v, dtype="float32", pallas=True, **kw):
    """The Pallas kernel in interpret mode (tiles of 64, so T and S must
    be multiples of 64) or, with ``pallas=False``, the oracle."""
    jq, jk, jv = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in (q, k, v)]
    if pallas:
        out = jax_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True, **kw)
    else:
        out = jax_attention_ref(jq, jk, jv, **kw)
    return np.asarray(out, dtype=np.float32)


# tests/test_kernels.py:42-50: (b, t, h, hkv, d, causal, window), T = S
CASES = [
    (1, 128, 4, 4, 64, True, 0),     # MHA causal
    (2, 256, 8, 2, 64, True, 0),     # GQA
    (1, 256, 4, 1, 128, True, 64),   # sliding window, MQA
    (2, 128, 4, 2, 32, False, 0),    # bidirectional (encoder)
    (1, 512, 2, 2, 64, True, 128),   # longer seq + window
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,hkv,d,causal,window", CASES)
def test_flash_attention_matches_reference(b, t, h, hkv, d, causal, window, dtype):
    q, k, v = qkv(0, b, t, t, h, hkv, d)
    out = port(q, k, v, dtype, causal=causal, window=window)
    np.testing.assert_allclose(out, reference(q, k, v, dtype, causal=causal, window=window),
                               **TOLS[dtype])
    np.testing.assert_allclose(
        out, reference(q, k, v, dtype, pallas=False, causal=causal, window=window),
        **TOLS[dtype])


def test_flash_attention_q_offset_chunk():
    """A chunk of 64 queries at offset 192 into 256 keys
    (tests/test_kernels.py:67)."""
    q, k, v = qkv(1, 1, 64, 256, 2, 2, 64)
    out = port(q, k, v, q_offset=192)
    np.testing.assert_allclose(out, reference(q, k, v, q_offset=192), **TOLS["float32"])
    np.testing.assert_allclose(out, reference(q, k, v, pallas=False, q_offset=192),
                               **TOLS["float32"])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("t,h", [(128, 2), (256, 4)])
def test_flash_attention_rows_sum_to_one(t, h, seed):
    """With every value 1 each output is the sum of a row's weights: 1 to
    1e-4 (tests/test_kernels.py:83-106)."""
    out = port(*qkv(seed, 1, t, t, h, h, 64, ones_v=True), causal=True)
    np.testing.assert_allclose(out, 1.0, rtol=1e-4, atol=1e-4)


# (b, t, s, h, hkv, d, causal, window, q_offset): no tile multiples, so
# against the oracle only (the Pallas kernel asserts whole tiles)
RAGGED = [
    (1, 37, 37, 4, 2, 16, True, 0, 0),
    (2, 100, 100, 8, 2, 64, True, 17, 0),
    (1, 5, 70, 4, 1, 32, True, 0, 65),     # the last 5 positions of 70
    (2, 33, 90, 4, 4, 16, False, 0, 0),
    (1, 200, 200, 32, 8, 64, True, 0, 0),  # llama3.2-1b's heads
]


@pytest.mark.parametrize("b,t,s,h,hkv,d,causal,window,q_offset", RAGGED)
def test_flash_attention_ragged_lengths(b, t, s, h, hkv, d, causal, window, q_offset):
    q, k, v = qkv(3, b, t, s, h, hkv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_allclose(port(q, k, v, **kw), reference(q, k, v, pallas=False, **kw),
                               **TOLS["float32"])


def test_flash_attention_fully_masked_rows_are_zero():
    """Queries at 128..191 with a window of 32 over keys 0..63 keep no
    key: exactly zero, as the Pallas kernel gives.  (The oracle's bare
    softmax would give the mean of the values instead.)"""
    q, k, v = qkv(4, 1, 64, 64, 4, 2, 64)
    out = port(q, k, v, q_offset=128, window=32)
    assert np.all(out == 0.0)
    assert np.all(reference(q, k, v, q_offset=128, window=32) == 0.0)


def test_flash_attention_rows_before_the_first_key_are_zero():
    """q_offset -16: rows 0..15 sit before key 0 and are zero on both
    sides; the other rows agree with the oracle."""
    q, k, v = qkv(5, 1, 64, 64, 2, 2, 32)
    out = port(q, k, v, q_offset=-16)
    assert np.all(out[:, :16] == 0.0) and np.abs(out[:, 16:]).max() > 0
    np.testing.assert_allclose(out, reference(q, k, v, q_offset=-16), **TOLS["float32"])
    np.testing.assert_allclose(out[:, 16:],
                               reference(q, k, v, pallas=False, q_offset=-16)[:, 16:],
                               **TOLS["float32"])


INVALID = {
    "q_not_4d": (dict(q=(2, 8, 16)), {}),
    "k_v_shape_mismatch": (dict(v=(1, 8, 2, 8)), {}),
    "heads_not_a_multiple": (dict(q=(1, 8, 3, 16)), {}),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_validation_errors_match_reference(case):
    shapes = dict(q=(1, 8, 4, 16), k=(1, 8, 2, 16), v=(1, 8, 2, 16))
    shapes.update(INVALID[case][0])
    arrays = {n: np.zeros(sh, np.float32) for n, sh in shapes.items()}
    with pytest.raises(ValueError):
        jax_flash(**{n: jnp.asarray(a) for n, a in arrays.items()}, interpret=True)
    with pytest.raises(ValueError):
        ops.flash_attention(**{n: torch.from_numpy(a) for n, a in arrays.items()})


def test_plain_path_counts_no_launch():
    ops.reset_launches()
    port(*qkv(7, 1, 16, 16, 2, 2, 16))
    assert ops.LAUNCHES == {"flash_attention": 0}


def test_refuses_devices_it_cannot_serve():
    q, k, v = [torch.from_numpy(a) for a in qkv(8, 1, 8, 8, 2, 2, 16)]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        ops.flash_attention(q, k.to("meta"), v)


def test_cuda_request_without_a_card_raises(monkeypatch, tmp_path):
    """No card: a model asked for CUDA refuses to build, and the kernel
    cannot be built without nvcc; neither falls back to the CPU."""
    from repro_torch.config import get_arch
    from repro_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(get_arch("llama3.2-1b", smoke=True), device="cuda")
    monkeypatch.setattr(build, "NVCC_CANDIDATES", ("no-such-nvcc",))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("flash_attention", ops.SIGNATURES["flash_attention"])
