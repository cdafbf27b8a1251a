"""The port's TCMM assignment (``repro_torch.kernels.tcmm_assign``) against
the reference package's Pallas kernel in interpret mode and its
``tcmm_assign_ref``, on the CPU.  Here the port's wrapper runs its plain
PyTorch version; ``test_torch_cuda_kernels.py`` holds the CUDA kernel
against that, bit for bit, on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.tcmm_assign.ops import tcmm_assign as jax_tcmm_assign  # noqa: E402
from repro.kernels.tcmm_assign.ref import tcmm_assign_ref as jax_tcmm_assign_ref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.tcmm_assign import ops, ref  # noqa: E402

# The reference's own tolerances (tests/test_kernels.py::test_tcmm_assign_matches_ref):
# f32 distances to 1e-4 with indices exact; bf16 inputs round on both sides
# in other orders, so distances to rtol 5e-2 / atol 5e-1 and indices only
# below n_valid.
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=5e-1)}
CASES = [(512, 64, 4, 64), (1024, 512, 8, 100), (256, 16, 128, 16), (512, 128, 4, 1)]


def assign_case(seed, n, m, f, n_valid):
    """Points and centroids N(0, 1) * 3 (as the reference test draws them),
    the first ``n_valid`` rows valid."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n, f)) * 3).astype(np.float32)
    cents = (rng.standard_normal((m, f)) * 3).astype(np.float32)
    return pts, cents, np.arange(m) < n_valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m,f,n_valid", CASES)
def test_port_assign_matches_pallas_kernel_and_oracle(n, m, f, n_valid, dtype):
    pts, cents, valid = assign_case(7, n, m, f, n_valid)
    jdt = getattr(jnp, dtype)
    j_args = (jnp.asarray(pts).astype(jdt), jnp.asarray(cents).astype(jdt), jnp.asarray(valid))
    idx_k, d_k = jax_tcmm_assign(*j_args, block_n=256, interpret=True)
    idx_r, d_r = jax_tcmm_assign_ref(*j_args)
    tdt = getattr(torch, dtype)
    idx, d2 = ops.tcmm_assign(torch.from_numpy(pts).to(tdt), torch.from_numpy(cents).to(tdt),
                              torch.from_numpy(valid))
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    assert idx.shape == d2.shape == (n,)
    for want_idx, want_d in ((idx_k, d_k), (idx_r, d_r)):
        np.testing.assert_allclose(d2.numpy(), np.asarray(want_d), **TOL[dtype])
        if dtype == "float32":
            np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert (idx.numpy() < n_valid).all()  # never picks invalid rows


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_point_equal_to_a_centroid_maps_to_it(seed):
    """64 copies of valid centroid 7 map to 7 with distance ~0 (the
    reference's exact-match property, at its atol)."""
    cents = (np.random.default_rng(seed).standard_normal((32, 4)) * 5).astype(np.float32)
    pts = np.tile(cents[7][None], (64, 1))
    idx, d2 = ops.tcmm_assign(torch.from_numpy(pts), torch.from_numpy(cents),
                              torch.ones(32, dtype=torch.bool))
    assert (idx == 7).all()
    np.testing.assert_allclose(d2.numpy(), 0.0, atol=1e-4)


def test_no_valid_row_gives_index_zero_and_inf_like_reference():
    pts, cents, _ = assign_case(3, 5, 16, 4, 0)
    valid = np.zeros(16, dtype=bool)
    idx, d2 = ops.tcmm_assign(torch.from_numpy(pts), torch.from_numpy(cents),
                              torch.from_numpy(valid))
    j_idx, j_d = jax_tcmm_assign_ref(jnp.asarray(pts), jnp.asarray(cents), jnp.asarray(valid))
    assert idx.tolist() == np.asarray(j_idx).tolist() == [0] * 5
    assert torch.isinf(d2).all() and np.isinf(np.asarray(j_d)).all()


def test_ties_go_to_the_first_index_like_reference():
    pts, cents, valid = assign_case(4, 16, 12, 4, 12)
    cents[9] = cents[2]  # two equal rows: row 2 must win
    cents[5] = cents[11]
    pts[:8] = cents[2] + 1e-3
    pts[8:] = cents[11]
    idx, _ = ops.tcmm_assign(*(torch.from_numpy(a) for a in (pts, cents, valid)))
    j_idx, _ = jax_tcmm_assign_ref(*(jnp.asarray(a) for a in (pts, cents, valid)))
    assert idx.tolist() == np.asarray(j_idx).tolist() == [2] * 8 + [5] * 8


def numpy_f32_emulation(pts, cents):
    """The order ``ref.py`` states, in numpy f32, one rounding per op."""
    f32 = np.float32
    pp = pts[:, 0] * pts[:, 0]
    cc = cents[:, 0] * cents[:, 0]
    cross = pts[:, None, 0] * cents[None, :, 0]
    for k in range(1, pts.shape[1]):
        pp = (pp + pts[:, k] * pts[:, k]).astype(f32)
        cc = (cc + cents[:, k] * cents[:, k]).astype(f32)
        cross = (cross + pts[:, None, k] * cents[None, :, k]).astype(f32)
    return (pp[:, None] - f32(2) * cross) + cc[None, :]


@pytest.mark.parametrize("f", [1, 4, 7, 128])
def test_plain_version_sums_in_the_stated_order(f):
    """The plain version's d2 equals a numpy f32 emulation of the stated
    order bit for bit; the CUDA kernel repeats the same order, so equal
    d2 (and indices) on the card is the same claim."""
    rng = np.random.default_rng(f)
    pts = (rng.standard_normal((33, f)) * 40).astype(np.float32)
    cents = (rng.standard_normal((70, f)) * 40).astype(np.float32)
    want = numpy_f32_emulation(pts, cents)
    assert want.dtype == np.float32
    got = ref.squared_distances(torch.from_numpy(pts), torch.from_numpy(cents))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    valid = rng.random(70) < 0.7
    idx, d2 = ref.tcmm_assign_ref(*(torch.from_numpy(a) for a in (pts, cents, valid)))
    masked = np.where(valid[None, :], want, np.inf)
    assert np.array_equal(idx.numpy(), masked.argmin(axis=1))
    assert np.array_equal(d2.numpy(), masked.min(axis=1))


@pytest.mark.parametrize("bad", ["f_mismatch", "valid_len", "valid_dtype", "no_rows",
                                 "int_points"])
def test_wrapper_validates_shapes(bad):
    pts, cents, valid = (torch.from_numpy(a) for a in assign_case(5, 8, 6, 4, 6))
    err = ValueError
    if bad == "f_mismatch":
        cents = cents[:, :3]
    elif bad == "valid_len":
        valid = valid[:5]
    elif bad == "valid_dtype":
        valid = valid.to(torch.int32)
    elif bad == "no_rows":
        cents, valid = cents[:0], valid[:0]
    else:
        pts, err = pts.to(torch.int32), TypeError
    with pytest.raises(err):
        ops.tcmm_assign(pts, cents, valid)


def test_wrapper_refuses_devices_it_cannot_serve():
    """No silent fallback: operands neither on the CPU nor on CUDA, or
    split across devices, raise instead of being copied."""
    pts, cents, valid = (torch.from_numpy(a) for a in assign_case(6, 8, 6, 4, 6))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.tcmm_assign(*(t.to("meta") for t in (pts, cents, valid)))
    with pytest.raises(ValueError, match="different devices"):
        ops.tcmm_assign(pts.to("meta"), cents, valid)


def test_cuda_operand_checks_refuse_what_the_kernel_does_not_take():
    """The checks the wrapper runs before a launch: points and centroids
    sharing f32 or bf16, F within the tile, contiguous operands."""
    pts, cents, valid = (torch.from_numpy(a) for a in assign_case(8, 8, 6, 4, 6))
    ops._check_cuda_operands(pts.bfloat16(), cents.bfloat16(), valid)
    with pytest.raises(TypeError, match="share"):
        ops._check_cuda_operands(pts, cents.bfloat16(), valid)
    with pytest.raises(TypeError, match="share"):
        ops._check_cuda_operands(pts.double(), cents.double(), valid)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_cuda_operands(pts, cents.T.contiguous().T, valid)
    wide = torch.zeros((1, ops.MAX_FEATURES + 1))
    with pytest.raises(ValueError, match="exceeds"):
        ops._check_cuda_operands(wide, wide, torch.ones(1, dtype=torch.bool))


def test_plain_path_counts_no_launch():
    ops.reset_launches()
    ops.tcmm_assign(*(torch.from_numpy(a) for a in assign_case(9, 4, 8, 4, 8)))
    assert ops.LAUNCHES == {"tcmm_assign": 0}


def test_missing_compiler_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "NVCC_CANDIDATES", ("no-such-nvcc",))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("tcmm_assign", ops.SIGNATURES["tcmm_assign"])
    assert build._loaded == {}
