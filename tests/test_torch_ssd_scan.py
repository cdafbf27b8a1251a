"""The port's SSD chunked scan (``repro_torch.kernels.ssd_scan``) against
the reference package's three versions: the Pallas kernel in interpret
mode on the CPU, ``ssd_chunked_ref`` and ``ssd_sequential_ref``.  On the
CPU the port's wrapper runs its plain PyTorch version;
``test_torch_cuda_kernels.py`` holds the CUDA kernel against that on the
card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_ref as jax_chunked_ref,
    ssd_sequential_ref as jax_sequential_ref,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402

# f32 on both sides: the tolerance the reference's own SSD tests use
# (tests/test_kernels.py) and ROADMAP B6 names.
TOL = dict(rtol=2e-4, atol=2e-4)


def ssd_case(seed, b, t, h, p, n, decays="mid", state=False):
    """x, a, B, C (and a nonzero initial state) from a numpy seed.  Decays
    ``mid`` are sigmoid(N(0, 1)); ``near0`` lie in [1e-4, 1e-2] (the state
    forgets within a step or two); ``near1`` within 1e-2 of 1 (it forgets
    almost nothing across the whole sequence), with a few exact 1s, as
    the model's inert padding steps have."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    if decays == "mid":
        a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, h))))
    elif decays == "near0":
        a = 10.0 ** rng.uniform(-4, -2, size=(b, t, h))
    else:
        a = 1.0 - 10.0 ** rng.uniform(-6, -2, size=(b, t, h))
        a[:, -3:] = 1.0
    B = rng.standard_normal((b, t, n)).astype(np.float32)
    C = rng.standard_normal((b, t, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32) if state else None
    return x, a.astype(np.float32), B, C, s0


def as_torch(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


CASES = {
    # name: (b, t, h, p, n, chunk, decays, initial state)
    "b1_4chunks": (1, 64, 2, 16, 16, 16, "mid", False),
    "b2_3chunks_state": (2, 96, 3, 8, 32, 32, "mid", True),
    "b2_near0_state": (2, 64, 2, 16, 16, 16, "near0", True),
    "b1_near1": (1, 128, 2, 8, 16, 32, "near1", False),
    "b2_near1_state": (2, 64, 4, 8, 8, 16, "near1", True),
    "b1_one_chunk": (1, 32, 1, 16, 32, 32, "mid", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_scan_matches_all_three_reference_versions(case):
    b, t, h, p, n, chunk, decays, state = CASES[case]
    arrays = ssd_case(sorted(CASES).index(case), b, t, h, p, n, decays, state)
    x, a, B, C, s0 = arrays
    ops.reset_launches()
    y, s = ops.ssd_chunked(*as_torch(x, a, B, C), chunk, *as_torch(s0))
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == (b, t, h, p) and tuple(s.shape) == (b, h, n, p)
    assert ops.LAUNCHES == {"ssd_chunked": 0}, "the CPU path launches nothing"

    j = [None if v is None else jnp.asarray(v) for v in arrays]
    refs = {
        "pallas_interpret": jax_ssd_chunked(*j[:4], chunk, initial_state=j[4], interpret=True),
        "chunked_ref": jax_chunked_ref(*j[:4], chunk, initial_state=j[4]),
        "sequential_ref": jax_sequential_ref(*j[:4], initial_state=j[4]),
    }
    for name, (jy, js) in refs.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), err_msg=name, **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), err_msg=name, **TOL)


@pytest.mark.parametrize("state", [False, True])
def test_port_sequential_oracle_matches_reference(state):
    x, a, B, C, s0 = ssd_case(11, 2, 40, 2, 8, 16, "mid", state)
    y, s = ref.ssd_sequential_ref(*as_torch(x, a, B, C, s0))
    jy, js = jax_sequential_ref(*(jnp.asarray(v) for v in (x, a, B, C)),
                                initial_state=None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_bf16_b_and_c_are_read_as_f32():
    """The model hands the scan B and C in the activation dtype; the plain
    version computes in f32 from their bf16 values."""
    x, a, B, C, _ = ssd_case(3, 1, 32, 2, 8, 16)
    tx, ta, tB, tC = as_torch(x, a, B, C)
    y, s = ops.ssd_chunked(tx, ta, tB.bfloat16(), tC.bfloat16(), 16)
    y32, s32 = ops.ssd_chunked(tx, ta, tB.bfloat16().float(), tC.bfloat16().float(), 16)
    assert torch.equal(y, y32) and torch.equal(s, s32)


def test_ragged_length_raises_like_reference():
    x, a, B, C, _ = ssd_case(4, 1, 24, 2, 8, 8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        jax_ssd_chunked(*(jnp.asarray(v) for v in (x, a, B, C)), 16, interpret=True)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_chunked(*as_torch(x, a, B, C), 16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref.ssd_chunked_ref(*as_torch(x, a, B, C), 16)


@pytest.mark.parametrize("bad", ["a_shape", "bc_shape", "state_shape", "chunk"])
def test_wrapper_validates_shapes(bad):
    x, a, B, C, s0 = as_torch(*ssd_case(5, 1, 32, 2, 8, 16, state=True))
    chunk = 16
    if bad == "a_shape":
        a = a[:, :, :1]
    elif bad == "bc_shape":
        C = C[:, :, :4]
    elif bad == "state_shape":
        s0 = s0[:, :, :4]
    else:
        chunk = 0
    with pytest.raises(ValueError):
        ops.ssd_chunked(x, a, B, C, chunk, s0)


def test_wrapper_refuses_devices_it_cannot_serve():
    """No silent fallback: operands neither on the CPU nor on CUDA, or
    split across devices, raise instead of being copied."""
    x, a, B, C, _ = as_torch(*ssd_case(6, 1, 32, 2, 8, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ssd_chunked(*(t.to("meta") for t in (x, a, B, C)), 16)
    with pytest.raises(ValueError, match="different devices"):
        ops.ssd_chunked(x.to("meta"), a, B, C, 16)


def test_cuda_operand_checks_refuse_what_the_kernel_does_not_take():
    """The checks the wrapper runs before a launch: f32 x/a/state, B and C
    sharing f32 or bf16, contiguous operands."""
    x, a, B, C, s0 = as_torch(*ssd_case(7, 1, 32, 2, 8, 16, state=True))
    ops._check_cuda_operands(x, a, B.bfloat16(), C.bfloat16(), s0)
    with pytest.raises(TypeError, match="x must be float32"):
        ops._check_cuda_operands(x.bfloat16(), a, B, C, s0)
    with pytest.raises(TypeError, match="share"):
        ops._check_cuda_operands(x, a, B, C.bfloat16(), s0)
    with pytest.raises(ValueError, match="contiguous"):
        # C as the model's split of the conv output leaves it: a column view
        ops._check_cuda_operands(x, a, B, torch.cat([C, B], -1)[..., :8], s0)


def test_missing_compiler_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "NVCC_CANDIDATES", ("no-such-nvcc",))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("ssd_chunked", ops.SIGNATURES["ssd_chunked"])
    assert build._loaded == {}


def test_build_finds_every_kernel_source():
    assert set(build.sources()) == {"paged_kv_append", "paged_decode_attention",
                                    "decode_attention", "flash_attention",
                                    "ssd_chunked", "tcmm_assign", "moe_gating"}
    with pytest.raises(KeyError):
        build.build_all(["no_such_kernel"])
