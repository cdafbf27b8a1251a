"""The port's fused MoE gating (``repro_torch.kernels.moe_gating``, B5)
against the reference package's Pallas kernel in interpret mode and its
``moe_gating_ref``, on the CPU.  Here the port's wrapper runs its plain
PyTorch version; ``test_torch_cuda_kernels.py`` holds the CUDA kernel
against that on the card (it skips here)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gating.ops import moe_gating as jax_moe_gating  # noqa: E402
from repro.kernels.moe_gating.ref import moe_gating_ref as jax_moe_gating_ref  # noqa: E402
from repro_torch.kernels.moe_gating import LAUNCHES, moe_gating, moe_gating_ref  # noqa: E402
from repro_torch.kernels.moe_gating.ops import block_size  # noqa: E402

# The reference's own tolerances (tests/test_kernels.py::test_moe_gating_matches_ref):
# indices, positions and keep exact, gates to rtol 1e-5 / atol 1e-6.
GATE_TOL = dict(rtol=1e-5, atol=1e-6)
CASES = [  # (n, e, k, capacity, block_n)
    (256, 8, 2, 48, 128),    # contended capacity
    (512, 8, 2, 1024, 256),  # dropless
    (256, 128, 1, 4, 128),   # llama4-style: 128 experts top-1
    (128, 16, 2, 24, 128),   # jamba-style
    (512, 4, 2, 128, 64),    # small E, many blocks
    (96, 8, 2, 20, 256),     # block_n >= N: one block
    (80, 8, 2, 16, 64),      # block_n does not divide N: halved to 16
]


def assert_same(got, want):
    gi, gg, gp, gk = (np.asarray(t) for t in got)
    wi, wg, wp, wk = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gg, wg, **GATE_TOL)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gk, wk)


@pytest.mark.parametrize("n,e,k,cap,block_n", CASES)
def test_port_gating_matches_pallas_kernel_and_oracle(n, e, k, cap, block_n):
    logits = np.random.default_rng(4).standard_normal((n, e)).astype(np.float32)
    before = LAUNCHES["moe_gating"]
    got = moe_gating(torch.from_numpy(logits), k, cap, block_n=block_n)
    assert LAUNCHES["moe_gating"] == before, "the CPU path launches nothing"
    assert [t.dtype for t in got] == [torch.int32, torch.float32, torch.int32, torch.bool]
    assert all(tuple(t.shape) == (n, k) for t in got)
    assert_same(got, jax_moe_gating(jnp.asarray(logits), top_k=k, capacity=cap,
                                    block_n=block_n, interpret=True))
    bn = block_size(n, block_n)
    assert_same(got, jax_moe_gating_ref(jnp.asarray(logits), top_k=k, capacity=cap, block_n=bn))
    if cap < n * k / e:  # more choices than capacity per expert on average
        assert not bool(got[3].all()), "a contended case drops choices"


def test_plain_version_takes_ragged_blocks_as_the_oracle_does():
    """Called directly, the plain version takes a block that does not
    divide N (the last block is short), as the reference oracle does."""
    logits = np.random.default_rng(5).standard_normal((100, 8)).astype(np.float32)
    got = moe_gating_ref(torch.from_numpy(logits), 2, 20, block_n=32)
    assert_same(got, jax_moe_gating_ref(jnp.asarray(logits), top_k=2, capacity=20, block_n=32))


def test_ties_go_to_the_lowest_index():
    """Repeated logits: equal probabilities pick the lowest index first,
    as the Pallas kernel's argmax and jax.lax.top_k do."""
    rows = [[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0], [0.5, -1.0, 0.5, 0.5],
            [-4.0, 7.0, -4.0, 7.0]]
    logits = np.array(rows * 8, dtype=np.float32)  # 32 tokens, 4 experts
    got = moe_gating(torch.from_numpy(logits), 2, 12, block_n=32)
    assert got[0][:4].tolist() == [[1, 2], [0, 1], [0, 2], [1, 3]]
    np.testing.assert_allclose(got[1][:4].numpy(), 0.5, **GATE_TOL)
    assert_same(got, jax_moe_gating(jnp.asarray(logits), top_k=2, capacity=12, block_n=32,
                                    interpret=True))
    assert_same(got, jax_moe_gating_ref(jnp.asarray(logits), top_k=2, capacity=12, block_n=32))


def test_positions_are_rank_major_first_come_first_served():
    """Within a block every rank-0 choice is placed before any rank-1
    choice of the same expert; blocks go in order, the counts carried."""
    logits = torch.tensor([[5.0, 4.0, 0.0], [4.0, 5.0, 0.0], [5.0, 0.0, 4.0]])
    idx, _, pos, keep = moe_gating(logits, 2, 2, block_n=3)
    assert idx.tolist() == [[0, 1], [1, 0], [0, 2]]
    # expert 0: tokens 0 and 2 (rank 0) at 0, 1; token 1 (rank 1) at 2
    assert pos.tolist() == [[0, 1], [0, 2], [1, 0]]
    assert keep.tolist() == [[True, True], [True, False], [True, True]]
    # blocks of one token: token 0's rank-1 choice comes before token 2's rank 0
    _, _, pos1, _ = moe_gating(logits, 2, 2, block_n=1)
    assert pos1.tolist() == [[0, 0], [1, 1], [2, 0]]


def test_wrapper_refuses_what_the_contract_excludes():
    logits = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="top_k"):
        moe_gating(logits, 4, 8)
    with pytest.raises(ValueError, match=r"\[N, E\]"):
        moe_gating(logits[None], 2, 8)
    with pytest.raises(ValueError, match="block_n"):
        moe_gating(logits, 2, 8, block_n=0)
    assert block_size(80, 64) == 16 and block_size(96, 256) == 96 and block_size(7, 4) == 1
