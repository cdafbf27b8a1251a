"""The port's MoE FFN (``repro_torch.models.moe``) against the reference
package's ``moe_ffn`` (one-hot dispatch) and ``moe_ffn_scatter`` on the
same params and inputs, f32, dropless and under capacity drops, and its
FCFS positions against the reference's and against the plain B5.  The
reference's own twin of this check (tests/test_moe_impls.py) is marked
slow; this one stays small."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import ArchConfig as JaxArchConfig  # noqa: E402
from repro.config.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.models.moe import _fcfs_positions as jax_fcfs_positions  # noqa: E402
from repro.models.moe import init_moe as jax_init_moe  # noqa: E402
from repro.models.moe import moe_ffn as jax_moe_ffn  # noqa: E402
from repro.models.moe import moe_ffn_scatter as jax_moe_ffn_scatter  # noqa: E402
from repro_torch.config.base import ArchConfig, MoEConfig  # noqa: E402
from repro_torch.kernels.moe_gating import moe_gating_ref  # noqa: E402
from repro_torch.kernels.moe_gating.ref import fcfs_positions  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# the reference's tolerance for its two dispatch paths (tests/test_moe_impls.py)
TOL = dict(rtol=1e-5, atol=1e-5)


def setup(e, k, cap_factor, seed=0, d=32, ff=64):
    jcfg = JaxArchConfig(name="t", family="moe", num_layers=1, d_model=d, num_heads=4,
                         num_kv_heads=2, d_ff=ff, vocab_size=64,
                         moe=JaxMoEConfig(num_experts=e, top_k=k, capacity_factor=cap_factor))
    jparams = jax_init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    x = np.random.default_rng(seed + 1).standard_normal((2, 16, d)).astype(np.float32)
    params = {name: torch.from_numpy(np.array(v)) for name, v in jparams.items()}
    mcfg = MoEConfig(num_experts=e, top_k=k, capacity_factor=cap_factor)
    return jcfg, jparams, x, params, mcfg


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("e,k,cap_factor", [(4, 2, 0.0), (8, 1, 0.0), (16, 2, 0.0),
                                            (4, 2, 0.6), (4, 2, 0.5)])
def test_moe_ffn_matches_reference(e, k, cap_factor, use_kernels):
    jcfg, jparams, x, params, mcfg = setup(e, k, cap_factor, seed=3 if cap_factor == 0.5 else 0)
    y = moe.moe_ffn(params, torch.from_numpy(x), mcfg, use_kernels=use_kernels)
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    y_einsum, _ = jax_moe_ffn(jparams, jnp.asarray(x), jcfg.moe)
    y_scatter, _ = jax_moe_ffn_scatter(jparams, jnp.asarray(x), jcfg.moe)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_einsum), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_scatter), **TOL)
    if cap_factor > 0:  # the contended cases really drop choices
        logits = torch.from_numpy(x.reshape(-1, x.shape[-1])) @ params["router"]
        n = logits.shape[0]
        keep = moe_gating_ref(logits, k, moe._capacity(n, mcfg), block_n=n)[3]
        assert not bool(keep.all())


def test_init_keeps_the_router_f32_and_reference_shapes():
    cfg = ArchConfig(name="t", family="moe", num_layers=1, d_model=32, num_heads=4,
                     num_kv_heads=2, d_ff=64, vocab_size=64, moe=MoEConfig(num_experts=4))
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    assert p["router"].dtype == torch.float32 and tuple(p["router"].shape) == (32, 4)
    assert p["w_gate"].dtype == torch.bfloat16 and tuple(p["w_gate"].shape) == (4, 32, 64)
    assert tuple(p["w_up"].shape) == (4, 32, 64) and tuple(p["w_down"].shape) == (4, 64, 32)


@pytest.mark.parametrize("tokens,cap_factor", [(16, 0.0), (16, 1.25), (3, 1.25), (512, 1.25)])
def test_capacity_matches_reference(tokens, cap_factor):
    from repro.models.moe import _capacity as jax_capacity

    m = MoEConfig(num_experts=8, top_k=2, capacity_factor=cap_factor)
    jm = JaxMoEConfig(num_experts=8, top_k=2, capacity_factor=cap_factor)
    assert moe._capacity(tokens, m) == jax_capacity(tokens, jm)


@pytest.mark.parametrize("n,e,k", [(64, 4, 2), (48, 8, 1), (100, 16, 2)])
def test_fcfs_positions_match_reference_and_plain_b5_over_one_block(n, e, k):
    logits = np.random.default_rng(n).standard_normal((n, e)).astype(np.float32)
    idx, _, pos, _ = moe_gating_ref(torch.from_numpy(logits), k, n * k, block_n=n)
    mine = fcfs_positions(idx, e, n)
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy(),
                                  np.asarray(jax_fcfs_positions(jnp.asarray(idx.numpy()), e)))
    np.testing.assert_array_equal(mine.numpy(), pos.numpy())


def test_b5_positions_differ_from_fcfs_when_blocks_are_smaller_than_n():
    """With k = 2 and block_n < N, a later block's rank-0 choice comes after
    an earlier block's rank-1 choice, unlike the reference's
    ``_fcfs_positions`` (one block of N): the
    model passes block_n = N for that reason (ROADMAP, queue B)."""
    n, e = 64, 4
    logits = np.random.default_rng(9).standard_normal((n, e)).astype(np.float32)
    idx, _, blocked, _ = moe_gating_ref(torch.from_numpy(logits), 2, n * 2, block_n=16)
    whole = fcfs_positions(idx, e, n)
    np.testing.assert_array_equal(whole.numpy(),
                                  np.asarray(jax_fcfs_positions(jnp.asarray(idx.numpy()), e)))
    assert not torch.equal(blocked, whole)
    # the same choices hold the same places overall: a permutation per expert
    for x in range(e):
        sel = idx == x
        assert sorted(blocked[sel].tolist()) == sorted(whole[sel].tolist()) == list(
            range(int(sel.sum())))


def test_moe_ffn_calls_b5_once_with_block_n_equal_to_the_tokens(monkeypatch):
    """The model's gating call: the kernel wrapper with use_kernels, the
    plain version without, each once, at block_n = N."""
    _, _, x, params, mcfg = setup(4, 2, 1.25)
    calls = []
    for name in ("moe_gating", "moe_gating_ref"):
        real = getattr(moe, name)

        def spy(logits, top_k, capacity, block_n, _real=real, _name=name):
            calls.append((_name, logits.shape[0], block_n, capacity))
            return _real(logits, top_k, capacity, block_n=block_n)

        monkeypatch.setattr(moe, name, spy)
    for use_kernels in (True, False):
        moe.moe_ffn(params, torch.from_numpy(x), mcfg, use_kernels=use_kernels)
    n = x.shape[0] * x.shape[1]
    cap = moe._capacity(n, mcfg)
    assert calls == [("moe_gating", n, n, cap), ("moe_gating_ref", n, n, cap)]
