"""The port's mamba2-370m (SMOKE, f32) against the reference package's on
the same params: prefill logits for a prompt that is not a multiple of
the chunk, then five decode steps, through the kernel path (the wrapper's
plain version on the CPU) and the plain path.  The reference runs with
``use_pallas=False``: its Pallas model path cannot run on the CPU."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.models.zoo import build_model as jax_build_model  # noqa: E402
from repro_torch.config import FFNKind, LayerSpec, get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import PagedSpec  # noqa: E402

ATOL = 1e-4
B, T, MAX_LEN = 2, 21, 64  # SMOKE chunk is 16: T pads to 32 with inert steps
ARCH = "mamba2-370m"


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_arch(ARCH, smoke=True)
    jparams = jax_build_model(jcfg, compute_dtype=jnp.float32).init(jax.random.PRNGKey(0))
    cfg = get_arch(ARCH, smoke=True)
    numpy_tree = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(numpy_tree, cfg, dtype=torch.float32, device="cpu")
    return jcfg, jparams, cfg, params, numpy_tree


def test_config_copy_matches_reference():
    for smoke in (False, True):
        mine, theirs = get_arch(ARCH, smoke), jax_get_arch(ARCH, smoke)
        for f in ("num_layers", "d_model", "vocab_size", "head_dim", "max_seq_len",
                  "norm_eps", "tie_embeddings", "family"):
            assert getattr(mine, f) == getattr(theirs, f), f
        assert dataclasses.asdict(mine.mamba) == dataclasses.asdict(theirs.mamba)
        assert [dataclasses.asdict(s) for s in mine.pattern] == [
            {k: getattr(s, k) for k in ("attention", "ffn", "window", "is_mamba")}
            for s in theirs.pattern]
    full = get_arch(ARCH)
    assert (full.num_layers, full.d_model, full.vocab_size) == (48, 1024, 50280)
    assert (full.mamba.d_state, full.mamba.expand, full.mamba.head_dim,
            full.mamba.chunk_size) == (128, 2, 64, 64)


def test_converter_unstacks_mamba_layers(setup):
    jcfg, jparams, cfg, params, _ = setup
    assert len(params["layers"]) == cfg.num_layers == 3
    for i, layer in enumerate(params["layers"]):
        assert set(layer) == {"norm_attn", "mamba"}
        for key, value in layer["mamba"].items():
            np.testing.assert_array_equal(
                value.numpy(), np.asarray(jparams["periods"][0]["mamba"][key][i]))


def test_converter_keeps_f32_leaves_in_bf16(setup):
    """dt_bias, A_log and D are float32 in the reference at any dtype; a
    bf16 A_log would change every decay."""
    _, _, cfg, _, numpy_tree = setup
    params = params_from_jax(numpy_tree, cfg, dtype=torch.bfloat16, device="cpu")
    own = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for p in (params, own):
        for layer in p["layers"]:
            dtypes = {k: v.dtype for k, v in layer["mamba"].items()}
            assert all(dtypes[k] == torch.float32 for k in ("dt_bias", "A_log", "D"))
            assert all(dtypes[k] == torch.bfloat16 for k in dtypes
                       if k not in ("dt_bias", "A_log", "D"))
    np.testing.assert_array_equal(params["layers"][0]["mamba"]["A_log"].numpy(),
                                  numpy_tree["periods"][0]["mamba"]["A_log"][0])
    cache = build_model(cfg, device="cpu").init_cache(2, 16)
    assert cache[0]["mamba"]["ssm"].dtype == torch.float32
    assert cache[0]["mamba"]["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
def test_prefill_then_decode_matches_reference(setup, use_kernels):
    jcfg, jparams, cfg, params, _ = setup
    jmodel = jax_build_model(jcfg, compute_dtype=jnp.float32)
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu",
                        use_kernels=use_kernels)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)

    jcache = jmodel.init_cache(B, MAX_LEN)
    cache = model.init_cache(B, MAX_LEN)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, jcache)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)}, cache)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (B, T, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)

    pos = np.full((B,), T, dtype=np.int32)
    tokens = logits[:, -1].argmax(-1).to(torch.int64)[:, None]
    for _ in range(5):
        jlogits, jcache = jmodel.decode_step(
            jparams, jnp.asarray(tokens.numpy(), dtype=jnp.int32), jcache, jnp.asarray(pos))
        logits, cache = model.decode_step(params, tokens, cache, torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)
        greedy = logits[:, -1].argmax(-1)
        assert greedy.tolist() == np.asarray(jnp.argmax(jlogits[:, -1], -1)).tolist()
        tokens = greedy.to(torch.int64)[:, None]
        pos = pos + 1

    # the states after prefill + decode: per layer here, stacked on the reference's side
    for key in ("conv", "ssm"):
        stacked = np.stack([layer["mamba"][key].numpy() for layer in cache])
        np.testing.assert_allclose(stacked, np.asarray(jcache["periods"][0]["mamba"][key]),
                                   atol=ATOL)


def test_reference_pallas_model_path_cannot_run_on_the_cpu(setup):
    """Why the reference is held with use_pallas=False: its model calls the
    Pallas scan without interpret mode."""
    jcfg, jparams, _, _, _ = setup
    jmodel = jax_build_model(jcfg, compute_dtype=jnp.float32, use_pallas=True)
    prompt = jnp.zeros((1, 16), dtype=jnp.int32)
    with pytest.raises(Exception, match="interpret mode"):
        jmodel.prefill(jparams, {"tokens": prompt}, jmodel.init_cache(1, MAX_LEN))


def test_paged_cache_is_attention_only():
    model = build_model(get_arch(ARCH, smoke=True), compute_dtype=torch.float32,
                        device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        model.init_cache(2, 32, paged=PagedSpec(num_pages=9, page_size=4))


def test_unported_block_kinds_still_raise():
    cfg = dataclasses.replace(
        get_arch(ARCH, smoke=True),
        pattern=(LayerSpec(is_mamba=True, ffn=FFNKind.MOE),))
    with pytest.raises(NotImplementedError, match="ported"):
        build_model(cfg, device="cpu")


def test_mamba_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(get_arch(ARCH, smoke=True))
