"""The port's llama3.2-1b (SMOKE, f32) against the reference package's on
the same params: prefill logits and three ragged decode steps, through
the kernel path (the reference's ``use_pallas=True``, Pallas in interpret
mode), the plain paged path, and the linear cache."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.tree_util import DictKey, tree_map_with_path  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.models.layers import PagedSpec as JaxPagedSpec  # noqa: E402
from repro.models.zoo import build_model as jax_build_model  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import PagedSpec  # noqa: E402

ATOL = 1e-4
B, T, MAX_LEN, PAGE = 3, 5, 16, 4


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_arch("llama3.2-1b", smoke=True)
    jparams = jax_build_model(jcfg, compute_dtype=jnp.float32).init(jax.random.PRNGKey(0))
    cfg = get_arch("llama3.2-1b", smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             dtype=torch.float32, device="cpu")
    return jcfg, jparams, cfg, params


def test_config_copy_matches_reference():
    for smoke in (False, True):
        mine, theirs = get_arch("llama3.2-1b", smoke), jax_get_arch("llama3.2-1b", smoke)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "head_dim", "max_seq_len", "rope_theta",
                  "norm_eps", "tie_embeddings"):
            assert getattr(mine, f) == getattr(theirs, f), f
        assert mine.resolved_head_dim == theirs.resolved_head_dim


def test_converter_unstacks_layers(setup):
    jcfg, jparams, cfg, params = setup
    assert len(params["layers"]) == cfg.num_layers == 2
    for i, layer in enumerate(params["layers"]):
        np.testing.assert_array_equal(
            layer["attn"]["wq"].numpy(),
            np.asarray(jparams["periods"][0]["attn"]["wq"][i]),
        )
        assert tuple(layer["attn"]["wo"].shape) == (cfg.num_heads, cfg.resolved_head_dim,
                                                    cfg.d_model)


def _set_leaves(cache, key, value):
    def put(path, leaf):
        last = path[-1]
        if isinstance(last, DictKey) and last.key == key:
            return jnp.broadcast_to(jnp.asarray(value), leaf.shape).astype(leaf.dtype)
        return leaf
    return tree_map_with_path(put, cache)


@pytest.mark.parametrize("mode", ["kernels", "plain", "linear"])
def test_prefill_then_decode_matches_reference(setup, mode):
    jcfg, jparams, cfg, params = setup
    jmodel = jax_build_model(jcfg, compute_dtype=jnp.float32,
                             use_pallas=(mode == "kernels"))
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu",
                        use_kernels=(mode != "plain"))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)

    if mode == "linear":
        jcache = jmodel.init_cache(B, MAX_LEN)
        cache = model.init_cache(B, MAX_LEN)
    else:
        n_slot = MAX_LEN // PAGE
        num_pages = 1 + B * n_slot
        table = (1 + rng.permutation(B * n_slot)).reshape(B, n_slot).astype(np.int32)
        jcache = _set_leaves(
            jmodel.init_cache(B, MAX_LEN, paged=JaxPagedSpec(num_pages, PAGE)),
            "page_table", table)
        cache = model.init_cache(B, MAX_LEN, paged=PagedSpec(num_pages, PAGE))
        for layer in cache:
            layer["page_table"] = torch.from_numpy(table.copy())

    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, jcache,
                                     last_only=True)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)}, cache,
                                  last_only=True)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)

    # Ragged decode: rows 1 and 2 continue as if their prompts were shorter
    # (their later cache rows are then masked, stale context).
    pos = np.array([T, T - 2, T - 1], dtype=np.int32)
    jcache = _set_leaves(jcache, "pos", pos)
    for layer in cache:
        layer["pos"] = torch.from_numpy(pos.copy())
    tokens = logits[:, -1].argmax(-1).to(torch.int64)[:, None]
    for _ in range(3):
        jlogits, jcache = jmodel.decode_step(
            jparams, jnp.asarray(tokens.numpy(), dtype=jnp.int32), jcache, jnp.asarray(pos))
        logits, cache = model.decode_step(params, tokens, cache, torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)
        greedy = logits[:, -1].argmax(-1)
        assert greedy.tolist() == np.asarray(jnp.argmax(jlogits[:, -1], -1)).tolist()
        tokens = greedy.to(torch.int64)[:, None]
        pos = pos + 1

    # the caches after prefill + decode: per-layer on the port's side,
    # stacked [n_periods, ...] on the reference's
    key = "k" if mode == "linear" else "k_pages"
    stacked = np.stack([layer[key].numpy() for layer in cache])
    ref = np.asarray(jcache["periods"][0]["attn"][key])
    # page 0 is the scratch page: never compared
    sl = (slice(None),) if mode == "linear" else (slice(None), slice(1, None))
    np.testing.assert_allclose(stacked[sl], ref[sl], atol=1e-5)


def test_tied_embedding_is_scaled_by_sqrt_d_model(setup):
    """The reference multiplies tied embeddings by sqrt(d_model), unlike
    Hugging Face's Llama; the port must follow the reference."""
    from repro_torch.models.layers import embed

    _, _, cfg, params = setup
    tokens = torch.tensor([[1, 7]])
    np.testing.assert_allclose(
        embed(params["embed"], tokens, cfg).numpy(),
        params["embed"]["tok"][tokens].numpy() * np.sqrt(cfg.d_model), rtol=1e-6)


def test_sliding_layers_are_refused_until_the_ring_cache_is_ported():
    """A SLIDING layer would run on a linear cache, which is not what the
    reference's ring cache computes past the window: it is refused, as
    Mamba blocks with an FFN are."""
    import dataclasses

    from repro_torch.config.base import AttentionKind, LayerSpec

    cfg = get_arch("llama3.2-1b", smoke=True)
    swa = dataclasses.replace(cfg, pattern=(LayerSpec(attention=AttentionKind.SLIDING, window=4),
                                            LayerSpec()))
    with pytest.raises(NotImplementedError, match="layer 0"):
        build_model(swa, compute_dtype=torch.float32, device="cpu")
    build_model(cfg, compute_dtype=torch.float32, device="cpu")  # all-FULL still builds
