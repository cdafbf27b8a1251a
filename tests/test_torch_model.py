"""The port's llama3.2-1b (SMOKE, f32) against the reference package's on
the same params: prefill logits and three ragged decode steps, through
the kernel path (the reference's ``use_pallas=True``, Pallas in interpret
mode), the plain paged path, and the linear cache (whose prefill and
decode run the flash and dense decode kernels' plain versions here); and
which attention kernel each entry point reaches."""

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


def prefill_then_decode(jcfg, jparams, cfg, params, mode, b=B, t=T, max_len=MAX_LEN):
    """Prefill, then three ragged decode steps, on both packages from one
    set of params: logits at every step, greedy tokens, and the caches
    after, compared."""
    jmodel = jax_build_model(jcfg, compute_dtype=jnp.float32,
                             use_pallas=(mode == "kernels"))
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu",
                        use_kernels=(mode != "plain"))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)

    if mode == "linear":
        jcache = jmodel.init_cache(b, max_len)
        cache = model.init_cache(b, max_len)
    else:
        n_slot = max_len // PAGE
        num_pages = 1 + b * n_slot
        table = (1 + rng.permutation(b * n_slot)).reshape(b, n_slot).astype(np.int32)
        jcache = _set_leaves(
            jmodel.init_cache(b, max_len, paged=JaxPagedSpec(num_pages, PAGE)),
            "page_table", table)
        cache = model.init_cache(b, max_len, paged=PagedSpec(num_pages, PAGE))
        for layer in cache:
            layer["page_table"] = torch.from_numpy(table.copy())

    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, jcache,
                                     last_only=True)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)}, cache,
                                  last_only=True)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (b, 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)

    # Ragged decode: rows 1 and 2 continue as if their prompts were shorter
    # (their later cache rows are then masked, stale context).
    pos = np.array([t, t - 2, t - 1], dtype=np.int32)
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
    # stacked [n_periods, ...] per pattern position on the reference's
    key = "k" if mode == "linear" else "k_pages"
    plen = len(cfg.pattern)
    stacked = np.stack([layer[key].numpy() for layer in cache])
    ref = np.stack([np.asarray(jcache["periods"][i % plen]["attn"][key][i // plen])
                    for i in range(cfg.num_layers)])
    # page 0 is the scratch page: never compared
    sl = (slice(None),) if mode == "linear" else (slice(None), slice(1, None))
    np.testing.assert_allclose(stacked[sl], ref[sl], atol=1e-5)


@pytest.mark.parametrize("mode", ["kernels", "plain", "linear"])
def test_prefill_then_decode_matches_reference(setup, mode):
    prefill_then_decode(*setup, mode)


def test_tied_embedding_is_scaled_by_sqrt_d_model(setup):
    """The reference multiplies tied embeddings by sqrt(d_model), unlike
    Hugging Face's Llama; the port must follow the reference."""
    from repro_torch.models.layers import embed

    _, _, cfg, params = setup
    tokens = torch.tensor([[1, 7]])
    np.testing.assert_allclose(
        embed(params["embed"], tokens, cfg).numpy(),
        params["embed"]["tok"][tokens].numpy() * np.sqrt(cfg.d_model), rtol=1e-6)


def test_bf16_unembed_sums_in_f32_as_reference():
    """llama3.2-1b SMOKE's tied unembed (d 64, vocab 512) on bf16 operands
    against the reference's, which takes f32 sums of the bf16 products
    (``preferred_element_type``): bf16 x [1, 16, 64] (randn) and table
    [512, 64] (0.02 randn), drawn in turn from one seeded generator, 20
    times.  Both sides sum 64 exact products in f32 in their own order,
    an error below 64 * 2**-24 of the sum of |products| (< 1 here):
    atol 1e-5.  Logits rounded to bf16 first miss by up to about 2e-3."""
    from repro.models.layers import unembed as jax_unembed
    from repro_torch.models.layers import unembed

    cfg, jcfg = get_arch("llama3.2-1b", smoke=True), jax_get_arch("llama3.2-1b", smoke=True)
    assert cfg.tie_embeddings and (cfg.d_model, cfg.vocab_size) == (64, 512)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        x = torch.randn((1, 16, 64), generator=gen, dtype=torch.bfloat16)
        tok = 0.02 * torch.randn((512, 64), generator=gen, dtype=torch.bfloat16)
        got = unembed({"tok": tok}, x, cfg)
        want = jax_unembed({"tok": jnp.asarray(tok.float().numpy(), dtype=jnp.bfloat16)},
                           jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16), jcfg)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


def test_sliding_layers_are_refused_until_the_ring_cache_is_ported():
    """The ring cache (``slot_pos``) is still unported, but no serving path
    of the reference builds one: on a linear or paged cache the window is
    a mask.  So a SLIDING layer is accepted and must match the reference
    past its window (window 4, a 5-token prompt, three decode steps), on
    the kernel path over pages and on a linear cache; a Mamba block with
    an FFN is still refused."""
    import dataclasses

    from repro.config.base import AttentionKind as JaxAttentionKind
    from repro.config.base import LayerSpec as JaxLayerSpec
    from repro_torch.config.base import AttentionKind, FFNKind, LayerSpec

    jcfg = jax_get_arch("llama3.2-1b", smoke=True)
    jcfg = dataclasses.replace(jcfg, pattern=(
        JaxLayerSpec(attention=JaxAttentionKind.SLIDING, window=4), JaxLayerSpec()))
    cfg = get_arch("llama3.2-1b", smoke=True)
    cfg = dataclasses.replace(cfg, pattern=(
        LayerSpec(attention=AttentionKind.SLIDING, window=4), LayerSpec()))
    jparams = jax_build_model(jcfg, compute_dtype=jnp.float32).init(jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             dtype=torch.float32, device="cpu")
    for mode in ("kernels", "linear"):
        prefill_then_decode(jcfg, jparams, cfg, params, mode)

    mamba = get_arch("mamba2-370m", smoke=True)
    with_ffn = dataclasses.replace(mamba, pattern=(LayerSpec(attention=AttentionKind.NONE,
                                                             ffn=FFNKind.DENSE, is_mamba=True),))
    with pytest.raises(NotImplementedError, match="layer 0"):
        build_model(with_ffn, compute_dtype=torch.float32, device="cpu")
    build_model(mamba, compute_dtype=torch.float32, device="cpu")  # FFN-less still builds


# --- mixtral-8x7b SMOKE: sliding window 16, MoE 4 experts top-2 ----------------

MIXTRAL = "mixtral-8x7b"


@pytest.fixture(scope="module")
def mixtral():
    jcfg = jax_get_arch(MIXTRAL, smoke=True)
    jparams = jax_build_model(jcfg, compute_dtype=jnp.float32).init(jax.random.PRNGKey(0))
    cfg = get_arch(MIXTRAL, smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             dtype=torch.float32, device="cpu")
    return jcfg, jparams, cfg, params


def with_capacity(cfg, capacity_factor):
    import dataclasses

    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            capacity_factor=capacity_factor))


@pytest.mark.parametrize("capacity_factor", [0.0, 1.25])
@pytest.mark.parametrize("mode", ["kernels", "plain", "linear"])
def test_mixtral_prefill_then_decode_matches_reference(mixtral, mode, capacity_factor):
    """Prompts of 20 tokens (past the window of 16), dropless and at the
    published capacity factor, on both sides alike."""
    jcfg, jparams, cfg, params = mixtral
    prefill_then_decode(with_capacity(jcfg, capacity_factor), jparams,
                        with_capacity(cfg, capacity_factor), params, mode, t=20, max_len=32)


def test_converter_carries_moe_leaves_with_an_f32_router(mixtral):
    jcfg, jparams, cfg, _ = mixtral
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             dtype=torch.bfloat16, device="cpu")
    e, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    shapes = {"router": (d, e), "w_gate": (e, d, ff), "w_up": (e, d, ff), "w_down": (e, ff, d)}
    for i, layer in enumerate(params["layers"]):
        assert "mlp" not in layer and set(layer["moe"]) == set(shapes)
        for name, shape in shapes.items():
            got = layer["moe"][name]
            assert tuple(got.shape) == shape
            assert got.dtype == (torch.float32 if name == "router" else torch.bfloat16)
            want = np.asarray(jparams["periods"][0]["moe"][name][i], dtype=np.float32)
            if name == "router":
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_array_equal(
                    got.float().numpy(), torch.tensor(want).bfloat16().float().numpy())


def test_mixtral_config_copy_matches_reference():
    for smoke in (False, True):
        mine, theirs = get_arch(MIXTRAL, smoke), jax_get_arch(MIXTRAL, smoke)
        for f in ("family", "num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "head_dim", "max_seq_len", "rope_theta", "norm_eps",
                  "tie_embeddings", "supports_long_context"):
            assert getattr(mine, f) == getattr(theirs, f), f
        for f in ("num_experts", "top_k", "capacity_factor", "router_jitter",
                  "aux_loss_weight"):
            assert getattr(mine.moe, f) == getattr(theirs.moe, f), f
        assert [(p.attention.value, p.ffn.value, p.window, p.is_mamba) for p in mine.pattern] \
            == [(p.attention.value, p.ffn.value, p.window, p.is_mamba) for p in theirs.pattern]


@pytest.fixture
def spies(monkeypatch):
    """Count the calls the attention layer makes to each kernel wrapper
    (on the CPU the wrappers run their plain versions and count no
    launch, so the calls are counted here)."""
    from repro_torch.models import layers

    calls = {"flash_attention": 0, "decode_attention": 0, "paged_decode_attention": 0}
    for name in calls:
        real = getattr(layers, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(layers, name, spy)
    return calls


@pytest.mark.parametrize("kind", ["linear", "paged"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_entry_points_reach_the_attention_kernels(setup, spies, kind, use_kernels):
    """With kernels, Model.prefill calls flash_attention once per layer on
    either cache, and a decode step calls the cache's decode kernel once
    per layer; with use_kernels=False neither kernel is called."""
    _, _, cfg, params = setup
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu",
                        use_kernels=use_kernels)
    paged = PagedSpec(1 + B * (MAX_LEN // PAGE), PAGE) if kind == "paged" else None
    cache = model.init_cache(B, MAX_LEN, paged=paged)
    if paged is not None:
        table = torch.arange(1, 1 + B * (MAX_LEN // PAGE), dtype=torch.int32).reshape(B, -1)
        for layer in cache:
            layer["page_table"] = table
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (B, T)))
    logits, cache = model.prefill(params, {"tokens": prompt}, cache, last_only=True)
    n = cfg.num_layers if use_kernels else 0
    assert spies["flash_attention"] == n
    tokens = logits[:, -1].argmax(-1)[:, None]
    model.decode_step(params, tokens, cache, torch.full((B,), T, dtype=torch.int32))
    decode = "decode_attention" if kind == "linear" else "paged_decode_attention"
    assert spies[decode] == n and spies["flash_attention"] == n
    assert sum(spies.values()) == 2 * n


def test_forward_from_a_nonzero_start_never_reaches_flash(setup, spies):
    """A chunk after the first (start 3 on a linear cache holding 3 rows)
    attends over the cache; B4's single q_offset never serves it."""
    from repro_torch.models import transformer

    _, _, cfg, params = setup
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 2 * T)))
    cache = model.init_cache(B, MAX_LEN)
    _, cache = model.prefill(params, {"tokens": tokens[:, :3]}, cache)
    assert spies["flash_attention"] == cfg.num_layers
    chunked, _ = transformer.forward(params, cfg, tokens[:, 3:], cache,
                                     torch.full((B,), 3, dtype=torch.int32),
                                     use_kernels=True, compute_dtype=torch.float32)
    assert spies["flash_attention"] == cfg.num_layers and spies["decode_attention"] == 0
    whole, _ = model.prefill(params, {"tokens": tokens}, model.init_cache(B, MAX_LEN))
    np.testing.assert_allclose(chunked.numpy(), whole[:, 3:].numpy(), atol=ATOL)


@pytest.mark.parametrize("kind", ["linear", "paged"])
def test_prefill_refuses_a_cache_that_holds_rows(setup, spies, kind):
    """Model.prefill starts every row at 0 and B4 attends over the chunk
    alone, so a cache whose pos is not 0 is refused before any layer runs."""
    _, _, cfg, params = setup
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    paged = PagedSpec(1 + B * (MAX_LEN // PAGE), PAGE) if kind == "paged" else None
    cache = model.init_cache(B, MAX_LEN, paged=paged)
    cache[-1]["pos"][1] = 2
    prompt = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (B, T)))
    with pytest.raises(ValueError, match=f"layer {cfg.num_layers - 1}"):
        model.prefill(params, {"tokens": prompt}, cache)
    assert sum(spies.values()) == 0
