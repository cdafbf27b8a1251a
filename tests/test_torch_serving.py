"""The port's serving layer: ``PagePool`` accounting, the paged
continuous batcher token-for-token against the reference package's on
llama3.2-1b and mixtral-8x7b SMOKE (f32, same params, same requests),
including more requests than slots and a pool tight enough to force
preemption, and the dense batcher on llama3.2-1b, mixtral-8x7b and
mamba2-370m SMOKE likewise; idle slots' cache positions tick for tick
against the reference's.  Mixtral runs dropless and at capacity factor
1.25 on both sides."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.models.zoo import build_model as jax_build_model  # noqa: E402
from repro.serving.batcher import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serving.batcher import Request as JaxRequest  # noqa: E402
from repro.serving.kv_cache import PagedSpec as JaxPagedSpec  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.core.messages import Mailbox, Message  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import ContinuousBatcher, PagedSpec, PagePool, Request  # noqa: E402


def _both_models(arch, capacity_factor=None):
    """Both packages' SMOKE models of ``arch`` on one set of params; an MoE
    arch may be given another capacity factor on both sides."""
    jcfg = jax_get_arch(arch, smoke=True)
    cfg = get_arch(arch, smoke=True)
    if capacity_factor is not None:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (jcfg, cfg))
    jmodel = jax_build_model(jcfg, compute_dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             dtype=torch.float32, device="cpu")
    return (jmodel, jparams), (model, params)


@pytest.fixture(scope="module")
def models():
    return _both_models("llama3.2-1b")


@pytest.fixture(scope="module")
def mamba_models():
    return _both_models("mamba2-370m")


@pytest.fixture(scope="module", params=[0.0, 1.25], ids=["dropless", "capacity_1.25"])
def mixtral_models(request):
    return _both_models("mixtral-8x7b", capacity_factor=request.param)


def serve_both(models, prompts, max_new, paged=None, **kw):
    """Run the same requests through both batchers; returns the two
    batchers and each side's outputs in submission order."""
    (jmodel, jparams), (model, params) = models
    runs = []
    for batcher_cls, req_cls, spec_cls, m, p in (
        (JaxBatcher, JaxRequest, JaxPagedSpec, jmodel, jparams),
        (ContinuousBatcher, Request, PagedSpec, model, params),
    ):
        spec = spec_cls(**paged) if paged is not None else None
        b = batcher_cls(m, p, paged=spec, **kw)
        reqs = [req_cls(prompt=list(pr), max_new_tokens=max_new) for pr in prompts]
        for r in reqs:
            b.submit(r)
        b.run_until_drained()
        runs.append((b, [r.output for r in reqs]))
    (jb, jout), (tb, tout) = runs
    return jb, jout, tb, tout


def jax_cache_pos(jb):
    """The reference batcher's device cache position of every slot (the
    same in every attention layer)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(jb.cache)[0]:
        if getattr(path[-1], "key", None) == "pos":
            pos = np.asarray(leaf)
            return pos[0] if pos.ndim == 2 else pos  # stacked [n_periods, slots]
    raise AssertionError("the reference cache holds no pos")


def serve_in_turn(models, groups, paged=None, **kw):
    """Serve each group of (prompt, max_new) requests to the end before
    the next, through both batchers in lockstep.  Returns each side's
    outputs in submission order and every slot's device cache position
    after each tick, (reference, port); the port's host copy is checked
    against its device positions every tick."""
    (jmodel, jparams), (model, params) = models
    jb = JaxBatcher(jmodel, jparams, paged=None if paged is None else JaxPagedSpec(**paged),
                    **kw)
    tb = ContinuousBatcher(model, params, paged=None if paged is None else PagedSpec(**paged),
                           **kw)
    jout, tout, jpos, tpos = [], [], [], []
    for group in groups:
        jreqs = [JaxRequest(prompt=list(p), max_new_tokens=n) for p, n in group]
        treqs = [Request(prompt=list(p), max_new_tokens=n) for p, n in group]
        for jr, tr in zip(jreqs, treqs):
            jb.submit(jr)
            tb.submit(tr)
        while tb.occupancy() or tb.queue_depth():
            jb.step()
            tb.step()
            jpos.append(jax_cache_pos(jb).tolist())
            tpos.append(tb._cache_pos.tolist())
            for layer in tb.cache:
                if "pos" in layer:
                    np.testing.assert_array_equal(layer["pos"].numpy(), tb._cache_pos)
        assert jb.occupancy() == 0 and jb.queue_depth() == 0
        jout += [r.output for r in jreqs]
        tout += [r.output for r in treqs]
    assert_drained(tb)
    return jout, tout, jpos, tpos


def assert_drained(b):
    assert b.occupancy() == 0 and b.queue_depth() == 0
    if b.page_pool is not None:
        assert b.page_pool.in_use == 0
        assert b.page_pool.leaked() == 0


def test_paged_batcher_matches_reference_more_requests_than_slots(models):
    prompts = [[i % 7 + 1, (3 * i) % 11 + 2, 5, i + 1][: 1 + i % 4] for i in range(7)]
    jb, jout, tb, tout = serve_both(
        models, prompts, 6, paged=dict(num_pages=33, page_size=4), slots=2, max_len=32)
    assert tout == jout
    assert all(len(o) == 6 for o in tout)
    assert tb.preemptions == jb.preemptions == 0
    assert tb.steps == jb.steps
    assert_drained(tb)


def test_paged_batcher_tight_pool_preempts_and_matches_reference(models):
    """8 usable pages for 4 slots x 8 requests: admissions stall and
    running slots are preempted and recomputed, on both sides alike."""
    prompts = [[i % 5 + 1, i % 3 + 2, 4] for i in range(8)]
    jb, jout, tb, tout = serve_both(
        models, prompts, 10, paged=dict(num_pages=9, page_size=4), slots=4, max_len=32)
    assert tout == jout
    assert tb.preemptions > 0, "the pool was never tight"
    assert (tb.preemptions, tb.admit_stalls, tb.steps) == (
        jb.preemptions, jb.admit_stalls, jb.steps)
    assert sum(r.restarts for r in tb.completed) == tb.preemptions
    assert tb.page_pool.high_watermark <= tb.page_pool.capacity
    assert_drained(tb)


def test_dense_batcher_matches_reference(models):
    prompts = [[5, 9, 2], [7, 1, 1, 3], [11]]
    jb, jout, tb, tout = serve_both(models, prompts, 5, slots=2, max_len=32)
    assert tout == jout
    assert_drained(tb)


def test_dense_llama_batcher_matches_reference(models):
    """The dense llama batcher (B4 prefill, B3 decode: their plain
    versions here) token for token against the reference's: prompts of
    70 and 80 tokens (over 64), max_len 100 (not a multiple of 128), more
    requests than slots.  Slot 1 serves both long prompts to the end of
    its cache, then rides idle for the rest of slot 0's request, its cache
    position running past max_len as the reference's does; the layer
    clamps B3's kv_len to the cache, which B3's wrapper checks on the
    CPU."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (3, 70, 80)]
    jb, jout, tb, tout = serve_both(models, prompts, 96, slots=2, max_len=100)
    assert tout == jout
    assert [len(o) for o in tout] == [96, 30, 20]
    assert tb.steps == jb.steps
    assert_drained(tb)


def test_dense_idle_slot_position_stays_inside_the_cache(models):
    """Requests one after another: slot 0 decodes, slot 1 never serves.
    Its cache position runs on past max_len, tick for tick as the
    reference's (neither batcher resets a dense slot), while what B3
    reads stays inside the cache: the layer clamps its kv_len, and B3's
    CPU wrapper refuses one past the cache.  The name dates from when the
    batcher reset the position at the cache's end; "inside" now holds
    for what B3 reads, not for the position."""
    prompts = [([3 + i, 5], 90) for i in range(2)]
    jout, tout, jpos, tpos = serve_in_turn(models, [[p] for p in prompts], slots=2,
                                           max_len=100)
    assert tpos == jpos
    seen = [pos[1] for pos in tpos]
    assert len(seen) == 2 * 89 and max(seen) > 100
    assert seen == list(range(1, len(seen) + 1)), "never reset"
    assert tout == jout and all(len(o) == 90 for o in tout)


C1_TOKENS = [124, 259, 4, 215, 67, 431, 457, 230, 203, 487, 424, 40]


def test_dense_mixtral_idle_slot_position_runs_on_as_reference(mixtral_models):
    """The smallest input on which a dense idle slot's position mattered:
    mixtral SMOKE, slots=2, max_len=16, [7, 8, 9] for 12 tokens beside
    [4, 5, 6, 1, 2] for 6, then three requests one at a time, which carry
    idle slot 1 past max_len.  At capacity 1.25 the idle slot's token
    takes expert capacity from the busy one; resetting its position on
    release changed the first request's tokens from the 8th on."""
    (jmodel, _), (model, _) = mixtral_models
    groups = [[([7, 8, 9], 12), ([4, 5, 6, 1, 2], 6)],
              [([3, 1], 12)], [([2, 2, 5], 12)], [([9], 12)]]
    jout, tout, jpos, tpos = serve_in_turn(mixtral_models, groups, slots=2, max_len=16)
    assert tout == jout
    assert tpos == jpos and max(pos[1] for pos in tpos) > 16
    if model.cfg.moe.capacity_factor == 1.25:
        assert tout[0] == C1_TOKENS


def test_paged_mixtral_idle_slots_past_their_table_as_reference(mixtral_models):
    """Paged, 3 slots of 16 rows: two short requests leave slots 1 and 2
    idle at stale positions, then three requests one at a time carry both
    past the end of their table rows.  There the reference writes each
    idle row into scratch page 0 at pos % page and attends every row of
    the table; resetting the positions at the row's end changed the
    last request's tokens at capacity 1.25."""
    groups = [[([31, 143, 255, 248, 59], 12), ([383, 492, 47, 371, 150], 5),
               ([141, 371, 82, 165, 496], 4)],
              [([149, 59], 12)], [([319, 233], 12)], [([185, 313, 395], 12)]]
    jout, tout, jpos, tpos = serve_in_turn(mixtral_models, groups,
                                           paged=dict(num_pages=13, page_size=4),
                                           slots=3, max_len=16)
    assert tout == jout
    assert tpos == jpos and min(max(pos[1] for pos in tpos), max(pos[2] for pos in tpos)) > 16


def test_dense_batcher_serves_mamba2_as_reference(mamba_models):
    """Every admission writes the whole one-row cache (conv and SSM states)
    into its slot; ragged prompts (one token, shorter and longer than the
    16-step chunk, none a multiple of it) and more requests than slots."""
    rng = np.random.default_rng(3)
    lens = [1, 5, 17, 30, 9, 23, 2]
    prompts = [rng.integers(0, 512, size=n).tolist() for n in lens]
    jb, jout, tb, tout = serve_both(mamba_models, prompts, 6, slots=3, max_len=64)
    assert tout == jout
    assert all(len(o) == 6 for o in tout)
    assert tb.steps == jb.steps
    assert_drained(tb)


def test_dense_admission_overwrites_every_cache_tensor_of_the_slot(mamba_models):
    """A slot's states left over from an earlier request (and from riding
    idle through decode ticks) never leak into the next admission."""
    _, (model, params) = mamba_models
    b = ContinuousBatcher(model, params, slots=2, max_len=64)
    for layer in b.cache:
        for t in layer["mamba"].values():
            t.fill_(7.0)
    req = Request(prompt=[4, 9, 1], max_new_tokens=3)
    b.submit(req)
    b.run_until_drained()
    alone = ContinuousBatcher(model, params, slots=2, max_len=64)
    again = Request(prompt=[4, 9, 1], max_new_tokens=3)
    alone.submit(again)
    alone.run_until_drained()
    assert req.output == again.output


def mixtral_prompts(n, seed):
    """Prompts of 20, 29 and 40 tokens, past mixtral SMOKE's window of 16
    (three lengths: the reference compiles its prefill once per length)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=(20, 29, 40)[i % 3]).tolist() for i in range(n)]


def test_paged_batcher_serves_mixtral_as_reference(mixtral_models):
    """7 requests on 3 slots: the last ticks run idle slots through the MoE,
    and at capacity 1.25 their tokens compete with the busy ones for
    capacity (1 per expert at 3 tokens: drops), so equal tokens show that
    the port feeds idle slots what the reference feeds them."""
    jb, jout, tb, tout = serve_both(mixtral_models, mixtral_prompts(7, 1), 6,
                                    paged=dict(num_pages=49, page_size=4), slots=3, max_len=64)
    assert tout == jout
    assert all(len(o) == 6 for o in tout)
    assert tb.steps == jb.steps and tb.preemptions == 0
    assert_drained(tb)


def test_paged_mixtral_tight_pool_preempts_as_reference(mixtral_models):
    """16 usable pages for 3 slots of 20-40-token prompts: admissions
    stall and slots are preempted (17 times), on both sides alike.  Freed
    and preempted slots ride idle with a position that is not their cache
    position, and at capacity 1.25 their tokens take expert capacity from
    the busy ones: equal tokens need the decode kernels to mask an idle
    slot's row at its own position, as the reference's attention does."""
    rng = np.random.default_rng(32)
    prompts = [rng.integers(0, 512, size=int(rng.integers(20, 41))).tolist() for _ in range(6)]
    jb, jout, tb, tout = serve_both(mixtral_models, prompts, 8,
                                    paged=dict(num_pages=17, page_size=4), slots=3, max_len=64)
    assert tout == jout
    assert tb.preemptions > 0, "the pool was never tight"
    assert (tb.preemptions, tb.admit_stalls, tb.steps) == (
        jb.preemptions, jb.admit_stalls, jb.steps)
    assert_drained(tb)


def test_dense_batcher_serves_mixtral_as_reference(mixtral_models):
    jb, jout, tb, tout = serve_both(mixtral_models, mixtral_prompts(4, 3), 5,
                                    slots=2, max_len=64)
    assert tout == jout
    assert tb.steps == jb.steps
    assert_drained(tb)


def test_eos_frees_the_slot_early_as_in_reference(models):
    """The EOS token ends a request early, on both sides alike: EOS is
    taken to be the first token the reference decodes for one prompt."""
    prompts = [[4, 4], [6, 1, 2]]
    _, jout, _, _ = serve_both(models, prompts, 8, slots=2, max_len=32,
                               paged=dict(num_pages=17, page_size=4))
    eos = jout[0][1]
    jb, jout, tb, tout = serve_both(models, prompts, 8, slots=2, max_len=32, eos_token=eos,
                                    paged=dict(num_pages=17, page_size=4))
    assert tout == jout
    assert tout[0][-1] == eos and len(tout[0]) == 2
    assert_drained(tb)


def test_idle_slot_position_stays_inside_its_table(models):
    """An idle slot rides every decode tick; its device position runs on
    past its table row, tick for tick as the reference's, while what the
    kernels index stays inside the table: the layer sends the row to
    scratch page 0 and clamps kv_len, so the CPU range checks of the
    kernel wrappers never trip however long a neighbour decodes.  The
    name dates from when the batcher reset the position at the row's
    end; "inside" now holds for what the kernels index."""
    cap = 16  # 4 table entries x 4 rows
    jout, tout, jpos, tpos = serve_in_turn(
        models, [[([3 + i], 14)] for i in range(3)],
        paged=dict(num_pages=9, page_size=4), slots=2, max_len=16)
    assert tpos == jpos
    seen = [pos[1] for pos in tpos]  # slot 0 decodes, slot 1 stays idle
    assert len(seen) == 39 and max(seen) > cap
    assert seen == list(range(1, len(seen) + 1)), "never reset"
    assert max(pos[0] for pos in tpos) <= cap
    assert tout == jout and all(len(o) == 14 for o in tout)


def test_invalid_and_oversize_requests_fail_fast(models):
    _, (model, params) = models
    b = ContinuousBatcher(model, params, slots=2, max_len=16,
                          paged=PagedSpec(num_pages=3, page_size=4))
    ok = Request(prompt=[3, 1], max_new_tokens=4)
    empty = Request(prompt=[], max_new_tokens=4)
    overlong = Request(prompt=[1] * 16, max_new_tokens=4)
    huge = Request(prompt=[2, 5, 1, 4], max_new_tokens=20)  # > 2 pages ever
    for r in (empty, ok, overlong, huge):
        b.submit(r)
    b.run_until_drained()
    assert len(b.completed) == 4
    assert (empty.fail_reason, overlong.fail_reason, huge.fail_reason) == (
        "invalid", "invalid", "oversize")
    assert empty.output == overlong.output == huge.output == []
    assert ok.fail_reason is None and len(ok.output) == 4
    assert (b.rejected_invalid, b.rejected_oversize) == (2, 1)
    assert_drained(b)


def test_sampling_uses_the_batchers_generator(models):
    _, (model, params) = models

    def run():
        b = ContinuousBatcher(model, params, slots=2, max_len=16, temperature=1.0,
                              paged=PagedSpec(num_pages=9, page_size=4))
        reqs = [Request(prompt=[i + 1, 2], max_new_tokens=6) for i in range(3)]
        for r in reqs:
            b.submit(r)
        b.run_until_drained()
        return [r.output for r in reqs]

    first = run()
    assert first == run(), "seeded generator: sampling is reproducible"
    assert all(0 <= t < 512 for o in first for t in o)


def test_stalled_queue_keeps_arrival_order(models):
    _, (model, params) = models
    b = ContinuousBatcher(model, params, slots=1, max_len=16,
                          paged=PagedSpec(num_pages=9, page_size=4))
    old = Request(prompt=[1], max_new_tokens=2)
    young = Request(prompt=[2], max_new_tokens=2)
    old.enqueued_at, young.enqueued_at = 0.0, 1.0
    b._stall(Message(topic="serve", payload=young, created_at=1.0))
    b._stall(Message(topic="serve", payload=old, created_at=0.0))
    assert [m.payload.req_id for m in b._stalled] == [old.req_id, young.req_id]
    assert b._next_message().payload.req_id == old.req_id


# --- PagePool / PagedSpec / Mailbox units ---------------------------------------


def test_page_pool_lifo_free_list():
    pool = PagePool(PagedSpec(num_pages=9, page_size=8))
    assert pool.capacity == 8  # page 0 is reserved
    first = pool.alloc(3)
    assert first == [1, 2, 3] and pool.high_watermark == 3
    pool.free(first)
    assert pool.alloc(1) == [3], "the last page freed is the first reused"
    assert pool.in_use == 1 and pool.available == 7 and pool.leaked() == 0


def test_page_pool_alloc_is_all_or_nothing():
    pool = PagePool(PagedSpec(num_pages=5, page_size=8))  # 4 usable
    assert pool.alloc(3) is not None
    before = (pool.available, pool.in_use)
    assert pool.alloc(2) is None
    assert (pool.available, pool.in_use) == before and pool.alloc_failures == 1
    assert pool.alloc(1) is not None
    with pytest.raises(ValueError):
        pool.alloc(-1)


def test_page_pool_double_free_raises():
    pool = PagePool(PagedSpec(num_pages=4, page_size=8))
    ids = pool.alloc(2)
    pool.free(ids)
    with pytest.raises(ValueError, match="double-free"):
        pool.free(ids)
    with pytest.raises(ValueError, match="double-free"):
        pool.free([0])  # the scratch page is never allocated, never freed


def test_page_pool_never_hands_out_scratch_page():
    pool = PagePool(PagedSpec(num_pages=6, page_size=4))
    assert sorted(pool.alloc(pool.capacity)) == [1, 2, 3, 4, 5]
    assert pool.alloc(1) is None


def test_page_pool_pages_for_and_fits():
    pool = PagePool(PagedSpec(num_pages=5, page_size=8))
    assert [pool.pages_for(n) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]
    assert pool.fits(32) and not pool.fits(33)


def test_paged_spec_validation():
    with pytest.raises(ValueError, match="num_pages"):
        PagedSpec(num_pages=1, page_size=8)
    with pytest.raises(ValueError, match="page_size"):
        PagedSpec(num_pages=4, page_size=0)
    assert PagedSpec(num_pages=4, page_size=16).pages_per_slot(33) == 3


def test_mailbox_is_fifo():
    box = Mailbox("m")
    assert box.get() is None and box.depth() == 0
    for i in range(3):
        box.put(Message(topic="t", payload=i))
    assert box.depth() == 3
    assert [box.get().payload for _ in range(3)] == [0, 1, 2]
