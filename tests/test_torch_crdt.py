"""Property tests for the CRDT laws (paper §3.2.2 state management).

State-based CRDTs must form a join-semilattice: merge commutative,
associative, idempotent; local updates monotone. Convergence follows.
"""

from _hypothesis_support import given, settings, st  # noqa: F401

from repro_torch.core.crdt import (
    GCounter,
    GSet,
    LWWRegister,
    ORSet,
    PNCounter,
    VClock,
    merge_all,
)

# --- strategies -------------------------------------------------------------

replica_ids = st.sampled_from(["r0", "r1", "r2", "r3"])


@st.composite
def gcounters(draw):
    n = draw(st.integers(0, 4))
    counts = {f"r{i}": draw(st.integers(0, 100)) for i in range(n)}
    return GCounter(draw(replica_ids), counts)


@st.composite
def pncounters(draw):
    g1 = draw(gcounters())
    g2 = draw(gcounters())
    out = PNCounter(g1.replica_id)
    out.pos, out.neg = g1, g2.copy_as(g1.replica_id)
    return out


@st.composite
def lww(draw):
    return LWWRegister(
        value=draw(st.integers()),
        timestamp=draw(st.floats(0, 1e6, allow_nan=False)),
        tiebreak=draw(st.text(max_size=3)),
    )


@st.composite
def gsets(draw):
    return GSet(draw(st.frozensets(st.integers(0, 50), max_size=8)))


@st.composite
def orsets(draw):
    s = ORSet()
    for _ in range(draw(st.integers(0, 6))):
        item = draw(st.integers(0, 10))
        if draw(st.booleans()):
            s = s.add(item)
        else:
            s = s.remove(item)
    return s


@st.composite
def vclocks(draw):
    n = draw(st.integers(0, 4))
    return VClock({f"r{i}": draw(st.integers(0, 20)) for i in range(n)})


STRATS = {
    "gcounter": gcounters(),
    "pncounter": pncounters(),
    "lww": lww(),
    "gset": gsets(),
    "orset": orsets(),
    "vclock": vclocks(),
}


def _value(x):
    """Observable value used for equality in the semilattice checks."""
    if isinstance(x, (GCounter, PNCounter)):
        return x.value()
    if isinstance(x, LWWRegister):
        return (x.value, x.timestamp, x.tiebreak)
    if isinstance(x, GSet):
        return x.items
    if isinstance(x, ORSet):
        return x.elements()
    if isinstance(x, VClock):
        return {k: v for k, v in x.clock.items() if v}
    raise TypeError(x)


# --- the CRDT laws, for every type -------------------------------------------


@given(a=gcounters(), b=gcounters())
def test_gcounter_commutative(a, b):
    assert _value(a.merge(b)) == _value(b.merge(a))


@given(a=gcounters(), b=gcounters(), c=gcounters())
def test_gcounter_associative(a, b, c):
    assert _value(a.merge(b).merge(c)) == _value(a.merge(b.merge(c)))


@given(a=gcounters())
def test_gcounter_idempotent(a):
    assert _value(a.merge(a)) == _value(a)


@given(a=pncounters(), b=pncounters())
def test_pncounter_commutative(a, b):
    assert _value(a.merge(b)) == _value(b.merge(a))


@given(a=pncounters(), b=pncounters(), c=pncounters())
def test_pncounter_associative(a, b, c):
    assert _value(a.merge(b).merge(c)) == _value(a.merge(b.merge(c)))


@given(a=pncounters())
def test_pncounter_idempotent(a):
    assert _value(a.merge(a)) == _value(a)


@given(a=lww(), b=lww())
def test_lww_commutative(a, b):
    assert _value(a.merge(b)) == _value(b.merge(a))


@given(a=lww(), b=lww(), c=lww())
def test_lww_associative(a, b, c):
    assert _value(a.merge(b).merge(c)) == _value(a.merge(b.merge(c)))


@given(a=lww())
def test_lww_idempotent(a):
    assert _value(a.merge(a)) == _value(a)


@given(a=gsets(), b=gsets())
def test_gset_commutative(a, b):
    assert _value(a.merge(b)) == _value(b.merge(a))


@given(a=gsets(), b=gsets(), c=gsets())
def test_gset_associative(a, b, c):
    assert _value(a.merge(b).merge(c)) == _value(a.merge(b.merge(c)))


@given(a=gsets())
def test_gset_idempotent(a):
    assert _value(a.merge(a)) == _value(a)


@given(a=orsets(), b=orsets())
def test_orset_commutative(a, b):
    assert _value(a.merge(b)) == _value(b.merge(a))


@given(a=orsets(), b=orsets(), c=orsets())
def test_orset_associative(a, b, c):
    assert _value(a.merge(b).merge(c)) == _value(a.merge(b.merge(c)))


@given(a=orsets())
def test_orset_idempotent(a):
    assert _value(a.merge(a)) == _value(a)


@given(a=vclocks(), b=vclocks())
def test_vclock_commutative(a, b):
    assert _value(a.merge(b)) == _value(b.merge(a))


@given(a=vclocks(), b=vclocks(), c=vclocks())
def test_vclock_associative(a, b, c):
    assert _value(a.merge(b).merge(c)) == _value(a.merge(b.merge(c)))


# --- smoke (no hypothesis needed) ---------------------------------------------


def test_semilattice_laws_smoke():
    """Deterministic spot-check of the merge laws; runs even when the
    property suite above is skipped for lack of hypothesis."""
    a, b, c = GCounter("r0"), GCounter("r1"), GCounter("r2")
    a.increment(3)
    b.increment(5)
    c.increment(7)
    assert a.merge(b).value() == b.merge(a).value() == 8
    assert a.merge(b).merge(c).value() == a.merge(b.merge(c)).value() == 15
    assert a.merge(a).value() == a.value() == 3
    assert merge_all([a, b, c]).value() == 15


# --- behavioural properties ---------------------------------------------------


@given(st.lists(st.integers(0, 1000), min_size=1, max_size=20))
def test_gcounter_convergence(increments):
    """Replicas incremented independently converge to the global sum."""
    replicas = [GCounter(f"r{i}") for i in range(4)]
    for k, amount in enumerate(increments):
        replicas[k % 4].increment(amount)
    merged = merge_all(replicas)
    assert merged.value() == sum(increments)


@given(st.lists(st.integers(-100, 100), min_size=1, max_size=20))
def test_pncounter_convergence(deltas):
    replicas = [PNCounter(f"r{i}") for i in range(3)]
    for k, d in enumerate(deltas):
        replicas[k % 3].increment(d)
    merged = merge_all(replicas)
    assert merged.value() == sum(deltas)


def test_orset_add_wins():
    """A concurrent re-add survives a remove of the earlier observation."""
    a = ORSet().add("x")
    b = a  # replicate
    a2 = a.remove("x")           # replica A removes the observed tag
    b2 = b.add("x")              # replica B concurrently re-adds
    merged = a2.merge(b2)
    assert "x" in merged


def test_vclock_causality():
    a = VClock().tick("r0")
    b = a.tick("r1")
    assert a.happens_before(b)
    assert not b.happens_before(a)
    c = a.tick("r2")
    assert b.concurrent_with(c)


def test_gcounter_rejects_negative():
    import pytest

    g = GCounter("r0")
    with pytest.raises(ValueError):
        g.increment(-1)
