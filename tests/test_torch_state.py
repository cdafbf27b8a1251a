"""Event-sourcing properties: replay determinism, snapshot equivalence,
idempotent redelivery, file-backed crash recovery."""

from _hypothesis_support import given, st

from repro_torch.core.state import Event, EventJournal, EventSourcedState, dict_reducer


@st.composite
def event_batches(draw):
    n = draw(st.integers(1, 30))
    out = []
    for _ in range(n):
        kind = draw(st.sampled_from(["set", "incr", "del"]))
        key = draw(st.sampled_from(["a", "b", "c"]))
        if kind == "set":
            data = {"key": key, "value": draw(st.integers(-50, 50))}
        elif kind == "incr":
            data = {"key": key, "amount": draw(st.integers(-5, 5))}
        else:
            data = {"key": key}
        out.append((kind, data))
    return out


@given(event_batches())
def test_replay_determinism(batch):
    s1 = EventSourcedState({}, dict_reducer)
    s2 = EventSourcedState({}, dict_reducer)
    for kind, data in batch:
        s1.record(kind, data)
        s2.record(kind, data)
    assert s1.state == s2.state
    assert s1.replay() == s2.replay()


@given(event_batches(), st.integers(0, 29))
def test_snapshot_equivalence(batch, snap_at):
    """snapshot at k + replay suffix == full replay."""
    full = EventSourcedState({}, dict_reducer)
    snapped = EventSourcedState({}, dict_reducer)
    for i, (kind, data) in enumerate(batch):
        full.record(kind, data)
        snapped.record(kind, data)
        if i == min(snap_at, len(batch) - 1):
            snapped.snapshot()
    assert snapped.replay() == full.state


@given(event_batches())
def test_compaction_preserves_state(batch):
    s = EventSourcedState({}, dict_reducer)
    for kind, data in batch:
        s.record(kind, data)
    before = dict(s.state)
    dropped = s.compact()
    assert dropped == len(batch)
    assert s.replay() == before


def test_replay_determinism_smoke():
    """Deterministic replay check; runs even without hypothesis."""
    batch = [
        ("set", {"key": "a", "value": 1}),
        ("incr", {"key": "a", "amount": 2}),
        ("del", {"key": "b"}),
    ]
    s1 = EventSourcedState({}, dict_reducer)
    s2 = EventSourcedState({}, dict_reducer)
    for kind, data in batch:
        s1.record(kind, data)
        s2.record(kind, data)
    assert s1.state == s2.state == {"a": 3}
    assert s1.replay() == s2.replay()


def test_idempotent_redelivery():
    s = EventSourcedState({}, dict_reducer)
    ev = s.record("incr", {"key": "a", "amount": 5})
    assert s.state == {"a": 5}
    s._apply(ev)  # redeliver the same event
    s._apply(ev)
    assert s.state == {"a": 5}


def test_file_backed_crash_recovery(tmp_path):
    """A new process (new journal object on the same file) recovers state."""
    path = str(tmp_path / "journal.jsonl")
    j1 = EventJournal(path)
    s1 = EventSourcedState({}, dict_reducer, j1)
    s1.record("set", {"key": "step", "value": 41})
    s1.record("incr", {"key": "step", "amount": 1})
    j1.close()
    # "crash" — rebuild everything from the file.
    j2 = EventJournal(path)
    s2 = EventSourcedState({}, dict_reducer, j2)
    assert s2.state == {"step": 42}
    assert s2.applied_seq == 1
    j2.close()


def test_file_backed_truncation(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = EventJournal(path)
    s = EventSourcedState({}, dict_reducer, j)
    for i in range(10):
        s.record("set", {"key": "k", "value": i})
    s.compact()
    s.record("incr", {"key": "k", "amount": 1})
    j.close()
    j2 = EventJournal(path)
    assert len(j2.all_events()) == 1  # only the post-compaction suffix
    j2.close()


def test_event_json_roundtrip():
    ev = Event(seq=3, kind="set", data={"key": "x", "value": [1, 2]}, timestamp=1.5)
    assert Event.from_json(ev.to_json()) == ev
