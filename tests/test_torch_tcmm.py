"""The port's TCMM app (``repro_torch.apps.tcmm``) and the Reactive Liquid
pipelines it runs on, against the reference package on the CPU.  Both
packages get the same points (numpy from a seed); event lists must be
equal, and the cluster-feature vectors n, LS and SS bit-equal.  The
k-means start is the one thing the port cannot draw as JAX does: where a
test compares macro clustering, the port's ``kmeans_init`` is replaced by
one that returns JAX's draw."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.apps import tcmm as jax_tcmm  # noqa: E402
from repro.configs.tcmm import TCMMConfig as JaxTCMMConfig  # noqa: E402
from repro.core.liquid import LiquidJob as JaxLiquidJob  # noqa: E402
from repro.core.reactive import ReactiveJob as JaxReactiveJob  # noqa: E402
from repro.data.sources import TrajectorySource as JaxTrajectorySource  # noqa: E402
from repro.data.topics import MessageLog as JaxMessageLog  # noqa: E402
from repro_torch.apps import tcmm  # noqa: E402
from repro_torch.configs.tcmm import TCMMConfig  # noqa: E402
from repro_torch.core.liquid import LiquidJob  # noqa: E402
from repro_torch.core.messages import Message  # noqa: E402
from repro_torch.core.reactive import ReactiveJob  # noqa: E402
from repro_torch.data.sources import TrajectorySource  # noqa: E402
from repro_torch.data.topics import MessageLog  # noqa: E402
from repro_torch.telemetry.metrics import MetricsHub, MetricsReplica  # noqa: E402

JAX = dict(tcmm=jax_tcmm, cfg=JaxTCMMConfig, liquid=JaxLiquidJob, reactive=JaxReactiveJob,
           source=JaxTrajectorySource, log=JaxMessageLog, kw={})
PORT = dict(tcmm=tcmm, cfg=TCMMConfig, liquid=LiquidJob, reactive=ReactiveJob,
            source=TrajectorySource, log=MessageLog, kw={"device": "cpu"})


def jax_kmeans_init(weights, k, seed):
    """The start the reference's ``kmeans`` draws from the same weights."""
    w = jnp.asarray(weights.cpu().numpy())
    idx = jax.random.choice(jax.random.PRNGKey(seed), w.shape[0], (k,), replace=False,
                            p=w / w.sum())
    return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(weights.device)


@pytest.fixture
def jax_start(monkeypatch):
    monkeypatch.setattr(tcmm, "kmeans_init", jax_kmeans_init)


def assert_state_equal(port_state, jax_state):
    got = port_state.to_numpy()
    for name in ("n", "ls", "ss"):
        assert got[name].dtype == np.float32
        assert np.array_equal(got[name], getattr(jax_state, name)), name
    assert got["num_active"] == jax_state.num_active
    assert got["processed"] == jax_state.processed


# --- sources ------------------------------------------------------------------


def test_trajectory_source_keys_and_features():
    src = TrajectorySource(num_taxis=10, seed=1)
    pts = list(src.stream(50))
    assert len(pts) == 50
    keys = {k for k, _ in pts}
    assert len(keys) == 10
    assert all(len(v) == 4 for _, v in pts)


@pytest.mark.parametrize("num_taxis,seed", [(10, 1), (30, 2), (10357, 0)])
def test_trajectory_source_gives_the_reference_points(num_taxis, seed):
    ours = list(TrajectorySource(num_taxis=num_taxis, seed=seed).stream(700))
    theirs = list(JaxTrajectorySource(num_taxis=num_taxis, seed=seed).stream(700))
    assert ours == theirs


# --- micro-clustering -----------------------------------------------------------


def blob_points(n=600):
    rng = np.random.default_rng(0)
    centers = np.asarray([[0.0, 0.0], [20.0, 0.0], [0.0, 20.0]])
    return [(centers[i % 3] + rng.normal(0, 0.5, 2)).astype(np.float32) for i in range(n)]


def test_micro_clustering_converges_on_blobs():
    kw = dict(max_micro_clusters=64, distance_threshold=3.0, feature_dim=2)
    state = tcmm.MicroClusterState(TCMMConfig(**kw), device="cpu")
    ref = jax_tcmm.MicroClusterState(JaxTCMMConfig(**kw))
    events = [state.ingest(p) for p in blob_points()]
    assert events == [ref.ingest(p) for p in blob_points()]
    assert 3 <= state.num_active <= 12  # a few micro-clusters per blob
    assert state.processed == 600
    assert_state_equal(state, ref)


def test_micro_state_event_replay_equivalence():
    """Event sourcing: replaying the change log rebuilds the exact state."""
    kw = dict(max_micro_clusters=32, distance_threshold=2.0, feature_dim=2)
    cfg = TCMMConfig(**kw)
    rng = np.random.default_rng(1)
    points = [rng.normal(0, 5, 2).astype(np.float32) for _ in range(200)]
    state = tcmm.MicroClusterState(cfg, device="cpu")
    events = [state.ingest(p) for p in points]
    ref = jax_tcmm.MicroClusterState(JaxTCMMConfig(**kw))
    assert events == [ref.ingest(p) for p in points]
    rebuilt = tcmm.MicroClusterState.replay(cfg, events, device="cpu")
    for name in ("n", "ls", "ss"):
        assert torch.equal(getattr(rebuilt, name), getattr(state, name))
    assert rebuilt.num_active == state.num_active
    assert_state_equal(rebuilt, ref)


def test_every_search_goes_through_the_kernel_wrapper(monkeypatch):
    """Each ingest after the first (which meets an empty table) calls the
    ``tcmm_assign`` wrapper once with one point; the wrapper alone picks the
    kernel or its plain version from the tensors' device."""
    from repro_torch.kernels.tcmm_assign import ops as assign_ops
    calls = []
    wrapped = assign_ops.tcmm_assign

    def counting(points, centroids, valid):
        calls.append(tuple(points.shape))
        return wrapped(points, centroids, valid)

    monkeypatch.setattr(assign_ops, "tcmm_assign", counting)
    cfg = TCMMConfig(max_micro_clusters=32, distance_threshold=2.0, feature_dim=2)
    st = tcmm.MicroClusterState(cfg, device="cpu")
    for p in blob_points(300):
        st.ingest(p)
    assert calls == [(1, 2)] * 299


def test_carried_state_continues_like_the_reference():
    """The reference's state after 300 points, carried across with
    ``from_numpy``, gives the reference's events for the next 300, and
    ``to_numpy`` hands back what the reference holds."""
    points = [np.asarray(p, np.float32)
              for _, p in JaxTrajectorySource(num_taxis=40, seed=3).stream(600)]
    kw = dict(max_micro_clusters=64, distance_threshold=4.0)
    ref = jax_tcmm.MicroClusterState(JaxTCMMConfig(**kw))
    for p in points[:300]:
        ref.ingest(p)
    port = tcmm.MicroClusterState.from_numpy(
        TCMMConfig(**kw), ref.n, ref.ls, ref.ss, ref.num_active, ref.processed, device="cpu")
    assert_state_equal(port, ref)
    assert [port.ingest(p) for p in points[300:]] == [ref.ingest(p) for p in points[300:]]
    assert_state_equal(port, ref)


def test_real_scale_stream_fills_the_table_with_equal_events():
    """T-Drive's taxi count with the default config (M = 512): the table
    fills (every later search scans all rows), and the events stay equal."""
    points = [np.asarray(p, np.float32)
              for _, p in TrajectorySource(num_taxis=10357, seed=0).stream(1500)]
    port = tcmm.MicroClusterState(TCMMConfig(max_micro_clusters=128), device="cpu")
    ref = jax_tcmm.MicroClusterState(JaxTCMMConfig(max_micro_clusters=128))
    assert [port.ingest(p) for p in points] == [ref.ingest(p) for p in points]
    assert port.num_active == 128
    assert_state_equal(port, ref)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tcmm.MicroClusterState(TCMMConfig()),
                 lambda: tcmm.MicroClusterJob(TCMMConfig()),
                 lambda: tcmm.MacroClusterJob(TCMMConfig()),
                 lambda: tcmm.MicroClusterState.replay(TCMMConfig(), [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# --- macro-clustering -----------------------------------------------------------


def macro_inputs(seed=4, m=60, f=4):
    rng = np.random.default_rng(seed)
    cents = (rng.standard_normal((m, f)) * 10).astype(np.float32)
    weights = rng.integers(1, 40, size=m).astype(np.float32)
    return cents, weights


@pytest.mark.parametrize("k,iters", [(8, 8), (5, 3), (3, 1)])
def test_kmeans_from_jax_start_matches_reference(k, iters):
    cents, weights = macro_inputs()
    j_centers, j_assign = jax_tcmm.kmeans(jnp.asarray(cents), jnp.asarray(weights), k, iters,
                                          seed=0)
    tw = torch.from_numpy(weights)
    init = jax_kmeans_init(tw, k, 0)
    centers, assign = tcmm.kmeans(torch.from_numpy(cents), tw, k, iters, init_idx=init)
    # bit-equal in every run measured so far; the sums run in another order
    # than XLA's, so the check allows f32 rounding
    np.testing.assert_allclose(centers.numpy(), np.asarray(j_centers), rtol=1e-6)
    assert assign.tolist() == np.asarray(j_assign).tolist()


def test_kmeans_returns_the_assignment_before_the_last_update():
    cents, weights = macro_inputs(5)
    tc, tw = torch.from_numpy(cents), torch.from_numpy(weights)
    init = jax_kmeans_init(tw, 6, 0)
    before, _ = tcmm.kmeans(tc, tw, 6, 4, init_idx=init)
    after, assign = tcmm.kmeans(tc, tw, 6, 5, init_idx=init)
    from repro_torch.kernels.tcmm_assign.ref import squared_distances
    assert torch.equal(assign, torch.argmin(squared_distances(tc, before), dim=1))
    assert not torch.equal(after, before)


def test_kmeans_keeps_an_empty_centre():
    tc = torch.tensor([[0.0, 0.0], [0.1, 0.0], [10.0, 0.0]])
    tw = torch.ones(3)
    # centres 1 and 2 start on the same point: the first index takes it all
    centers, _ = tcmm.kmeans(tc, tw, 3, 2, init_idx=torch.tensor([0, 2, 2]))
    assert torch.equal(centers[2], tc[2])
    assert torch.equal(centers[1], tc[2])


def test_kmeans_draws_its_own_start_without_jax():
    cents, weights = macro_inputs(6)
    tc, tw = torch.from_numpy(cents), torch.from_numpy(weights)
    idx = tcmm.kmeans_init(tw, 8, 0)
    assert idx.shape == (8,) and len(set(idx.tolist())) == 8
    assert torch.equal(idx, tcmm.kmeans_init(tw, 8, 0))
    a, _ = tcmm.kmeans(tc, tw, 8, 4, seed=0)
    b, _ = tcmm.kmeans(tc, tw, 8, 4, init_idx=idx)
    assert torch.equal(a, b)


def test_macro_job_matches_reference(jax_start):
    points = [np.asarray(p, np.float32)
              for _, p in JaxTrajectorySource(num_taxis=30, seed=2).stream(600)]
    kw = dict(max_micro_clusters=128, distance_threshold=4.0, num_macro_clusters=4,
              macro_period=64)
    ref_micro = jax_tcmm.MicroClusterState(JaxTCMMConfig(**kw))
    events = [ref_micro.ingest(p) for p in points]
    macro = tcmm.MacroClusterJob(TCMMConfig(**kw), device="cpu")
    ref = jax_tcmm.MacroClusterJob(JaxTCMMConfig(**kw))
    for ev in events:
        out = macro(Message(topic="micro-changes", payload=ev))
        want = ref(Message(topic="micro-changes", payload=ev))
        assert len(out) == len(want)
        for o, w in zip(out, want):
            np.testing.assert_allclose(o["centers"], w["centers"], rtol=1e-6)
    assert macro.macro_runs == ref.macro_runs == 600 // 64
    assert_state_equal(macro.replica, ref.replica)


# --- pipelines --------------------------------------------------------------------


def run_two_stage(pkg, n_points=600):
    """tests/test_data_and_tcmm.py::test_tcmm_two_stage_pipeline_on_reactive,
    run on either package."""
    cfg = pkg["cfg"](max_micro_clusters=128, distance_threshold=4.0,
                     feature_dim=4, num_macro_clusters=4, macro_period=128)
    log = pkg["log"]()
    log.create_topic("trajectories", 3)
    log.create_topic("micro-changes", 3)
    for key, point in pkg["source"](num_taxis=30, seed=2).stream(n_points):
        log.publish("trajectories", payload=point, key=key)
    micro = pkg["tcmm"].MicroClusterJob(cfg, **pkg["kw"])
    macro = pkg["tcmm"].MacroClusterJob(cfg, **pkg["kw"])
    micro_job = pkg["reactive"]("micro", log, "trajectories", micro,
                                out_topic="micro-changes", initial_tasks=1, elastic=False)
    macro_job = pkg["reactive"]("macro", log, "micro-changes", macro,
                                initial_tasks=1, elastic=False)
    for r in range(2000):
        micro_job.step(now=float(r))
        macro_job.step(now=float(r))
        if micro_job.backlog() == 0 and macro_job.backlog() == 0:
            break
    return log, micro, macro


def topic_contents(log, name):
    return [[m.payload for m in p.read(0, p.end_offset())] for p in log.get(name).partitions]


def test_tcmm_two_stage_pipeline_on_reactive(jax_start):
    """The paper's exact wiring: trajectories -> micro job -> changes topic
    -> macro job, on the Reactive Liquid stack, in both packages."""
    log, micro, macro = run_two_stage(PORT)
    assert micro.state.processed == 600
    assert macro.replica.processed == 600
    assert macro.macro_runs >= 1
    assert macro.macro_centers.shape == (4, 4)
    j_log, j_micro, j_macro = run_two_stage(JAX)
    assert topic_contents(log, "micro-changes") == topic_contents(j_log, "micro-changes")
    assert_state_equal(micro.state, j_micro.state)
    assert macro.macro_runs == j_macro.macro_runs
    np.testing.assert_allclose(macro.macro_centers, j_macro.macro_centers, rtol=1e-6)


def test_tcmm_on_liquid_baseline_same_results():
    """Liquid and Reactive produce identical micro-cluster state (the
    architecture changes throughput, not semantics), and both equal the
    reference package's."""
    def run(pkg, job_cls, **kw):
        cfg = pkg["cfg"](max_micro_clusters=64, distance_threshold=4.0, feature_dim=4)
        log = pkg["log"]()
        log.create_topic("t", 1)
        for key, p in pkg["source"](num_taxis=10, seed=5).stream(200):
            log.publish("t", payload=p, key=key)
        micro = pkg["tcmm"].MicroClusterJob(cfg, **pkg["kw"])
        job = pkg[job_cls]("m", log, "t", micro, **kw)
        job.run_to_completion()
        return micro.state

    a = run(PORT, "liquid", num_tasks=1)
    b = run(PORT, "reactive", initial_tasks=1, elastic=False)
    for name in ("n", "ls", "ss"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert_state_equal(a, run(JAX, "liquid", num_tasks=1))
    assert_state_equal(b, run(JAX, "reactive", initial_tasks=1, elastic=False))


def run_quickstart(pkg, n_points=1200):
    """examples/quickstart.py on either package: 3 partitions each way, an
    elastic micro job of 4 tasks, task 0 killed past a third."""
    log = pkg["log"]()
    log.create_topic("trajectories", 3)
    log.create_topic("micro-changes", 3)
    for key, point in pkg["source"](num_taxis=50, seed=0).stream(n_points):
        log.publish("trajectories", payload=point, key=key)
    cfg = pkg["cfg"](max_micro_clusters=256, distance_threshold=4.0,
                     num_macro_clusters=6, macro_period=256)
    micro = pkg["tcmm"].MicroClusterJob(cfg, **pkg["kw"])
    macro = pkg["tcmm"].MacroClusterJob(cfg, **pkg["kw"])
    micro_job = pkg["reactive"]("micro", log, "trajectories", micro,
                                out_topic="micro-changes", initial_tasks=4,
                                scheduler="jsq", heartbeat_timeout=3.0)
    macro_job = pkg["reactive"]("macro", log, "micro-changes", macro,
                                initial_tasks=2, heartbeat_timeout=3.0)
    killed, t, sizes = False, 0.0, []
    while micro_job.backlog() or macro_job.backlog() or t == 0.0:
        t += 1.0
        micro_job.step(now=t)
        macro_job.step(now=t)
        sizes.append((len(micro_job.tasks), len(macro_job.tasks)))
        if not killed and micro.state.processed > n_points // 3:
            micro_job.tasks[0].alive = False
            killed = True
        assert t <= 10_000
    return dict(log=log, micro=micro, macro=macro, sizes=sizes,
                supervisor=[e[1] for e in micro_job.supervisor.events],
                committed=micro_job.stage.committed_offsets(),
                ends=log.get("trajectories").end_offsets())


def test_quickstart_pipeline_equals_reference(jax_start):
    port, ref = run_quickstart(PORT), run_quickstart(JAX)
    assert port["micro"].state.processed == 1200 == port["macro"].replica.processed
    assert "restarted" in port["supervisor"]
    assert port["committed"] == dict(enumerate(port["ends"]))
    assert topic_contents(port["log"], "micro-changes") == \
        topic_contents(ref["log"], "micro-changes")
    assert port["supervisor"] == ref["supervisor"]
    assert port["sizes"] == ref["sizes"]
    assert_state_equal(port["micro"].state, ref["micro"].state)
    assert port["macro"].macro_runs == ref["macro"].macro_runs >= 1
    np.testing.assert_allclose(port["macro"].macro_centers, ref["macro"].macro_centers,
                               rtol=1e-6)


# --- telemetry -----------------------------------------------------------------


def test_metrics_merge_survives_restart():
    hub = MetricsHub()
    w1 = MetricsReplica("w1")
    w1.incr("messages", 10)
    hub.ingest(w1)
    hub.ingest(w1)  # duplicate ingest is idempotent (G-Counter max-merge)
    assert hub.counter("messages") == 10
    # worker restarts with empty replica, does more work
    w1b = MetricsReplica("w1")
    w1b.counters["messages"] = w1.counters["messages"]  # journal recovery
    w1b.incr("messages", 5)
    hub.ingest(w1b)
    assert hub.counter("messages") == 15


def test_metrics_gauges_lww():
    hub = MetricsHub()
    a, b = MetricsReplica("a"), MetricsReplica("b")
    a.gauge("loss", 3.5, timestamp=10.0)
    b.gauge("loss", 3.1, timestamp=11.0)
    hub.ingest(a)
    hub.ingest(b)
    assert hub.gauge("loss") == 3.1  # newest write wins
