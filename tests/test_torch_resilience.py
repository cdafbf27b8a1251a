"""Supervision + elasticity unit tests (paper §2.2, §3.2.2)."""

import pytest

from repro_torch.core.elastic import (
    AutoscalerConfig,
    QueueDepthAutoscaler,
    WorkerPoolController,
    detect_stragglers,
)
from repro_torch.core.supervision import (
    HeartbeatDetector,
    PhiAccrualDetector,
    Supervisor,
)

# --- failure detectors ---------------------------------------------------------


def test_heartbeat_detector():
    d = HeartbeatDetector(timeout=5.0)
    assert not d.suspect(100.0)  # never beat: not suspect (not started)
    d.observe(100.0)
    assert not d.suspect(104.0)
    assert d.suspect(105.1)


def test_phi_accrual_grows_with_silence():
    d = PhiAccrualDetector(threshold=8.0)
    for t in range(20):  # steady 1s heartbeats
        d.observe(float(t))
    assert d.phi(19.5) < 1.0
    assert d.phi(20.5) < 8.0
    assert d.phi(40.0) > 8.0
    assert d.suspect(40.0)


def test_phi_adapts_to_jitter():
    """Jittery-but-alive links should not be declared dead too eagerly."""
    steady = PhiAccrualDetector()
    jittery = PhiAccrualDetector()
    for t in range(40):
        steady.observe(float(t))
    for t in range(0, 80, 2):  # 2s cadence with the same final beat time
        jittery.observe(float(t))
    probe = 82.0
    assert jittery.phi(probe) < steady.phi(probe)


# --- supervisor ------------------------------------------------------------------


def test_supervisor_restarts_silent_child():
    restarts = []
    sup = Supervisor()
    sup.supervise("w1", restart=lambda: restarts.append("w1"),
                  detector=HeartbeatDetector(3.0))
    sup.heartbeat("w1", 0.0)
    assert sup.check(1.0) == []
    assert sup.check(10.0) == ["w1"]
    assert restarts == ["w1"]
    # restart counted as a beat; no immediate re-restart
    assert sup.check(11.0) == []


def test_supervisor_gives_up_after_max_restarts():
    sup = Supervisor()
    sup.supervise("w1", restart=lambda: None,
                  detector=HeartbeatDetector(1.0), max_restarts=2)
    sup.heartbeat("w1", 0.0)
    t = 0.0
    restarted = 0
    for _ in range(5):
        t += 10.0
        restarted += len(sup.check(t))
    assert restarted == 2
    assert "w1" not in sup.alive_children()
    assert any(e[1] == "gave_up" for e in sup.events)


def test_supervisor_recovery_event_on_late_beat():
    sup = Supervisor()
    child = sup.supervise("w1", restart=lambda: None,
                          detector=HeartbeatDetector(1.0), max_restarts=0)
    sup.heartbeat("w1", 0.0)
    sup.check(10.0)
    assert not child.alive
    sup.heartbeat("w1", 11.0)
    assert child.alive
    assert any(e[1] == "recovered" for e in sup.events)


# --- autoscaler ---------------------------------------------------------------


def test_autoscaler_scales_out_on_backlog():
    a = QueueDepthAutoscaler(AutoscalerConfig(high_watermark=10, cooldown=0))
    d = a.decide([50, 60, 40], now=0.0)
    assert d.action == "scale_out"
    assert d.delta >= 1


def test_autoscaler_scales_in_when_idle():
    a = QueueDepthAutoscaler(
        AutoscalerConfig(low_watermark=2, min_workers=1, cooldown=0)
    )
    d = a.decide([0, 0, 1, 0], now=0.0)
    assert d.action == "scale_in"


def test_autoscaler_cooldown_and_bounds():
    cfg = AutoscalerConfig(high_watermark=1, cooldown=100, max_workers=4)
    a = QueueDepthAutoscaler(cfg)
    assert a.decide([100, 100], now=0.0).action == "scale_out"
    assert a.decide([100, 100], now=1.0).action == "hold"  # cooling down
    ctrl = WorkerPoolController(2, cfg)
    for t in (200.0, 400.0, 600.0):
        ctrl.observe([100] * ctrl.target_size, now=t)
    assert ctrl.target_size <= 4  # max bound respected


def test_straggler_detection_flags_slow_worker():
    rates = {f"w{i}": 100.0 for i in range(8)}
    rates["w7"] = 3.0
    report = detect_stragglers(rates, k=3.0)
    assert report.straggler_ids == ("w7",)


def test_straggler_detection_ignores_small_pools():
    assert detect_stragglers({"a": 1.0, "b": 100.0}).straggler_ids == ()


def test_straggler_detection_uniform_pool_clean():
    rates = {f"w{i}": 50.0 for i in range(10)}
    assert detect_stragglers(rates).straggler_ids == ()
