from repro_torch.telemetry.metrics import MetricsReplica, MetricsHub
from repro_torch.telemetry.profile import StepTimer
