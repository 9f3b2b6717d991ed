"""Run-health monitor (counterpart of repro/health)."""
from repro_torch.health.monitor import (HealthConfig, HealthMonitor,
                                        HealthReport, JsonlHealthSink)

__all__ = ["HealthConfig", "HealthMonitor", "HealthReport",
           "JsonlHealthSink"]
