"""The telemetry plane: the in-process bus (:mod:`.telemetry`) and its
export surfaces — the Chrome trace (:mod:`.trace`), Prometheus
(:mod:`.prom`) and the live STATS client behind ``python -m repro_torch
top`` (:mod:`.top`, imported lazily: it pulls in the cluster wire code,
which itself depends on this package)."""
from repro_torch.obs.telemetry import NULL, NullTelemetry, Telemetry
from repro_torch.obs.trace import chrome_trace, write_chrome_trace

__all__ = ["NULL", "NullTelemetry", "Telemetry", "chrome_trace",
           "write_chrome_trace"]
