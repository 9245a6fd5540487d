"""The telemetry plane: the in-process bus (:mod:`.telemetry`)."""
from repro_torch.obs.telemetry import NULL, NullTelemetry, Telemetry  # noqa: F401
