"""Host-side telemetry for the port: the span tracer, the metrics
registry and the StepMeter, each a trimmed stdlib copy of its
``paddle_tpu.observability`` counterpart."""
from . import metrics, perf, trace

__all__ = ["metrics", "perf", "trace"]
