"""Host-side telemetry for the port: the span tracer and the metrics
registry, each a trimmed stdlib copy of its ``paddle_tpu.observability``
counterpart."""
from . import metrics, trace

__all__ = ["metrics", "trace"]
