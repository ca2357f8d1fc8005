"""Observability: the serving metrics registry (``metrics``) and the
request-scoped trace context (``context``)."""

from repro_torch.obs.metrics import (OPENMETRICS_CONTENT_TYPE,  # noqa: F401
                                     PROMETHEUS_CONTENT_TYPE,
                                     Counter, Gauge, Histogram,
                                     MetricsRegistry)
