"""Unified observability: metrics registry, Prometheus exposition,
rank-aware JSONL snapshots, the train-loop StepTimer, and request-scoped
tracing. The port's copy of ``paddle_tpu/observability``: the same metric,
span and event catalogs, so a dashboard or alert written for the JAX
server reads the port's unchanged. It imports neither JAX nor the JAX
package; everything here is host-side Python and touches no CUDA tensor.

Importing this package registers the full metric catalog (catalog.py)
into the process-wide default registry — serving engines, the HTTP
front-end, hapi callbacks, the profiler, and bench.py all publish into
the SAME registry, so one ``GET /metrics`` (or one SnapshotWriter line)
is a whole-process snapshot.

Tracing (tracing.py) is the per-request counterpart: a process-wide
Tracer with explicit spans, a bounded ring buffer, W3C traceparent
propagation, and chrome-trace / JSONL export — disabled by default and
free on the hot path until a subscriber (the HTTP server's ``/trace``)
enables it.
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      DEFAULT_LATENCY_BUCKETS, PROMETHEUS_CONTENT_TYPE,
                      get_registry, set_exemplar_provider)
from . import catalog  # noqa: F401  (registers the catalog at import)
from .snapshot import SnapshotWriter, flush_all_writers  # noqa: F401
from .timer import StepTimer  # noqa: F401
from . import tracing  # noqa: F401
from .tracing import (Span, Tracer, get_tracer,  # noqa: F401
                      parse_traceparent, format_traceparent)
from . import flightrecorder  # noqa: F401
from .flightrecorder import (FlightRecorder, IncidentReporter,  # noqa: F401
                             get_recorder, get_reporter, install_reporter,
                             incident_scope, validate_bundle, CudaOom)
from . import timeseries  # noqa: F401
from .timeseries import TimeSeriesStore, get_store  # noqa: F401
from . import alerts  # noqa: F401
from .alerts import AlertManager, SloObjective  # noqa: F401
from . import perf  # noqa: F401
from .perf import (PhaseClock, StepProfiler, get_profiler,  # noqa: F401
                   profile_payload)
from . import kvatlas  # noqa: F401
from .kvatlas import KvAtlas, get_atlas, kvstate_payload  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS", "PROMETHEUS_CONTENT_TYPE",
    "get_registry", "set_exemplar_provider", "catalog", "SnapshotWriter",
    "flush_all_writers", "StepTimer", "tracing", "Span", "Tracer",
    "get_tracer", "parse_traceparent", "format_traceparent",
    "flightrecorder", "FlightRecorder", "IncidentReporter", "get_recorder",
    "get_reporter", "install_reporter", "incident_scope", "validate_bundle",
    "CudaOom", "timeseries", "TimeSeriesStore", "get_store", "alerts",
    "AlertManager", "SloObjective", "perf", "PhaseClock", "StepProfiler",
    "get_profiler", "profile_payload", "kvatlas", "KvAtlas", "get_atlas",
    "kvstate_payload",
]
