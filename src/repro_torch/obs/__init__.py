"""Observability (the port of ``repro.obs``): host spans and metrics.

One :class:`Observability` object bundles the two sinks a subsystem writes
into:

- ``obs.tracer`` — nested wall-clock spans exported as Chrome/Perfetto
  trace JSON (:mod:`repro_torch.obs.trace`), optionally mirrored into
  ``torch.profiler.record_function`` so a profiler trace of the card lines
  up under them;
- ``obs.registry`` — counters/gauges/streaming histograms with JSONL
  export and a plain-text summary table (:mod:`repro_torch.obs.metrics`).

Call sites take ``obs=None`` and bind ``NULL_TRACER`` when absent, so an
un-observed run pays nothing. Span names are ``<subsystem>.<signal>``,
metric names ``<subsystem>/<signal>``.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsLogger,
                                     Registry)
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsLogger", "Registry",
           "Tracer", "NULL_TRACER", "Observability"]


class Observability:
    """Tracer + registry bundle with one-call export.

    ``annotate_device=True`` additionally wraps every span in a
    ``torch.profiler.record_function`` of the same name.
    """

    def __init__(self, *, trace: bool = True,
                 annotate_device: bool = False):
        self.tracer = Tracer(enabled=trace,
                             annotate_device=annotate_device)
        self.registry = Registry()

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    def clear(self) -> None:
        """Drop recorded spans and metrics (e.g. between a warm-up run and
        the measured one) without rebinding call sites."""
        self.tracer.clear()
        self.registry.clear()

    def write(self, trace_path: str = "", metrics_path: str = "") -> None:
        if trace_path:
            self.tracer.write_chrome(trace_path)
        if metrics_path:
            self.registry.write_jsonl(metrics_path)

    def summary(self) -> str:
        return self.registry.summary_table()
