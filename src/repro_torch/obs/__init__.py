"""Fixpoint observability: tracing, metrics, exporters, calibration.

A :class:`~repro_torch.obs.trace.Tracer` attached to ``ShardedExecutor``
records one span per stratum (host wall, and device time from CUDA events
on the card); a :class:`~repro_torch.obs.metrics.MetricsRegistry`
accumulates counters, gauges and histograms; ``obs.export`` renders
Perfetto-loadable timelines and flat metric dumps; and ``obs.calibrate``
turns measured route timings into the dispatch table behind
``route_strategy="measured"``.

Everything is opt-in: with no tracer or registry attached (the default)
the engine runs exactly as it does without this package.
"""
from repro_torch.obs.calibrate import (RouteCostTable,
                                       calibrate_executor_table,
                                       calibrate_route_table)
from repro_torch.obs.export import (metrics_to_json, to_chrome_trace,
                                    write_chrome_trace, write_metrics)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry,
                                     reset_default_registry)
from repro_torch.obs.trace import MeasuredLatencies, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "reset_default_registry",
    "Tracer", "MeasuredLatencies",
    "to_chrome_trace", "write_chrome_trace", "metrics_to_json",
    "write_metrics",
    "RouteCostTable", "calibrate_route_table", "calibrate_executor_table",
]
