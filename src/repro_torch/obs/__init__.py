"""Observability layer of the port: spans, metrics, step-shape probes,
sinks.  Port of ``repro.obs``.

The paper's methodology in library form: per-phase breakdowns (its
Tables 5/6) as first-class, reproducible artifacts:

* :class:`Tracer` / :class:`Span`: hierarchical timing that synchronises
  the CUDA devices of ``sp.sync(tensors)`` at span exit, so queued kernels
  are charged to the phase that launched them;
* :class:`MetricsRegistry`: counters, gauges, bounded histograms with
  p50/p95/p99;
* :class:`RecompileProbe`: one count per distinct step shape;
* sinks: JSONL event logs and Chrome-trace JSON (Perfetto-loadable).

Everything is **disabled by default with near-zero overhead**.  Three ways
to turn tracing on:

* ``TSNE(trace=True)`` (or ``trace="fit_trace.json"`` to also write the
  Chrome trace): a per-estimator tracer, exposed as ``est.tracer_``;
* ``TSNE_TRACE=1`` in the environment: enables the process-global tracer
  that instrumented code uses when no explicit tracer is passed;
* ``python -m repro_torch.embed.service --smoke --trace out.json``.

The process-global instruments live here: :func:`get_tracer` /
:func:`get_metrics` (used by instrumented modules when not handed an
explicit tracer), :func:`set_tracer` to swap in an enabled one.
"""
from __future__ import annotations

import os

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.tracer import NULL_SPAN, Span, Tracer


def env_trace_enabled() -> bool:
    """True when the ``TSNE_TRACE`` env var requests tracing (any value
    but empty / ``0`` / ``false`` / ``off``)."""
    v = os.environ.get("TSNE_TRACE", "").strip().lower()
    return v not in ("", "0", "false", "off")


_global_tracer = Tracer(enabled=env_trace_enabled())
_global_metrics = MetricsRegistry()


def get_tracer() -> Tracer:
    """The process-global tracer (disabled unless ``TSNE_TRACE`` is set or
    :func:`set_tracer` installed an enabled one)."""
    return _global_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process-global tracer; returns it."""
    global _global_tracer
    _global_tracer = tracer
    return tracer


def get_metrics() -> MetricsRegistry:
    """The process-global metrics registry (always collecting: metric
    updates are a few arithmetic ops on host values, never device syncs)."""
    return _global_metrics


def trace(name: str, **attrs):
    """Open a span on the global tracer: ``with trace("knn") as sp:``.
    A no-op (shared null span) while the global tracer is disabled."""
    return _global_tracer.span(name, **attrs)


# imported late: RecompileProbe registers on the global metrics registry
from repro_torch.obs.recompile import RecompileProbe  # noqa: E402

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_SPAN", "Span", "Tracer", "RecompileProbe",
    "env_trace_enabled", "get_metrics", "get_tracer", "set_tracer", "trace",
]
