"""Hierarchical span tracer, the timing substrate of the obs layer: port of
``repro/obs/tracer.py``.

The source paper's analysis lives on per-step breakdowns (Tables 5/6):
knowing *which* phase dominates is what directed every optimization.  This
module makes that analysis reproducible on the port's hot paths: every
phase of a fit (knn / bsp / symmetrize / gradient_descent), a transform
batch, or a service tick opens a :class:`Span`:

    tracer = Tracer()
    with tracer.span("knn") as sp:
        idx, d2 = backend.neighbors(x, k)
        sp.sync((idx, d2))      # the card synchronised at span exit
    tracer.durations()["knn"]   # seconds

Two properties matter on a CUDA hot path:

* **device-sync-aware timing**: PyTorch queues CUDA kernels and returns,
  so a ``perf_counter`` pair around a call times the enqueue, and the
  work surfaces inside whatever phase next copies to the host (the knn
  phase's pairwise tiles would be charged to ``symmetrize``'s ``.cpu()``).
  ``sp.sync(value)`` registers tensors (a tensor, or tuples, lists, dicts,
  NamedTuples or dataclasses holding them) whose CUDA devices are
  synchronised at span exit, *before* the end timestamp is read, so work
  is attributed to the phase that launched it.  CPU tensors need nothing.
  Nothing is synchronised at span entry.
* **near-zero disabled overhead**: a disabled tracer's ``span()`` returns
  one reusable no-op context manager (no allocation, no clock read, no
  sync), so instrumentation can stay in production code unconditionally.

Spans nest through a per-thread stack; each completed span records its
parent index and depth, which the exporters turn into a hierarchy:
:meth:`Tracer.to_jsonl` writes one JSON object per span, and
:meth:`Tracer.to_chrome_trace` writes Chrome-trace JSON (``traceEvents``
with ``ph: "X"`` complete events) loadable in Perfetto / ``chrome://tracing``.
Span attributes are host values: a CUDA tensor there would be a hidden
sync when exported, so export refuses one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable

import torch


class _NullSpan:
    """Reusable no-op span: the entire disabled-mode surface."""

    __slots__ = ()
    enabled = False

    def annotate(self, **attrs) -> "_NullSpan":
        return self

    def sync(self, value):
        return value

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One timed region.  Created by :meth:`Tracer.span`; closed by the
    context manager, which first synchronises the CUDA devices of every
    value registered through :meth:`sync`, so queued device work lands
    inside the span that launched it."""

    __slots__ = ("name", "t0", "t1", "depth", "index", "parent", "attrs",
                 "_sync_targets")
    enabled = True

    def __init__(self, name: str, t0: float, depth: int, index: int,
                 parent: int, attrs: dict):
        self.name = name
        self.t0 = t0
        self.t1: float | None = None
        self.depth = depth
        self.index = index
        self.parent = parent          # index of enclosing span, -1 at root
        self.attrs = attrs
        self._sync_targets: list = []

    def annotate(self, **attrs) -> "Span":
        """Attach key/value metadata (lands in ``args`` of the trace event)."""
        self.attrs.update(attrs)
        return self

    def sync(self, value):
        """Register ``value`` (tensors, possibly nested in tuples, lists,
        dicts, NamedTuples or dataclasses) whose CUDA devices are
        synchronised at span exit; returns ``value`` unchanged so it can
        wrap an expression in place."""
        self._sync_targets.append(value)
        return value

    @property
    def duration_s(self) -> float:
        if self.t1 is None:
            raise RuntimeError(f"span {self.name!r} is still open")
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        d = dict(name=self.name, ts=self.t0, dur=self.duration_s,
                 depth=self.depth, index=self.index, parent=self.parent)
        if self.attrs:
            d["attrs"] = self.attrs
        return d


def cuda_devices(value, out: set | None = None) -> set:
    """The CUDA devices of the tensors in ``value`` (a tensor, or tuples,
    lists, dicts, NamedTuples or dataclass instances holding tensors)."""
    out = set() if out is None else out
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            cuda_devices(v, out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            cuda_devices(getattr(value, f.name), out)
    return out


class _SpanCtx:
    """Binds one Span to a (tracer, thread-stack) for with-statement use."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._push(self._span)
        return self._span

    def __exit__(self, *exc) -> bool:
        self._tracer._pop(self._span)
        return False


class Tracer:
    """Collects nested spans; export through :meth:`to_jsonl` /
    :meth:`to_chrome_trace`, aggregate through :meth:`durations`.

    Thread-safe: each thread nests on its own stack (Chrome-trace ``tid``),
    completed spans append under a lock.  ``clock`` is injectable for
    deterministic tests.
    """

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = enabled
        self._clock = clock
        self.spans: list[Span] = []      # completed, in close order
        self._local = threading.local()
        self._lock = threading.Lock()
        self._n_started = 0
        self.t_epoch = clock()           # ts base for exported traces

    # ------------------------------------------------------------ record --

    def _stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs):
        """Open a span named ``name``.  Disabled tracers return the shared
        no-op span: zero allocation, no clock read, no sync."""
        if not self.enabled:
            return NULL_SPAN
        stack = self._stack()
        parent = stack[-1].index if stack else -1
        with self._lock:
            index = self._n_started
            self._n_started += 1
        sp = Span(name, self._clock(), depth=len(stack), index=index,
                  parent=parent, attrs=dict(attrs))
        return _SpanCtx(self, sp)

    def _push(self, sp: Span) -> None:
        self._stack().append(sp)

    def _pop(self, sp: Span) -> None:
        if sp._sync_targets:
            devices = set()
            for target in sp._sync_targets:
                cuda_devices(target, devices)
            for dev in devices:
                torch.cuda.synchronize(dev)
            sp._sync_targets.clear()
        sp.t1 = self._clock()
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        with self._lock:
            self.spans.append(sp)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()

    def _snapshot(self) -> list[Span]:
        """Consistent copy of the completed spans (``_pop`` appends from
        worker threads under the same lock)."""
        with self._lock:
            return list(self.spans)

    # ----------------------------------------------------------- inspect --

    def find(self, name: str) -> list[Span]:
        return [s for s in self._snapshot() if s.name == name]

    def last(self, name: str) -> Span | None:
        for s in reversed(self._snapshot()):
            if s.name == name:
                return s
        return None

    def durations(self) -> dict[str, float]:
        """Total seconds per span name (summed over occurrences)."""
        out: dict[str, float] = {}
        for s in self._snapshot():
            out[s.name] = out.get(s.name, 0.0) + s.duration_s
        return out

    # ------------------------------------------------------------ export --

    def to_jsonl(self, path) -> None:
        """One JSON object per completed span (ts/dur in seconds, relative
        to the tracer epoch)."""
        with open(path, "w") as f:
            for s in self._snapshot():
                d = s.to_dict()
                d["ts"] = d["ts"] - self.t_epoch
                f.write(json.dumps(d) + "\n")

    def chrome_trace(self, process_name: str = "tsne") -> dict:
        """Chrome-trace dict: ``traceEvents`` of complete (``ph: "X"``)
        events, one per span, ts/dur in microseconds.  Nesting is implied by
        time containment per ``tid``, which holds because spans nest on a
        per-thread stack."""
        pid = os.getpid()
        events: list[dict] = [dict(
            name="process_name", ph="M", pid=pid, tid=0,
            args=dict(name=process_name),
        )]
        for s in sorted(self._snapshot(), key=lambda s: s.t0):
            ev = dict(
                name=s.name, ph="X", pid=pid, tid=0, cat="phase",
                ts=round((s.t0 - self.t_epoch) * 1e6, 3),
                dur=round(s.duration_s * 1e6, 3),
            )
            if s.attrs:
                ev["args"] = {k: _jsonable(v) for k, v in s.attrs.items()}
            events.append(ev)
        return dict(traceEvents=events, displayTimeUnit="ms")

    def to_chrome_trace(self, path, process_name: str = "tsne") -> None:
        """Write :meth:`chrome_trace` JSON, loadable in Perfetto."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(process_name), f)


def _jsonable(v: Any):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, torch.Tensor) and v.is_cuda:
        raise TypeError("span attributes are host values: reading a CUDA tensor "
                        "here would synchronise the device")
    try:
        return float(v)       # numpy / CPU torch scalars
    except (TypeError, ValueError):
        return str(v)
