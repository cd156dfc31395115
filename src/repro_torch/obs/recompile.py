"""Step-shape probe: count the distinct ``(shape, static-args)`` keys of a
hot function: port of ``repro/obs/recompile.py``.

In the reference the probe is a trace-time side effect inside a jitted
function: it fires only when JAX traces, so ``count`` is the number of
compiled variants.  The port compiles nothing (no ``jit``, no
``torch.compile``: PyTorch runs the step eagerly), so :meth:`record` is
called on **every call** of the probed function, keyed as the reference
keys it:

    PROBE = RecompileProbe("transform_step")

    def step(x):
        PROBE.record(tuple(x.shape), lr)
        ...

``PROBE.count`` is then what it is in the reference, the number of
distinct step shapes (the variants a compiler would build), and stays
flat across calls that reuse a shape: the property the no-retrace tests
assert.  ``PROBE.calls`` counts calls, not traces.

Probes register on a :class:`~repro_torch.obs.metrics.MetricsRegistry`
(the process-global one by default) as ``recompiles.<name>``, so service
telemetry snapshots include shape churn, as in the reference.
"""
from __future__ import annotations

import threading


class RecompileProbe:
    """Counts distinct step keys of one function."""

    def __init__(self, name: str, registry=None):
        self.name = name
        self._keys: set = set()
        self._calls = 0
        self._lock = threading.Lock()
        if registry is None:
            from repro_torch.obs import get_metrics
            registry = get_metrics()
        self._counter = registry.counter(f"recompiles.{name}")

    def record(self, *key) -> None:
        """Record one call keyed by ``key`` (shapes, dtypes, static
        argument values: anything hashable)."""
        with self._lock:
            self._calls += 1
            if key not in self._keys:
                self._keys.add(key)
                self._counter.inc()

    @property
    def count(self) -> int:
        """Distinct keys seen (the step shapes a compiler would build)."""
        with self._lock:
            return len(self._keys)

    @property
    def calls(self) -> int:
        """Calls recorded, repeats of seen keys included."""
        with self._lock:
            return self._calls

    @property
    def keys(self) -> frozenset:
        with self._lock:
            return frozenset(self._keys)

    def reset(self) -> None:
        with self._lock:
            self._keys.clear()
            self._calls = 0
