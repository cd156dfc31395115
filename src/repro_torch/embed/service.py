"""Continuous-batching t-SNE embedding service: port of ``repro/embed/service.py``.

A fixed pool of ``slots`` transform lanes steps through ONE
``transform_step`` together; lanes whose point converged (gradient norm
under tolerance, or the step cap) retire to ``completed`` and are refilled
from the request queue between steps.  Fitted models are cached per
dataset name, so one service serves transform traffic against many frozen
embeddings: requests for different datasets share the same step, because
each lane carries its own frozen neighbor coordinates (gathered once at
admission).

    service = EmbeddingService(slots=8)                 # on cuda
    service.fit_dataset("digits", x_train, perplexity=12.0, n_iter=300)
    for i, x in enumerate(x_new):
        service.submit(TransformRequest(rid=i, dataset="digits", x=x))
    done = service.run()
    done[0].y, done[0].n_steps, done[0].latency_s

The pooled state, ``p`` and the neighbor coordinates live on the service's
device; each admission (one row: the index's query, on the card an exact
index's ``pairwise_sq_dists`` tiles, and the ``bsp_search`` kernel) is
written into its slot in place there.  Each tick reads the lanes'
gradient norms back to decide retirement, as the reference does.

Smoke entry point:
    PYTHONPATH=src python -m repro_torch.embed.service --smoke [--trace PATH] [--device cpu]
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.embed.transform import (
    TransformConfig, TransformState, prepare_batch, transform_step,
)


@dataclasses.dataclass
class TransformRequest:
    """One new point to embed into a named frozen fit."""

    rid: int
    dataset: str
    x: np.ndarray                      # [D] input-space coordinates
    y: np.ndarray | None = None        # [2] result, set on completion
    n_steps: int = 0                   # descent iterations consumed
    grad_norm: float = float("nan")    # gradient norm at retirement
    done: bool = False
    submitted_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0

    @property
    def latency_s(self) -> float:
        """Wall time from submit to completion (queueing included)."""
        return self.finished_at - self.submitted_at

    @property
    def service_s(self) -> float:
        """Wall time from slot admission to completion."""
        return self.finished_at - self.started_at


class EmbeddingService:
    """Fixed-slot continuous-batching server over cached fitted models.

    ``max_k`` bounds the neighbor width across all served datasets; a
    model fitted with more neighbors is truncated to its ``max_k`` nearest
    at query time (similarities renormalized by the perplexity search), so
    every lane fits the one ``[slots, max_k]`` step.
    """

    def __init__(
        self,
        slots: int = 8,
        max_k: int = 96,
        config: TransformConfig = TransformConfig(),
        metrics: obs.MetricsRegistry | None = None,
        tracer: obs.Tracer | None = None,
        device=None,
    ):
        """``metrics`` (default: a private registry, exposed as
        ``self.metrics``) continuously records service telemetry:
        ``service.queue_depth`` / ``service.slot_occupancy`` gauges
        (refreshed every tick, high-water marks kept),
        ``service.latency_s`` / ``service.service_s`` / ``service.steps``
        histograms observed at request retirement, and ``service.ticks`` /
        ``service.completed`` counters.  ``tracer`` (default: the process
        global, a no-op unless enabled) spans each admission and engine
        tick.  ``device`` (``None`` = cuda) holds the pooled state; every
        served model must live there."""
        if slots < 1:
            raise ValueError(f"slots={slots} must be >= 1")
        self.slots = slots
        self.max_k = max_k
        self.config = config
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else obs.MetricsRegistry()
        self.tracer = tracer if tracer is not None else obs.get_tracer()
        self._models: dict[str, object] = {}       # name -> fitted TSNE
        self._y_refs: dict[str, torch.Tensor] = {}  # name -> its embedding, on device
        # `queue` and `completed` are the cross-thread surfaces (submit()
        # and stats() may run off the engine thread) and are guarded by
        # `_lock`; `active` / `_state` / `_steps` / `ticks` are engine-
        # thread-owned and deliberately unguarded.
        self._lock = threading.Lock()
        self.queue: deque[TransformRequest] = deque()
        self.active: list[TransformRequest | None] = [None] * slots
        self.completed: list[TransformRequest] = []
        self._steps = np.zeros(slots, np.int32)
        # pooled device-side state, [slots, ...]: one step shape for the
        # life of the service regardless of which datasets the lanes serve
        dev = self.device
        self._state = TransformState(
            y=torch.zeros((slots, 2), dtype=torch.float32, device=dev),
            velocity=torch.zeros((slots, 2), dtype=torch.float32, device=dev),
            gains=torch.ones((slots, 2), dtype=torch.float32, device=dev),
        )
        self._p = torch.zeros((slots, max_k), dtype=torch.float32, device=dev)
        self._nbr_y = torch.zeros((slots, max_k, 2), dtype=torch.float32, device=dev)
        self.ticks = 0

    # ------------------------------------------------------------ models --

    def add_model(self, name: str, model) -> None:
        """Cache a fitted :class:`~repro_torch.api.estimator.TSNE` under
        ``name``; it must run on the service's device."""
        if not hasattr(model, "embedding_"):
            raise ValueError(f"model {name!r} is not fitted")
        device = getattr(model, "device", None)
        if device != self.device:
            raise ValueError(f"model {name!r} runs on {device}, the service on "
                             f"{self.device}")
        self._models[name] = model
        self._y_refs[name] = torch.as_tensor(
            np.asarray(model.embedding_, np.float32)).to(self.device)

    def fit_dataset(self, name: str, x, **tsne_kwargs):
        """Fit a fresh estimator on ``x``, on the service's device, and
        cache it under ``name``."""
        from repro_torch.api.estimator import TSNE
        model = TSNE(**tsne_kwargs, device=self.device).fit(x)
        self.add_model(name, model)
        return model

    def load_model(self, name: str, path) -> None:
        """Cache a model persisted with ``TSNE.save`` (either package's),
        loaded onto the service's device."""
        from repro_torch.api.estimator import TSNE
        self.add_model(name, TSNE.load(path, device=self.device))

    def models(self) -> tuple[str, ...]:
        return tuple(sorted(self._models))

    # ------------------------------------------------------------- queue --

    def submit(self, req: TransformRequest) -> None:
        if req.dataset not in self._models:
            raise ValueError(
                f"unknown dataset {req.dataset!r}; cached models: "
                f"{', '.join(self.models()) or '(none)'}"
            )
        req.submitted_at = time.perf_counter()
        with self._lock:
            self.queue.append(req)
            depth = len(self.queue)
        self.metrics.gauge("service.queue_depth").set(depth)

    def _admit(self, slot: int, req: TransformRequest) -> None:
        """Query + perplexity search + init for one request, into ``slot``
        (written in place on the device)."""
        model = self._models[req.dataset]
        k = min(model.query_k_, self.max_k)
        with self.tracer.span("service.admit", rid=req.rid,
                              dataset=req.dataset, slot=slot) as sp:
            x = torch.as_tensor(np.asarray(req.x, np.float32)[None]).to(self.device)
            p, nbr_y, y0 = prepare_batch(x, model.query_index_, self._y_refs[req.dataset],
                                         k, model.perplexity)
            sp.sync((p, y0))
        self._p[slot].zero_()
        self._p[slot, :k] = p[0]
        self._nbr_y[slot].zero_()
        self._nbr_y[slot, :k] = nbr_y[0]
        self._state.y[slot] = y0[0]
        self._state.velocity[slot] = 0.0
        self._state.gains[slot] = 1.0
        self._steps[slot] = 0
        req.started_at = time.perf_counter()
        self.active[slot] = req

    def _refill(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None:
                # pop under the lock, admit (slow: device work) outside it
                with self._lock:
                    if not self.queue:
                        break
                    req = self.queue.popleft()
                self._admit(s, req)

    # -------------------------------------------------------------- loop --

    def step(self) -> bool:
        """One engine tick: refill empty lanes, advance every active lane by
        one descent step, retire converged/capped lanes.  Returns False
        once the pool and queue are both empty."""
        self._refill()
        active_mask = np.array([r is not None for r in self.active])
        m = self.metrics
        with self._lock:
            depth = len(self.queue)
        m.gauge("service.queue_depth").set(depth)
        m.gauge("service.slot_occupancy").set(int(active_mask.sum()))
        if not active_mask.any():
            return False
        cfg = self.config
        momentum = np.where(
            self._steps < cfg.momentum_switch_iter,
            cfg.momentum_initial, cfg.momentum_final,
        ).astype(np.float32)
        with self.tracer.span("service.tick", tick=self.ticks,
                              occupancy=int(active_mask.sum())) as sp:
            self._state, grad_norm, _ = transform_step(
                self._state, self._p, self._nbr_y,
                torch.as_tensor(active_mask).to(self.device),
                torch.as_tensor(momentum).to(self.device),
                lr=cfg.learning_rate, min_gain=cfg.min_gain,
            )
            sp.sync(grad_norm)
        self.ticks += 1
        m.counter("service.ticks").inc()
        gn = grad_norm.cpu().numpy()
        y_now = None
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self._steps[s] += 1
            if gn[s] < cfg.min_grad_norm or self._steps[s] >= cfg.n_iter:
                if y_now is None:
                    y_now = self._state.y.cpu().numpy()
                req.y = y_now[s].copy()
                req.n_steps = int(self._steps[s])
                req.grad_norm = float(gn[s])
                req.done = True
                req.finished_at = time.perf_counter()
                with self._lock:
                    self.completed.append(req)
                self.active[s] = None
                m.counter("service.completed").inc()
                m.histogram("service.latency_s").observe(req.latency_s)
                m.histogram("service.service_s").observe(req.service_s)
                m.histogram("service.steps").observe(req.n_steps)
        # post-retirement refresh so a drained pool reads occupancy 0
        m.gauge("service.slot_occupancy").set(
            sum(r is not None for r in self.active))
        return True

    def run(self, max_ticks: int = 100_000) -> list[TransformRequest]:
        """Drain the queue; returns the requests completed by this call."""
        with self._lock:
            n_done = len(self.completed)
        ticks = 0
        while ticks < max_ticks:
            with self._lock:
                pending = bool(self.queue)
            if not pending and all(r is None for r in self.active):
                break
            self.step()
            ticks += 1
        with self._lock:
            return self.completed[n_done:]

    # ------------------------------------------------------------- stats --

    def stats(self) -> dict:
        """Aggregate service telemetry, O(histogram window) per call.

        Latency / step quantiles come from the bounded ``service.latency_s``
        and ``service.steps`` histograms maintained at retirement (p50 / p95
        / p99 over the retained window; count / mean / max exact).
        Queue-depth and slot-occupancy high-water marks come from the
        gauges.  ``recompiles`` surfaces every ``recompiles.*`` probe
        counter of the port's global registry (``transform_step`` carries
        one: its distinct step shapes)."""
        recompiles = obs.get_metrics().counter_values("recompiles.")
        with self._lock:
            done = len(self.completed)
            queued = len(self.queue)
            datasets = sorted({r.dataset for r in self.completed})
        if not done:
            return dict(completed=0, ticks=self.ticks, recompiles=recompiles)
        lat = self.metrics.histogram("service.latency_s")
        steps = self.metrics.histogram("service.steps")
        occ = self.metrics.gauge("service.slot_occupancy")
        qd = self.metrics.gauge("service.queue_depth")
        return dict(
            completed=done,
            ticks=self.ticks,
            queued=queued,
            datasets=datasets,
            recompiles=recompiles,
            latency_s_mean=lat.mean,
            latency_s_p50=lat.percentile(50),
            latency_s_p95=lat.percentile(95),
            latency_s_p99=lat.percentile(99),
            latency_s_max=lat.max,
            steps_mean=steps.mean,
            steps_p95=steps.percentile(95),
            steps_max=int(steps.max),
            slot_occupancy_max=int(occ.max_value) if occ.n_sets else 0,
            queue_depth_max=int(qd.max_value) if qd.n_sets else 0,
        )


def _smoke(trace_path: str | None = None, device=None) -> None:
    """Smoke run: fit a small dataset on ``device`` (``None`` = cuda), push
    requests through the queue.

    ``trace_path`` enables the process-global tracer for the whole run
    (fit + admissions + ticks) and writes the Chrome-trace JSON there."""
    from repro_torch.data.datasets import make_dataset

    tracer = None
    if trace_path:
        tracer = obs.set_tracer(obs.Tracer())

    x, _ = make_dataset("digits", n=480)
    train, new = x[:400], x[400:432]
    service = EmbeddingService(slots=4, max_k=48, device=device)
    service.fit_dataset(
        "digits", train, perplexity=10.0, n_iter=150, kl_every=75,
        random_state=0,
    )
    for i, xi in enumerate(new):
        service.submit(TransformRequest(rid=i, dataset="digits", x=xi))
    t0 = time.perf_counter()
    done = service.run()
    wall = time.perf_counter() - t0
    if len(done) != len(new):
        raise RuntimeError(f"{len(done)}/{len(new)} completed")
    if not all(r.done and r.y is not None and np.isfinite(r.y).all() for r in done):
        raise RuntimeError("a request finished without a finite result")
    s = service.stats()
    print(
        f"embedding-service smoke OK on {service.device}: {s['completed']} requests "
        f"through {service.slots} slots in {wall:.1f}s ({s['ticks']} ticks, "
        f"mean {s['steps_mean']:.0f} steps, "
        f"p50/p95 latency {s['latency_s_p50'] * 1e3:.0f}/"
        f"{s['latency_s_p95'] * 1e3:.0f}ms, "
        f"occupancy<= {s['slot_occupancy_max']}, "
        f"queue<= {s['queue_depth_max']})"
    )
    if tracer is not None:
        tracer.to_chrome_trace(trace_path, process_name="embed.service")
        n_ev = len(tracer.spans)
        print(f"wrote Chrome trace ({n_ev} spans) to {trace_path}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fit a small dataset and drain a short queue")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="enable tracing and write a Perfetto-loadable "
                         "Chrome-trace JSON of the smoke run to PATH")
    ap.add_argument("--device", default=None,
                    help="device of the run (default: cuda; 'cpu' for the plain path)")
    args = ap.parse_args()
    if args.smoke:
        _smoke(trace_path=args.trace, device=args.device)
    else:
        ap.error("this module is a library; run with --smoke for the smoke check")
