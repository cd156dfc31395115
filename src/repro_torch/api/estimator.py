"""scikit-learn-compatible ``TSNE`` estimator: port of ``repro/api/estimator.py``
(``fit``, ``fit_transform``, the out-of-sample ``transform``, ``save``,
``load`` and the ``trace=`` switch of the observability layer).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.backends import GradientBackend, make_backend
from repro_torch.core.tsne import IterationStats, ObserverFn, TsneConfig, run_tsne
from repro_torch.device import resolve_device


class TSNE:
    """t-SNE with a pluggable gradient backend, on a CUDA device by default.

    Parameters mirror ``repro.api.TSNE`` (``angle`` is the BH theta;
    ``random_state`` seeds the embedding init), plus ``device``: ``None``
    means ``cuda`` and raises if no card is present; pass ``"cpu"`` to run
    the plain PyTorch path.  ``backend_options`` overrides ``TsneConfig``
    fields (e.g. ``{"knn_block_q": 4096}``, ``{"exaggeration_iters": 50}``,
    ``{"fft_n_boxes": 96}``).

    trace : bool, str or None
        observability switch, as in the reference.  ``None`` (default)
        defers to the process environment (``TSNE_TRACE=1`` enables the
        global tracer); ``True`` records this estimator's fits and
        transforms on a private tracer exposed as ``tracer_`` (with a
        matching ``metrics_`` registry); a string also writes a Chrome
        trace (Perfetto-loadable) to that path after each ``fit``.
    """

    def __init__(
        self,
        n_components: int = 2,
        *,
        perplexity: float = 30.0,
        early_exaggeration: float = 12.0,
        learning_rate: float | str = "auto",
        n_iter: int = 1000,
        min_grad_norm: float = 1e-7,
        method: str | GradientBackend = "barnes_hut",
        angle: float = 0.5,
        verbose: int = 0,
        random_state: int | None = None,
        callbacks: Iterable[ObserverFn] = (),
        kl_every: int = 50,
        backend_options: Mapping | None = None,
        n_neighbors: int | None = None,
        neighbor_method: str = "exact",
        neighbor_options: Mapping | None = None,
        trace: bool | str | None = None,
        device=None,
    ):
        self.n_components = n_components
        self.perplexity = perplexity
        self.early_exaggeration = early_exaggeration
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.min_grad_norm = min_grad_norm
        self.method = method
        self.angle = angle
        self.verbose = verbose
        self.random_state = random_state
        self.callbacks = tuple(callbacks)
        self.kl_every = kl_every
        self.backend_options = dict(backend_options or {})
        self.n_neighbors = n_neighbors
        self.neighbor_method = neighbor_method
        self.neighbor_options = dict(neighbor_options or {})
        self.trace = trace
        self.device = resolve_device(device)

    # -- sklearn plumbing ---------------------------------------------------

    def get_params(self, deep: bool = True) -> dict:
        return {
            "n_components": self.n_components,
            "perplexity": self.perplexity,
            "early_exaggeration": self.early_exaggeration,
            "learning_rate": self.learning_rate,
            "n_iter": self.n_iter,
            "min_grad_norm": self.min_grad_norm,
            "method": self.method,
            "angle": self.angle,
            "verbose": self.verbose,
            "random_state": self.random_state,
            "callbacks": self.callbacks,
            "kl_every": self.kl_every,
            "backend_options": self.backend_options,
            "n_neighbors": self.n_neighbors,
            "neighbor_method": self.neighbor_method,
            "neighbor_options": self.neighbor_options,
            "trace": self.trace,
            "device": self.device,
        }

    def set_params(self, **params) -> "TSNE":
        for k, v in params.items():
            if k not in self.get_params():
                raise ValueError(f"invalid parameter {k!r} for TSNE")
            setattr(self, k, resolve_device(v) if k == "device" else v)
        return self

    # -- core ---------------------------------------------------------------

    def _setup_obs(self) -> tuple:
        """Resolve the ``trace`` knob into ``(tracer, metrics)`` for a run.

        ``trace`` falsy: globals (enabled only under ``TSNE_TRACE``);
        ``tracer_`` / ``metrics_`` point at them when active, else ``None``.
        ``trace`` truthy: a fresh private tracer + registry per fit, kept on
        the estimator so ``transform`` calls append to the same trace.
        """
        if not self.trace:
            g = obs.get_tracer()
            self.tracer_ = g if g.enabled else None
            self.metrics_ = obs.get_metrics() if g.enabled else None
            return None, None            # run_tsne falls back to the globals
        self.tracer_ = obs.Tracer()
        self.metrics_ = obs.MetricsRegistry()
        return self.tracer_, self.metrics_

    def _build_config(self) -> TsneConfig:
        cfg = TsneConfig(
            perplexity=self.perplexity,
            n_iter=self.n_iter,
            theta=self.angle,
            learning_rate=self.learning_rate,
            early_exaggeration=self.early_exaggeration,
            min_grad_norm=self.min_grad_norm,
            seed=0 if self.random_state is None else int(self.random_state),
            method=self.method if isinstance(self.method, str)
            else getattr(self.method, "name", "barnes_hut"),
            n_neighbors=self.n_neighbors,
            neighbor_method=self.neighbor_method,
            neighbor_options=self.neighbor_options or None,
        )
        if self.backend_options:
            cfg = dataclasses.replace(cfg, **self.backend_options)
        return cfg

    def fit(self, x, y=None, y0=None) -> "TSNE":
        """Fit x [n_samples, n_features] into the embedding space.

        ``y0`` [n_samples, 2] replaces the random initial embedding.
        """
        x = np.asarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError(f"expected 2-D input, got shape {x.shape}")
        n = x.shape[0]
        if self.n_components != 2:
            raise ValueError(
                "this implementation embeds into 2 dimensions only "
                f"(n_components={self.n_components})"
            )
        if n <= 3 * self.perplexity:
            raise ValueError(
                f"perplexity {self.perplexity} is too large for n_samples={n} "
                "(need n_samples > 3 * perplexity)"
            )
        config = self._build_config()

        if isinstance(self.method, str):
            backend = make_backend(self.method, config, n)
        elif isinstance(self.method, GradientBackend):
            if self.backend_options:
                raise ValueError(
                    "backend_options have no effect when method= is a "
                    "GradientBackend instance; set them on the instance"
                )
            if self.angle != 0.5 and hasattr(self.method, "theta"):
                raise ValueError(
                    "angle= has no effect when method= is a GradientBackend "
                    "instance; set theta on the instance"
                )
            backend = self.method
        else:
            raise TypeError(
                f"method must be a registered backend name or a GradientBackend "
                f"instance, got {type(self.method).__name__}"
            )

        observers = list(self.callbacks)
        if self.verbose:
            observers.append(
                lambda s: print(
                    f"[t-SNE:{backend.name}] iter {s.iteration:5d}  "
                    f"KL {s.kl:.4f}  |grad| {s.grad_norm:.2e}  "
                    f"max_traversal {s.max_traversal}  {s.elapsed_s:.1f}s"
                )
            )

        def observer(stats: IterationStats) -> None:
            for fn in observers:
                fn(stats)

        tracer, metrics = self._setup_obs()
        result = run_tsne(x, config, observer=observer if observers else None,
                          kl_every=self.kl_every, backend=backend,
                          device=self.device, y0=y0, tracer=tracer, metrics=metrics)
        if isinstance(self.trace, str) and tracer is not None:
            tracer.to_chrome_trace(self.trace, process_name="tsne.fit")
        self.embedding_ = result.y
        self.kl_divergence_ = result.kl
        self.kl_history_ = result.kl_history
        self.n_iter_ = result.n_iter
        self.learning_rate_ = config.resolve_lr(n)
        self.timings_ = result.timings
        self.n_features_in_ = x.shape[1]
        self.neighbor_graph_ = result.graph
        self.n_neighbors_ = config.resolve_n_neighbors(n)
        self._x_fit = x
        self._query_index = None            # built lazily on first transform
        return self

    def fit_transform(self, x, y=None, y0=None) -> np.ndarray:
        """Fit x and return the [n_samples, 2] embedding."""
        self.fit(x, y, y0=y0)
        return self.embedding_

    # -- out-of-sample ------------------------------------------------------

    def _check_fitted(self) -> None:
        if getattr(self, "embedding_", None) is None:
            raise ValueError("this TSNE instance is not fitted yet: call "
                             "fit / fit_transform (or TSNE.load) first")

    @property
    def query_index_(self):
        """Neighbor-backend query index over the fitted inputs, on
        ``device`` (lazy).

        Built by the backend that built the fit's KNN graph (``rp_forest``
        builds its forest; backends without a query path fall back to
        exact), then cached until the next ``fit``.
        """
        self._check_fitted()
        if getattr(self, "_query_index", None) is None:
            from repro_torch.neighbors import build_query_index, make_neighbor_backend
            config = self._build_config()
            backend = make_neighbor_backend(config.neighbor_method,
                                            config.resolve_neighbor_options())
            x = torch.as_tensor(self._x_fit).to(self.device)
            self._query_index = build_query_index(backend, x)
        return self._query_index

    @property
    def query_k_(self) -> int:
        """Neighbor width for out-of-sample queries (the fit's k)."""
        self._check_fitted()
        return int(self.n_neighbors_)

    def transform(self, x_new, *, transform_config=None, return_stats: bool = False):
        """Embed new points into the frozen fitted embedding: no refit.

        Each row of ``x_new [M, n_features]`` finds its ``query_k_`` nearest
        fitted inputs through the fitted neighbor structure, receives
        perplexity-calibrated similarities over them, and descends
        (attractive-only, momentum + gains, per-point early stop) against
        their frozen embedding coordinates, starting from their p-weighted
        mean.

        Returns ``y [M, 2]`` (and per-point ``TransformStats`` when
        ``return_stats=True``).
        """
        from repro_torch.embed.transform import TransformConfig, transform_batch

        self._check_fitted()
        x_new = np.asarray(x_new, np.float32)
        if x_new.ndim != 2 or x_new.shape[1] != self.n_features_in_:
            raise ValueError(f"expected x_new shaped [m, {self.n_features_in_}], got "
                             f"{x_new.shape}")
        cfg = transform_config or TransformConfig()
        perp = cfg.perplexity if cfg.perplexity is not None else self.perplexity
        y, stats = transform_batch(
            torch.as_tensor(x_new).to(self.device), self.query_index_,
            torch.as_tensor(np.asarray(self.embedding_, np.float32)).to(self.device),
            k=self.query_k_, perplexity=float(perp), config=cfg,
            tracer=getattr(self, "tracer_", None))
        return (y, stats) if return_stats else y

    # -- persistence --------------------------------------------------------

    # the reference's npz schema: a file either package writes, the other reads
    _SAVE_SCHEMA = 1

    def save(self, path) -> None:
        """Persist the fitted state (npz, ``repro.api.TSNE``'s schema):
        embedding, fitted inputs, sparse-P neighbor graph and constructor
        parameters, enough for ``load`` to serve ``transform``.  The
        parameters carry no ``device``, so ``repro.api.TSNE.load`` reads
        the file too."""
        self._check_fitted()
        params = self.get_params()
        params.pop("callbacks", None)       # not serializable, fit-only
        params.pop("device")                # where to run is the loader's choice
        if not isinstance(params["method"], str):
            params["method"] = getattr(params["method"], "name", "barnes_hut")
        arrays = dict(
            schema=np.int32(self._SAVE_SCHEMA),
            embedding=np.asarray(self.embedding_, np.float32),
            x_fit=np.asarray(self._x_fit, np.float32),
            kl_divergence=np.float64(self.kl_divergence_),
            kl_history=np.asarray(self.kl_history_, np.float64),
            n_iter_run=np.int32(self.n_iter_),
            learning_rate=np.float64(self.learning_rate_),
            n_neighbors_fit=np.int32(self.n_neighbors_),
            params_json=np.array(json.dumps(params)),
        )
        g = getattr(self, "neighbor_graph_", None)
        if g is not None:
            arrays.update(
                graph_p_cols=g.p_cols.cpu().numpy().astype(np.int32),
                graph_p_vals=g.p_vals.cpu().numpy().astype(np.float32),
                graph_edge_src=g.edge_src.cpu().numpy().astype(np.int32),
                graph_edge_dst=g.edge_dst.cpu().numpy().astype(np.int32),
                graph_edge_w=g.edge_w.cpu().numpy().astype(np.float32),
                graph_p_logp=np.float64(g.p_logp),
                graph_has_edges=np.bool_(g.has_edges),
            )
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path, device=None) -> "TSNE":
        """Rebuild a fitted estimator saved by :meth:`save` or by
        ``repro.api.TSNE.save``, on ``device`` (``None`` = cuda); the query
        index is rebuilt lazily on the first ``transform``.

        ``timings_`` is ``None``: no phase ran in this process.
        """
        from repro_torch.convert import graph_from_numpy

        z = np.load(path, allow_pickle=False)
        if int(z["schema"]) != cls._SAVE_SCHEMA:
            raise ValueError(f"unsupported TSNE save schema {int(z['schema'])} "
                             f"(expected {cls._SAVE_SCHEMA})")
        params = json.loads(str(z["params_json"]))
        est = cls(**params, device=device)
        est.embedding_ = np.asarray(z["embedding"])
        est._x_fit = np.asarray(z["x_fit"])
        est.kl_divergence_ = float(z["kl_divergence"])
        est.kl_history_ = np.asarray(z["kl_history"])
        est.n_iter_ = int(z["n_iter_run"])
        est.learning_rate_ = float(z["learning_rate"])
        est.n_neighbors_ = int(z["n_neighbors_fit"])
        est.n_features_in_ = est._x_fit.shape[1]
        est.timings_ = None         # loaded, not fitted here: no phase ran
        est._query_index = None
        if "graph_p_cols" in z.files:
            has_edges = bool(z["graph_has_edges"])
            edges = (z["graph_edge_src"], z["graph_edge_dst"], z["graph_edge_w"]) \
                if has_edges else None
            est.neighbor_graph_ = graph_from_numpy(
                z["graph_p_cols"], z["graph_p_vals"], float(z["graph_p_logp"]),
                n=est._x_fit.shape[0], edges=edges, device=est.device)
        else:
            est.neighbor_graph_ = None
        return est
