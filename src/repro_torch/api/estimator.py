"""scikit-learn-compatible ``TSNE`` estimator: port of ``repro/api/estimator.py``
(``fit``, ``fit_transform``, parameters and fitted attributes; ``transform``,
``save`` and ``load`` come with the out-of-sample slice).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np

from repro_torch.api.backends import GradientBackend, make_backend
from repro_torch.core.tsne import IterationStats, ObserverFn, TsneConfig, run_tsne
from repro_torch.device import resolve_device


class TSNE:
    """t-SNE with a pluggable gradient backend, on a CUDA device by default.

    Parameters mirror ``repro.api.TSNE`` (``angle`` is the BH theta;
    ``random_state`` seeds the embedding init), plus ``device``: ``None``
    means ``cuda`` and raises if no card is present; pass ``"cpu"`` to run
    the plain PyTorch path.  ``backend_options`` overrides ``TsneConfig``
    fields (e.g. ``{"knn_block_q": 4096}``, ``{"exaggeration_iters": 50}``).
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
            "device": self.device,
        }

    def set_params(self, **params) -> "TSNE":
        for k, v in params.items():
            if k not in self.get_params():
                raise ValueError(f"invalid parameter {k!r} for TSNE")
            setattr(self, k, resolve_device(v) if k == "device" else v)
        return self

    # -- core ---------------------------------------------------------------

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

        result = run_tsne(x, config, observer=observer if observers else None,
                          kl_every=self.kl_every, backend=backend,
                          device=self.device, y0=y0)
        self.embedding_ = result.y
        self.kl_divergence_ = result.kl
        self.kl_history_ = result.kl_history
        self.n_iter_ = result.n_iter
        self.learning_rate_ = config.resolve_lr(n)
        self.timings_ = result.timings
        self.n_features_in_ = x.shape[1]
        self.neighbor_graph_ = result.graph
        self.n_neighbors_ = config.resolve_n_neighbors(n)
        return self

    def fit_transform(self, x, y=None, y0=None) -> np.ndarray:
        """Fit x and return the [n_samples, 2] embedding."""
        self.fit(x, y, y0=y0)
        return self.embedding_
