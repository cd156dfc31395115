"""LM representation atlas: run an assigned architecture, harvest its
prefill states, embed them with Barnes-Hut t-SNE — then GROW the atlas point
by point through the continuous-batching embedding service.  Port of
``examples/lm_embedding_atlas.py``.

    PYTHONPATH=src python -m repro_torch.examples.lm_embedding_atlas --arch deepseek_7b
    PYTHONPATH=src python -m repro_torch.examples.lm_embedding_atlas --device cpu --iters 120

On ``--device`` (default cuda): the reduced model's ``prefill``, the
port's ``TSNE`` (its KNN, perplexity, Morton, attractive and traversal
kernels on the card) and its ``EmbeddingService``.  Each token batch is
drawn from ``torch.Generator().manual_seed(dom * 100 + b)`` on the CPU
(the reference draws it from ``jax.random.PRNGKey(dom * 100 + b)``), so the
CPU and the card see the same tokens.  Everything after the states is the
reference's own numpy: the projection from ``default_rng(0)``, the
permutation and the hold-out.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.api import TSNE, EmbeddingService, TransformRequest
from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.models.model import build_model

N_DOMAINS = 4
BATCH_ROWS = 4


class AtlasRun(NamedTuple):
    y: np.ndarray           # [n, 2]: the fitted points, then the grown ones
    labels: np.ndarray      # [n] domain of each row of y
    n_grow: int             # the last n_grow rows of y came through the service
    kl: float
    intra: float
    inter: float
    intra_new: float
    inter_new: float
    fit_s: float            # wall seconds of TSNE.fit
    service: dict           # EmbeddingService.stats()
    x_fit: np.ndarray       # [n - n_grow, 50] the projected states the fit saw
    x_new: np.ndarray       # [n_grow, 50] the states grown through the service
    est: TSNE               # the fitted estimator (embedding_, neighbor_graph_)


def domain_separation(y, labels, n_domains=N_DOMAINS):
    """Mean intra-domain spread vs mean inter-centroid distance."""
    cents = np.stack([y[labels == d].mean(0) for d in range(n_domains)])
    intra = np.mean([np.linalg.norm(y[labels == d] - cents[d], axis=1).mean()
                     for d in range(n_domains)])
    inter = np.mean([np.linalg.norm(a - b)
                     for i, a in enumerate(cents) for b in cents[i + 1:]])
    return intra, inter


def token_batch(vocab_size: int, dom: int, b: int, seq: int) -> torch.Tensor:
    """Batch ``b`` of domain ``dom``: [4, seq] tokens from the domain's
    range ``[dom * V/4, dom * V/4 + V/8)``."""
    lo = dom * (vocab_size // N_DOMAINS)
    hi = lo + vocab_size // 8
    gen = torch.Generator().manual_seed(dom * 100 + b)
    return torch.randint(lo, hi, (BATCH_ROWS, seq), generator=gen, dtype=torch.int32)


def harvest_states(model, params, batches: int, seq: int) -> tuple[np.ndarray, np.ndarray]:
    """(states [4 * batches * 4, V] float32, labels): the last position's
    prefill logits of every batch of every domain, domain by domain."""
    states, labels = [], []
    for dom in range(N_DOMAINS):
        for b in range(batches):
            toks = token_batch(model.cfg.vocab_size, dom, b, seq)
            logits = model.prefill(params, {"tokens": toks})
            states.append(logits.float().cpu().numpy())
            labels.extend([dom] * logits.shape[0])
    return np.concatenate(states, axis=0), np.asarray(labels)


def main(argv=None) -> AtlasRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="deepseek_7b")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--grow", type=int, default=32,
                    help="states held out of the fit and grown point-by-point")
    ap.add_argument("--out", default="atlas.npy")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("pick a text arch for the atlas example")
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))

    x, labels = harvest_states(model, params, args.batches, args.seq)
    # project to 50 dims (the usual PCA-before-t-SNE step, power iteration-free)
    rng = np.random.default_rng(0)
    x = (x - x.mean(0)) @ rng.normal(size=(x.shape[1], 50)).astype(np.float32) / np.sqrt(x.shape[1])

    # interleave domains in the held-out tail so growth mixes clusters
    perm = rng.permutation(x.shape[0])
    x, labels = x[perm], labels[perm]
    n_grow = min(args.grow, x.shape[0] // 4)
    x_fit, x_new = x[:-n_grow], x[-n_grow:]

    print(f"fitting atlas on {x_fit.shape[0]} states from {args.arch} "
          f"(holding out {n_grow} to grow through the service)")
    est = TSNE(perplexity=10.0, n_iter=args.iters, kl_every=100,
               random_state=0,
               backend_options=dict(exaggeration_iters=100,
                                    momentum_switch_iter=100),
               device=args.device)
    t0 = time.perf_counter()
    est.fit(x_fit)
    fit_s = time.perf_counter() - t0

    service = EmbeddingService(slots=args.slots, device=args.device)
    service.add_model("atlas", est)
    for i, xi in enumerate(x_new):
        service.submit(TransformRequest(rid=i, dataset="atlas", x=xi))
    done = service.run()
    if len(done) != n_grow:
        raise RuntimeError(f"the service completed {len(done)} of {n_grow} requests")
    y_new = np.stack([r.y for r in sorted(done, key=lambda r: r.rid)])
    y = np.concatenate([est.embedding_, y_new], axis=0)
    np.save(args.out, y)

    # domains with disjoint vocab ranges should separate — for the fitted
    # points AND the points grown through the service
    intra, inter = domain_separation(y, labels)
    intra_new, inter_new = domain_separation(y_new, labels[-n_grow:])
    s = service.stats()
    print(f"KL={est.kl_divergence_:.3f}  intra={intra:.2f}  inter={inter:.2f}"
          f"  (grown-only: intra={intra_new:.2f} inter={inter_new:.2f})"
          f"  -> {args.out}")
    print(f"service: {s['completed']} requests, {s['ticks']} ticks, "
          f"mean {s['steps_mean']:.0f} steps, "
          f"p50 latency {s['latency_s_p50'] * 1e3:.0f}ms")
    return AtlasRun(y=y, labels=labels, n_grow=n_grow, kl=float(est.kl_divergence_),
                    intra=float(intra), inter=float(inter), intra_new=float(intra_new),
                    inter_new=float(inter_new), fit_s=fit_s, service=s,
                    x_fit=x_fit, x_new=x_new, est=est)


if __name__ == "__main__":
    main()
