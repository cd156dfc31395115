"""Quickstart: t-SNE through the port's sklearn-compatible estimator: port
of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--n 1797] [--iters 500]
        [--method exact|barnes_hut|fft] [--device cuda|cpu]

Saves the embedding and prints the KL trajectory: the short tour of the
public API (``repro_torch.api.TSNE`` with a pluggable gradient backend).
"""
import argparse

import numpy as np

from repro_torch.api import TSNE
from repro_torch.data.datasets import make_dataset


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1797)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--perplexity", type=float, default=30.0)
    ap.add_argument("--theta", type=float, default=0.5)
    ap.add_argument("--method", default="barnes_hut")
    ap.add_argument("--out", default="embedding.npy")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    x, labels = make_dataset("digits", n=args.n)
    est = TSNE(
        method=args.method, perplexity=args.perplexity, angle=args.theta,
        n_iter=args.iters, random_state=0, device=args.device,
        callbacks=[lambda s: print(
            f"iter {s.iteration:5d}  KL {s.kl:.4f}  |grad| {s.grad_norm:.2e}")],
    )
    y = est.fit_transform(x)
    np.save(args.out, y)
    print(f"\ntimings: {est.timings_}")
    print(f"final KL = {est.kl_divergence_:.4f} after {est.n_iter_} iters; "
          f"embedding -> {args.out}")

    # quick quality readout: mean intra/inter cluster distance ratio
    cents = np.stack([y[labels == c].mean(0) for c in np.unique(labels)])
    intra = np.mean([np.linalg.norm(y[labels == c] - cents[i], axis=1).mean()
                     for i, c in enumerate(np.unique(labels))])
    dists = [np.linalg.norm(a - b) for i, a in enumerate(cents) for b in cents[i + 1:]]
    print(f"cluster separation: intra {intra:.2f} vs inter {np.mean(dists):.2f}")
    return y


if __name__ == "__main__":
    main()
