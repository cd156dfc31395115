"""t-SNE launcher, single device, through the estimator: port of the
single-device path of ``repro/launch/tsne_run.py``.

    PYTHONPATH=src python -m repro_torch.launch.tsne_run --dataset digits --n 1797
    PYTHONPATH=src python -m repro_torch.launch.tsne_run --method fft --n 4096
    PYTHONPATH=src python -m repro_torch.launch.tsne_run --device cpu --n 500 --iters 120

Runs on cuda unless ``--device cpu`` is given.  The reference's sharded
path (``--devices > 1``) is not ported yet; asking for it exits with an
error rather than running on one device.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="digits")
    ap.add_argument("--n", type=int, default=1797)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--perplexity", type=float, default=30.0)
    ap.add_argument("--theta", type=float, default=0.5)
    ap.add_argument("--method", default="barnes_hut",
                    help="gradient backend: exact | barnes_hut | fft | any registered name")
    ap.add_argument("--devices", type=int, default=1,
                    help="devices to shard over; only 1 is ported")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="tsne_out.npy")
    args = ap.parse_args(argv)

    if args.devices > 1:
        raise SystemExit(
            f"--devices {args.devices}: the sharded path (core/distributed.py on "
            "torch.distributed) is not ported yet; it is ROADMAP.md section 1 item 5, "
            "the multi-device port")

    import numpy as np

    from repro_torch.api import TSNE
    from repro_torch.data.datasets import make_dataset

    x, _ = make_dataset(args.dataset, n=args.n)
    est = TSNE(method=args.method, perplexity=args.perplexity, angle=args.theta,
               n_iter=args.iters, verbose=1, device=args.device)
    emb = est.fit_transform(x)
    np.save(args.out, emb)
    print(f"KL={est.kl_divergence_:.4f} n_iter={est.n_iter_} -> {args.out}")


if __name__ == "__main__":
    main()
