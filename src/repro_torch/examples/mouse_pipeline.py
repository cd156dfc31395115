"""End-to-end driver of the paper's headline experiment on the port: t-SNE
on the mouse-brain-cell set (1.3 M cells x 20 PCA components): port of
``examples/mouse_pipeline.py``.

    PYTHONPATH=src python -m repro_torch.examples.mouse_pipeline --n 50000 --iters 1000
    PYTHONPATH=src python -m repro_torch.examples.mouse_pipeline \\
        --n 1291337 --shards 4 --method barnes_hut --iters 300 --ckpt_dir ckpt
    PYTHONPATH=src python -m repro_torch.examples.mouse_pipeline --device cpu --n 3000 --iters 60

KNN -> BSP -> symmetrize -> gradient-descent steps, with per-stage
timings (paper Fig. 1b / Table 5), on ``--device`` (default cuda).  ``--n``
scales the subsample of ``make_dataset("mouse_1p3m")``; the full 1 291 337
points run with ``--n 1291337``.

Memory envelope, as the reference's: from ``--n`` 200 000 up the KNN
stage defaults to the ``sharded`` backend (per-shard rp_forest and the
candidate ring), whose transients are O(block_rows * candidates) a
shard, and the perplexity search and the ELL symmetrization stream over
``--chunk-size`` row slices (100 000 rows by default there).  Nothing is
O(N^2).  ``--neighbor_method exact`` gives the brute-force scan back for
comparisons at small ``--n``.

``--shards S`` sets ``REPRO_TORCH_MESH_DEVICES=S`` unless it is already
set (the reference sets ``XLA_FLAGS=--xla_force_host_platform_device_count=S``):
the sharded KNN then runs S shards over the visible devices repeated,
``Mesh((cuda:0,) * S)`` on one card.  ``--ckpt_dir`` makes a long run
restartable: a run finding a checkpoint there resumes from its step.
The reference's ``--bench-out`` (a ``BENCH_<n>.json`` through
``benchmarks/common.py``) is not ported.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np
import torch

AUTO_SCALE_N = 200_000      # from here on, sharded KNN and chunking by default
AUTO_CHUNK = 100_000


class PipelineRun(NamedTuple):
    y: np.ndarray           # [n, 2] final embedding
    kl: float               # the last KL read (NaN if none was read)
    kl_history: list        # (iteration, KL) at every read
    timings: dict           # preprocess's timings and gradient_descent seconds
    graph: object           # the NeighborGraph the descent used
    start: int              # the step resumed from (0 without a checkpoint)
    ms_per_step: float      # gradient_descent over the steps this run made


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=50000)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--perplexity", type=float, default=30.0)
    ap.add_argument("--theta", type=float, default=0.5)
    ap.add_argument("--method", default="barnes_hut",
                    help="gradient backend: barnes_hut | fft | exact | ...")
    ap.add_argument("--neighbor_method", default="auto",
                    help="auto (sharded from 200k points, else rp_forest) | "
                         "exact | rp_forest | nn_descent | sharded | any "
                         "registered name")
    ap.add_argument("--n_neighbors", type=int, default=None,
                    help="KNN degree (default: 3 * perplexity)")
    ap.add_argument("--shards", type=int, default=0,
                    help="device shards for the sharded KNN ring (0 = all "
                         "visible devices; >1 repeats the visible devices to S)")
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="rows per BSP/symmetrize slice (0 = auto: 100k "
                         "chunks from 200k points, unchunked below)")
    ap.add_argument("--kl_every", type=int, default=50)
    ap.add_argument("--ckpt_dir", default="")
    ap.add_argument("--ckpt_every", type=int, default=200)
    ap.add_argument("--out", default="mouse_embedding.npy")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, graph=None) -> PipelineRun:
    """Run the pipeline with ``argv``'s flags.  ``graph``, a NeighborGraph
    of the same points and config, skips the preprocess (its timings are
    then absent)."""
    args = parse_args(argv)
    from repro_torch.device import MESH_DEVICES_ENV, resolve_device
    if args.shards > 1 and MESH_DEVICES_ENV not in os.environ:
        os.environ[MESH_DEVICES_ENV] = str(args.shards)

    from repro_torch.api import make_backend
    from repro_torch.core.tsne import TsneConfig, init_state, preprocess, tsne_step
    from repro_torch.data.datasets import make_dataset
    from repro_torch.train.checkpoint import CheckpointManager

    dev = resolve_device(args.device)
    neighbor_method = args.neighbor_method
    if neighbor_method == "auto":
        neighbor_method = "sharded" if args.n >= AUTO_SCALE_N else "rp_forest"
    chunk = args.chunk_size or (AUTO_CHUNK if args.n >= AUTO_SCALE_N else None)

    cfg = TsneConfig(perplexity=args.perplexity, theta=args.theta,
                     n_iter=args.iters, neighbor_method=neighbor_method,
                     n_neighbors=args.n_neighbors, chunk_size=chunk,
                     knn_shards=args.shards or None, method=args.method)
    t0 = time.perf_counter()
    timings = {}
    if graph is None:
        print(f"generating mouse-like dataset: {args.n} cells x 20 components")
        x, _ = make_dataset("mouse_1p3m", n=args.n)
        graph, timings = preprocess(torch.as_tensor(x).to(dev), cfg)
        print(f"KNN[{timings['neighbor_method']}, k={timings['n_neighbors']}] "
              f"{timings['knn']:.1f}s  BSP {timings['bsp']:.1f}s  "
              f"symmetrize {timings['symmetrize']:.1f}s  "
              f"(chunk_size={timings['chunk_size']})")

    state = init_state(args.n, cfg, dev)
    ckpt = None
    start = 0
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        if ckpt.latest_step() is not None:
            state, start = ckpt.restore(state, device=dev)
            print(f"resumed from iteration {start}")

    lr = cfg.resolve_lr(args.n)
    backend = make_backend(cfg.method, cfg, args.n)
    t_gd = time.perf_counter()
    kl = float("nan")
    kl_hist = []
    for it in range(start, args.iters):
        exag = cfg.early_exaggeration if it < cfg.exaggeration_iters else 1.0
        mom = cfg.momentum_initial if it < cfg.momentum_switch_iter else cfg.momentum_final
        state, stats = tsne_step(state, graph, exag, mom, backend=backend, lr=lr,
                                 min_gain=cfg.min_gain)
        if (it + 1) % args.kl_every == 0 or it == args.iters - 1:
            kl = float(stats.kl)
            kl_hist.append((it + 1, kl))
            print(f"iter {it + 1:5d}  KL {kl:.4f}  "
                  f"max_traversal {int(stats.max_traversal)}  "
                  f"{(time.perf_counter() - t_gd) / (it + 1 - start) * 1000:.0f} ms/iter")
        if ckpt is not None and (it + 1) % args.ckpt_every == 0:
            ckpt.save(it + 1, state)
    if ckpt is not None:
        ckpt.wait()
    y = state.y.cpu().numpy()
    timings["gradient_descent"] = time.perf_counter() - t_gd
    steps = args.iters - start
    np.save(args.out, y)
    print(f"total {time.perf_counter() - t0:.1f}s; embedding -> {args.out}")
    return PipelineRun(y=y, kl=kl, kl_history=kl_hist, timings=timings, graph=graph,
                       start=start,
                       ms_per_step=timings["gradient_descent"] / max(steps, 1) * 1e3)


if __name__ == "__main__":
    main()
