"""t-SNE launcher, single device (through the estimator) or sharded: port of
``repro/launch/tsne_run.py``.

    PYTHONPATH=src python -m repro_torch.launch.tsne_run --dataset digits --n 1797
    PYTHONPATH=src python -m repro_torch.launch.tsne_run --method fft --n 4096
    PYTHONPATH=src python -m repro_torch.launch.tsne_run --device cpu --n 500 --iters 120
    PYTHONPATH=src python -m repro_torch.launch.tsne_run --device cpu --devices 4 --n 512 --iters 60
    REPRO_TORCH_MESH_DEVICES=4 \
      PYTHONPATH=src python -m repro_torch.launch.tsne_run --dataset mnist --n 4096 --devices 4

Runs on cuda unless ``--device cpu`` is given.  ``--devices S`` (S > 1)
shards the points over a mesh of S devices (``core/distributed.py``): the
first S cards, or S CPU shards with ``--device cpu``.  As the reference
needs ``XLA_FLAGS=--xla_force_host_platform_device_count=S`` for more
shards than devices, the port needs ``REPRO_TORCH_MESH_DEVICES=S``: then
the visible devices are repeated, S shards on one card.  That path is the
reference's: the exact ring KNN, the perplexity search, the symmetrized
ELL graph, then Barnes-Hut descent steps of the sharded gradient
(:func:`run_distributed`), N cut to a multiple of S.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

# steps between KL reads of the sharded descent (the reference prints them)
KL_EVERY = 100


class DistributedRun(NamedTuple):
    y: np.ndarray        # [n, 2] final embedding
    kl: float            # the last step's KL, without sum p log p (the reference's 0.0)
    kl_history: list     # (iteration, KL) every KL_EVERY steps, as kl
    p_logp: float        # the graph's sum p log p: kl + p_logp is the full KL
    n: int               # points used: N cut to a multiple of the mesh size
    timings: dict        # seconds of the knn, bsp, symmetrize and descent stages


def _synchronize(mesh) -> None:
    for dev in dict.fromkeys(mesh.devices):
        if dev.type == "cuda":
            # repro-lint: disable=RT105 -- the stage clock of DistributedRun.timings, between stages
            torch.cuda.synchronize(dev)


def dist_step(mesh, states, cols, vals, lens, *, theta: float, exag: float, mom: float,
              lr: float, min_gain: float):
    """One sharded descent step: the sharded Barnes-Hut gradient (KL without
    sum p log p, as the reference's ``_dist_step``) and the momentum/gains
    update re-centred on the global mean.  Returns (states, KL tensor)."""
    from repro_torch.core.distributed import distributed_bh_gradient, gd_update_sharded
    res = distributed_bh_gradient(mesh, [s.y for s in states], cols, vals, 0.0, theta=theta,
                                  exaggeration=exag, p_len=lens)
    return gd_update_sharded(mesh, states, res.grad, lr, mom, min_gain), res.kl


def run_distributed(mesh, x, cfg, iters: int, y0=None) -> DistributedRun:
    """The reference launcher's sharded path on ``mesh``: ``ring_knn`` of x
    (cut to a multiple of the mesh size), ``bsp`` and ``symmetrize_ell``,
    then ``iters`` descent steps of :func:`dist_step` with ``cfg``'s
    schedules, from ``y0`` (default: ``init_state``'s draw).  The KL is read
    every KL_EVERY steps and after the last."""
    from repro_torch import convert
    from repro_torch.core import bsp, similarity
    from repro_torch.core.distributed import gather_rows, ring_knn, shard_rows
    from repro_torch.core.tsne import init_state

    s = mesh.size
    x = torch.as_tensor(x)
    n = x.shape[0] - x.shape[0] % s
    x = x[:n].to(cfg.dtype)
    k = cfg.resolve_n_neighbors(n)
    timings = {}
    _synchronize(mesh)
    t0 = time.perf_counter()
    idx, d2 = ring_knn(mesh, shard_rows(mesh, x), k)
    idx, d2 = gather_rows(idx), gather_rows(d2)
    _synchronize(mesh)
    t1 = time.perf_counter()
    cond_p, _ = bsp.binary_search_perplexity(d2, cfg.perplexity)
    _synchronize(mesh)
    t2 = time.perf_counter()
    cols, vals = similarity.symmetrize_ell(idx.cpu().numpy(), cond_p.cpu().numpy())
    lens = similarity.ell_row_lengths(cols)
    pv = vals[vals > 0]
    p_logp = float((pv * np.log(pv)).sum())
    cols = shard_rows(mesh, torch.as_tensor(cols))
    vals = shard_rows(mesh, torch.as_tensor(vals).to(cfg.dtype))
    lens = shard_rows(mesh, torch.as_tensor(lens))
    states = convert.shard_state(mesh, init_state(n, cfg, "cpu", y0))
    lr = cfg.resolve_lr(n)
    _synchronize(mesh)
    t3 = time.perf_counter()
    kl, kl_hist = None, []
    for it in range(iters):
        exag = cfg.early_exaggeration if it < cfg.exaggeration_iters else 1.0
        mom = cfg.momentum_initial if it < cfg.momentum_switch_iter else cfg.momentum_final
        states, kl = dist_step(mesh, states, cols, vals, lens, theta=cfg.theta, exag=exag,
                               mom=mom, lr=lr, min_gain=cfg.min_gain)
        if (it + 1) % KL_EVERY == 0:
            kl_hist.append((it + 1, float(kl)))
    y = gather_rows([st.y for st in states]).cpu().numpy()
    timings.update(knn=t1 - t0, bsp=t2 - t1, symmetrize=t3 - t2,
                   descent=time.perf_counter() - t3)
    return DistributedRun(y=y, kl=float("nan") if kl is None else float(kl),
                          kl_history=kl_hist, p_logp=p_logp, n=n, timings=timings)


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
                    help=">1: shard points over a mesh of this many devices (Barnes-Hut)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="tsne_out.npy")
    args = ap.parse_args(argv)

    from repro_torch.data.datasets import make_dataset

    x, _ = make_dataset(args.dataset, n=args.n)
    if args.devices <= 1:
        from repro_torch.api import TSNE
        est = TSNE(method=args.method, perplexity=args.perplexity, angle=args.theta,
                   n_iter=args.iters, verbose=1, device=args.device)
        emb = est.fit_transform(x)
        np.save(args.out, emb)
        print(f"KL={est.kl_divergence_:.4f} n_iter={est.n_iter_} -> {args.out}")
        return

    from repro_torch.core.distributed import make_mesh
    from repro_torch.core.tsne import TsneConfig
    mesh = make_mesh(args.devices, args.device)
    cfg = TsneConfig(perplexity=args.perplexity, theta=args.theta, n_iter=args.iters)
    run = run_distributed(mesh, x, cfg, args.iters)
    for it, kl in run.kl_history:
        print(f"iter {it} KL {kl:.4f}")
    np.save(args.out, run.y)
    print(f"distributed run done ({args.devices} shards, n={run.n}) -> {args.out}")


if __name__ == "__main__":
    main()
