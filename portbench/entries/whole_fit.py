"""Entry ``whole_fit``: whole ``repro_torch.api.TSNE(...).fit(x)`` calls on
host numpy input, back to back, each on a fresh seeded draw.

A unit is one fit; its input is drawn on the device and copied to the
host before the timed call.  Set-up fits once at full size for
``warmup_steps`` steps on an input of its own.  The judged fit is the
last one run.  Judged, against the reference's P from exact neighbours
and the exact O(N^2) forces at the fit's ``embedding_``:

- the fit's P (``neighbor_graph_``);
- the fit's ``kl_divergence_`` against the exact KL at ``embedding_``;
- the exact Z at ``embedding_`` over N (N - 1), the Z of an embedding
  collapsed to one point: about 1 where the descent left its start;
- the program's descent step (``core.tsne.tsne_step`` with the fit's
  backend) at ``embedding_``, from velocity 0 and gains 1, against the
  step with the exact gradient.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import common, data
from portbench.schedule import after_last_step, tsne_config
from portbench.reference import tsne_ref as ref

UNITS = {"fit_s": "s"}


def _draw(ctx) -> np.ndarray:
    c = ctx.cell.config
    x, _ = data.planted_clusters(c["n"], c["dim"], c["classes"], c["latent"], ctx.gen,
                                 ctx.device)
    return x.cpu().numpy()


def _estimator(ctx, n_iter: int):
    from repro_torch.api import TSNE
    c, t = ctx.cell.config, ctx.cell.traffic
    return TSNE(
        perplexity=c["perplexity"], early_exaggeration=c["early_exaggeration"],
        learning_rate=c["learning_rate"], n_iter=n_iter, method=t["method"],
        angle=c["theta"], random_state=ctx.random_state, kl_every=t["kl_every"],
        neighbor_method=t["neighbor_method"],
        backend_options=dict(t.get("backend_options", {}),
                             exaggeration_iters=c["exaggeration_iters"],
                             momentum_initial=c["momentum_initial"],
                             momentum_final=c["momentum_final"],
                             momentum_switch_iter=c["momentum_switch_iter"],
                             min_gain=c["min_gain"]),
        device=ctx.device)


def setup(cell, seed: int, device):
    ctx = SimpleNamespace(cell=cell, seed=seed, device=torch.device(device),
                          gen=data.generator(seed, 0, device),
                          random_state=int(seed) % 2**31, last=None)
    _estimator(ctx, cell.traffic["warmup_steps"]).fit(_draw(ctx))
    return ctx


def run_unit(ctx) -> dict:
    ctx.last = None            # the previous fit's state goes before this one starts
    x = _draw(ctx)
    est = _estimator(ctx, ctx.cell.config["n_iter"])
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(x)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ctx.last = (x, est)
    return {"seconds": seconds, "steps": est.n_iter_, "timings": dict(est.timings_)}


def traced_unit(ctx, steps: int) -> common.Trace:
    """One more whole fit, traced (``steps`` is not used: a fit is whole)."""
    return common.profiled(lambda: run_unit(ctx), ctx.device)[1]


def end_to_end(ctx, units: list, window_s: float) -> dict:
    return {"fit_s": sum(u["seconds"] for u in units) / len(units)}


def answers(ctx) -> dict:
    """The program's answers of the judged fit."""
    from repro_torch.api import make_backend
    from repro_torch.core.tsne import TsneState, tsne_step
    x, est = ctx.last
    cell = ctx.cell
    n = x.shape[0]
    g = est.neighbor_graph_
    rows, cols, vals = ref.ell_entries(g.p_cols, g.p_vals, g.p_len)
    y = torch.as_tensor(np.asarray(est.embedding_), device=ctx.device)
    state = TsneState(y=y, velocity=torch.zeros_like(y), gains=torch.ones_like(y),
                      iteration=cell.config["n_iter"])
    exag, mom = after_last_step(cell)
    cfg = tsne_config(cell, cell.config["n_iter"])
    new, _ = tsne_step(state, g, exag, mom, backend=make_backend(cfg.method, cfg, n),
                       lr=cfg.resolve_lr(n), min_gain=cfg.min_gain)
    return {"keys": rows * n + cols, "vals": vals, "kl": float(est.kl_divergence_),
            "velocity": new.velocity.double()}


def free(ctx) -> None:
    x, est = ctx.last
    ctx.judged = (x, torch.as_tensor(np.asarray(est.embedding_)))
    ctx.last = None


def _reference_p(x: torch.Tensor, cell, dtype):
    n = x.shape[0]
    k = min(int(3 * cell.config["perplexity"]), n - 1)
    idx, d2 = ref.knn(x, k, dtype)
    return ref.symmetrize(idx, ref.conditional_p(d2, cell.config["perplexity"], dtype), n)


def _exact(y: torch.Tensor, keys, vals, n: int, dtype):
    rows, cols = keys // n, keys % n
    everyone = torch.arange(n, device=y.device)
    f_attr, kl_attr = ref.attraction(y, n, rows, cols, vals, everyone, dtype)
    f_rep = ref.repulsion_rows(y, everyone, dtype)
    return f_attr, f_rep, ref.z_all(y, dtype), kl_attr


def _step(cell, y, f_attr, f_rep, z, dtype):
    exag, mom = after_last_step(cell)
    grad = ref.gradient(f_attr, f_rep, z, exag)
    zero = torch.zeros_like(grad)
    return ref.step_velocity(grad, zero, torch.ones_like(grad),
                             ref.learning_rate(cell.config, y.shape[0]), mom,
                             cell.config["min_gain"])


def control_answers(ctx) -> dict:
    """The reference in the program's place, in bfloat16."""
    bf = torch.bfloat16
    x, est = ctx.last
    n = x.shape[0]
    keys, vals = _reference_p(torch.as_tensor(x, device=ctx.device), ctx.cell, bf)
    y = torch.as_tensor(np.asarray(est.embedding_), device=ctx.device)
    f_attr, f_rep, z, kl_attr = _exact(y, keys, vals, n, bf)
    return {"keys": keys, "vals": vals.double(), "kl": ref.kl(vals, kl_attr, z),
            "velocity": _step(ctx.cell, y, f_attr, f_rep, z, bf).double()}


def judge(ctx, ans: dict) -> tuple[dict, dict]:
    f64 = torch.float64
    x, y = ctx.judged
    n = x.shape[0]
    x = torch.as_tensor(x, device=ctx.device)
    y = y.to(ctx.device)
    keys, vals = _reference_p(x, ctx.cell, f64)
    p_l1 = ref.l1(keys, vals, ans["keys"], ans["vals"])
    f_attr, f_rep, z, kl_attr = _exact(y, keys, vals, n, f64)
    kl_exact = ref.kl(vals, kl_attr, z)
    v_ref = _step(ctx.cell, y, f_attr, f_rep, z, f64)
    step_rel = float(torch.linalg.norm(ans["velocity"] - v_ref) / torch.linalg.norm(v_ref))
    readings = {"p_l1": p_l1, "step_rel": step_rel,
                "kl_rel": abs(ans["kl"] - kl_exact) / kl_exact,
                "z_ratio": float(z) / (n * (n - 1.0))}
    counts = {"n": n, "dim": int(x.shape[1]), "nnz": int(keys.shape[0]),
              "kl_exact": kl_exact, "z_exact": float(z)}
    return readings, counts
