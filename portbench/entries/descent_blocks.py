"""Entry ``descent_blocks``: ``repro_torch.core.tsne.descend`` over blocks of
the fit's first steps, every block from the same initial state.

Set-up draws the data on the device, runs the program's ``preprocess``
(neighbours, perplexity search, host symmetrization) and ``init_state``,
builds the backend with ``repro_torch.api.make_backend`` and descends
``warmup_steps`` steps.  A unit is one block of the configuration's
``n_iter`` steps.
The traced stretch descends ``steps`` more steps from the window's last
state (the per-layer reader fixes how many).

Judged, on rows drawn from the seed: the program's graph against exact
neighbours (the share of each row's 10 nearest exact neighbours missing
from its P row), and the program's next step (``core.tsne.tsne_step``) from the
window's last state against the step with the exact gradient (its new
velocity), with its Z against the exact Z over all pairs.  The exact Z
over N (N - 1), the Z of an embedding collapsed to one point, is judged
too: about 1 where the block left its start.  The approximate graph
cannot be worked out again, so the exact gradient takes the program's P
rows as part of the state it follows; the graph is judged by itself
first.
"""
from __future__ import annotations

import dataclasses
import os
import time
from types import SimpleNamespace

import torch

from portbench import common, data
from portbench.schedule import after_last_step, tsne_config
from portbench.reference import tsne_ref as ref

UNITS = {"step_ms": "ms"}


def _descend(ctx, state, n_iter: int):
    from repro_torch.core.tsne import descend
    cfg = dataclasses.replace(ctx.cfg, n_iter=n_iter)
    return descend(state, ctx.graph, cfg, ctx.backend, ctx.lr,
                   kl_every=ctx.cell.traffic["kl_every"])


def setup(cell, seed: int, device):
    from repro_torch.api import make_backend
    from repro_torch.core.tsne import init_state, preprocess
    from repro_torch.device import MESH_DEVICES_ENV
    c = cell.config
    device = torch.device(device)
    x, _ = data.planted_clusters(c["n"], c["dim"], c["classes"], c["latent"],
                                 data.generator(seed, 0, device), device)
    cfg = tsne_config(cell, cell.config["n_iter"], seed)
    # the program's forced mesh size (S shards over the visible cards,
    # repeated), set for the preprocess only
    before = os.environ.get(MESH_DEVICES_ENV)
    if cell.traffic.get("mesh_devices"):
        os.environ[MESH_DEVICES_ENV] = str(cell.traffic["mesh_devices"])
    try:
        graph, _ = preprocess(x, cfg)
    finally:
        if before is None:
            os.environ.pop(MESH_DEVICES_ENV, None)
        else:
            os.environ[MESH_DEVICES_ENV] = before
    n = x.shape[0]
    ctx = SimpleNamespace(cell=cell, seed=seed, device=device, x=x, cfg=cfg, graph=graph,
                          state0=init_state(n, cfg, device),
                          backend=make_backend(cfg.method, cfg, n), lr=cfg.resolve_lr(n),
                          state=None, k=min(int(3 * c["perplexity"]), n - 1),
                          knn_rows=_rows(seed, 1, n, cell.reference["knn_rows"], device),
                          step_rows=_rows(seed, 2, n, cell.reference["step_rows"], device))
    _descend(ctx, ctx.state0, cell.traffic["warmup_steps"])
    return ctx


def run_unit(ctx) -> dict:
    t0 = time.perf_counter()
    state, _, _, n_run = _descend(ctx, ctx.state0, ctx.cell.config["n_iter"])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    ctx.state = state
    return {"seconds": time.perf_counter() - t0, "steps": n_run}


def traced_unit(ctx, steps: int) -> common.Trace:
    """``steps`` more steps from the window's last state, traced (a block
    if no reader fixes the count); the judged state stays the window's."""
    steps = steps or ctx.cell.config["n_iter"]
    return common.profiled(lambda: _descend(ctx, ctx.state, steps), ctx.device)[1]


def end_to_end(ctx, units: list, window_s: float) -> dict:
    return {"step_ms": window_s * 1e3 / sum(u["steps"] for u in units)}


def _rows(seed: int, stream: int, n: int, m: int, device) -> torch.Tensor:
    """The judged rows: ``m`` of the ``n`` drawn from the seed, sorted."""
    g = data.generator(seed, stream, device)
    return torch.randperm(n, generator=g, device=device)[:min(m, n)].sort().values


def answers(ctx) -> dict:
    """The program's graph rows and next step on the judged rows."""
    from repro_torch.core.tsne import tsne_step
    exag, mom = after_last_step(ctx.cell)
    new, stats = tsne_step(ctx.state, ctx.graph, exag, mom, backend=ctx.backend,
                           lr=ctx.lr, min_gain=ctx.cfg.min_gain)
    kr, g = ctx.knn_rows, ctx.graph
    return {"support": (g.p_cols[kr], g.p_len[kr]), "p_rows": _p_rows(ctx),
            "velocity": new.velocity[ctx.step_rows].double(), "z": float(stats.z)}


def _p_rows(ctx):
    """The program's P rows of the judged rows, which the exact step follows."""
    sr, g = ctx.step_rows, ctx.graph
    return g.p_cols[sr], g.p_vals[sr], g.p_len[sr]


def free(ctx) -> None:
    """Drop the program's state but the data and the window's last state."""
    ctx.graph = ctx.backend = ctx.state0 = None


def control_answers(ctx) -> dict:
    """The reference in the program's place, in bfloat16."""
    bf = torch.bfloat16
    idx, _ = ref.knn(ctx.x, ctx.k, bf, rows=ctx.knn_rows)
    p_rows = _p_rows(ctx)
    v, z = _reference_step(ctx, p_rows, bf, bf)
    return {"support": (idx, torch.full((idx.shape[0],), ctx.k, device=idx.device)),
            "p_rows": p_rows, "velocity": v.double(), "z": float(z)}


def _reference_step(ctx, p_rows, dtype, z_dtype):
    """The exact step's new velocity on the judged rows, and the exact Z."""
    c = ctx.cell.config
    exag, mom = after_last_step(ctx.cell)
    sr, st = ctx.step_rows, ctx.state
    y = st.y
    rows, cols, vals = ref.ell_entries(*p_rows)
    f_attr, _ = ref.attraction(y, sr.shape[0], rows, cols, vals, sr, dtype)
    f_rep = ref.repulsion_rows(y, sr, dtype)
    z = ref.z_all(y, z_dtype)
    grad = ref.gradient(f_attr, f_rep, z, exag)
    v = ref.step_velocity(grad, st.velocity[sr].to(grad.dtype), st.gains[sr].to(grad.dtype),
                          ref.learning_rate(c, y.shape[0]), mom, c["min_gain"])
    return v, z


def judge(ctx, ans: dict) -> tuple[dict, dict]:
    n = int(ctx.x.shape[0])
    exact_idx, _ = ref.knn(ctx.x, ctx.k, torch.float64, rows=ctx.knn_rows)
    # Z's terms in float32 (1.67e12 pairs at full size), summed in float64
    v_ref, z = _reference_step(ctx, ans["p_rows"], torch.float64, torch.float32)
    _, mom = after_last_step(ctx.cell)
    moved = v_ref - mom * ctx.state.velocity[ctx.step_rows].double()
    step_rel = float(torch.linalg.norm(ans["velocity"] - v_ref) / torch.linalg.norm(moved))
    # the share of each row's m nearest exact neighbours missing from its P row
    miss = {m: 1.0 - ref.recall(exact_idx[:, :m], *ans["support"]) for m in (1, 10, 30, ctx.k)}
    readings = {"knn10_miss": miss[10], "step_rel": step_rel,
                "z_rel": abs(ans["z"] - float(z)) / float(z),
                "z_ratio": float(z) / (n * (n - 1.0))}
    return readings, {"n": n, "dim": int(ctx.x.shape[1]), "z_exact": float(z),
                      **{f"knn_miss_{m}": v for m, v in miss.items()}}
