"""Drive the PyTorch/CUDA port on one GPU: build, check, fit, report.

    python3 chip_smoke.py                  # the full run: one card, no arguments
    python3 chip_smoke.py --n-iter 10      # shorter descent, same phases

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device   -- a CUDA device is required; prints the card's name and power
               limit as nvidia-smi reports them; TF32 off for matmul/cuDNN.
2. build    -- compiles every kernel in src/repro_torch/csrc (one nvcc per
               source, all in parallel) and prints the seconds it took.
3. kernels  -- each kernel against its plain PyTorch twin on the card at
               the main path's shapes (MNIST size, 70 000 x 784, K = 90),
               with the tolerance stated beside each check; CUDA-event
               timings (median of several runs) of kernel, plain version
               and, where one exists, a single PyTorch library call.
4. gradient -- bh_gradient at a fixed y, N = 5 000, on the card against
               the port's own CPU path; and a small fit (N = 500) on the
               card against the same fit on the CPU.
5. fit      -- repro_torch.api.TSNE(method="barnes_hut",
               neighbor_method="exact", perplexity=30, random_state=0) on
               make_dataset("mnist") (70 000 x 784), with every kernel's
               launch count reset before and read after; all four must be
               > 0, and the embedding and KL must be finite.  300 descent
               steps (150 exaggerated) instead of the default 1 000 keep
               the script well inside its time limit.
6. breakdown -- one descent step at the fitted embedding, stage by stage
               (Morton, sort, tree, summaries, traversal, attractive,
               update), to show where a step's time goes; and the card's
               busy time over one more step from a torch.profiler trace.

The line before the last is the kernels JSON object; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM data-sheet peaks (dense): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# Main-path KNN blocks: larger than the JAX defaults (512 x 2048), which
# were sized for TPU VMEM; a [4096, 8192] fp32 tile is 128 MiB on the card.
KNN_BLOCK_Q = 4096
KNN_BLOCK_DB = 8192


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps: int = 5, inner: int = 3) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {len(logs)} kernels compiled in {time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels(x: torch.Tensor, k: int, perplexity: float) -> list[dict]:
    from repro_torch.core import _pairwise, attractive, bsp, knn, morton, similarity
    from repro_torch.kernels import ops

    reg = ops.kernel_registry()
    dev = x.device
    n, d = x.shape
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = []

    def row(name, err, ms, plain_ms, flops, nbytes, library_ms=None):
        b_ms, b_by = bound(flops, nbytes)
        e = reg[name]
        rows.append(dict(name=name, route="cuda", source=e["source"],
                         replaces=e["replaces"], tpu_kernel=e["tpu"], launches=0,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=library_ms))
        log(f"kernel {name}: max_abs_err {err:.3e}  {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  library {library_ms}")

    # pairwise_sq_dists: one [KNN_BLOCK_Q, KNN_BLOCK_DB] x 784 tile of the KNN
    q = x[:KNN_BLOCK_Q].contiguous()
    c = x[KNN_BLOCK_Q:KNN_BLOCK_Q + KNN_BLOCK_DB].contiguous()
    qn, cn = torch.sum(q * q, 1), torch.sum(c * c, 1)
    out = ops.pairwise_sq_dists_cuda(q, c, qn, cn)
    ref = _pairwise.pairwise_sq_dists(q, c, qn, cn)
    # the |q|^2+|c|^2-2qc form cancels: its fp32 error scales with the norms
    tol = 2e-4 * ref.abs() + 1e-5 * (qn[:, None] + cn[None, :])
    if not bool(((out - ref).abs() <= tol).all()):
        fail("pairwise_sq_dists kernel disagrees with its plain version")
    nq, nc = q.shape[0], c.shape[0]
    row("pairwise_sq_dists", float((out - ref).abs().max()),
        cuda_ms(lambda: ops.pairwise_sq_dists_cuda(q, c, qn, cn)),
        cuda_ms(lambda: _pairwise.pairwise_sq_dists(q, c, qn, cn)),
        flops=2.0 * nq * nc * d + 3.0 * nq * nc,
        nbytes=4.0 * ((nq + nc) * d + nq + nc + nq * nc),
        library_ms=cuda_ms(lambda: torch.cdist(q, c).square()))

    # bsp_search on the real [N, K] distances of the main path
    idx, d2 = knn.knn(x, k, KNN_BLOCK_Q, KNN_BLOCK_DB)
    p_k, b_k = ops.bsp_search_cuda(d2, perplexity)
    p_p, b_p = bsp.binary_search_perplexity_plain(d2, perplexity)
    # rtol 1e-5: the parity target of the Pallas kernel against XLA
    if not (torch.allclose(p_k, p_p, rtol=1e-5, atol=1e-7)
            and torch.allclose(b_k, b_p, rtol=1e-5)):
        fail(f"bsp_search kernel disagrees: max |dp| {float((p_k - p_p).abs().max()):.3e}, "
             f"max |dbeta|/beta {float(((b_k - b_p).abs() / b_p.abs()).max()):.3e}")
    nk = d2.numel()
    row("bsp_search", float((p_k - p_p).abs().max()),
        cuda_ms(lambda: ops.bsp_search_cuda(d2, perplexity)),
        cuda_ms(lambda: bsp.binary_search_perplexity_plain(d2, perplexity), reps=3, inner=1),
        # 65 passes (64 bisection steps + the final one), each an exp and
        # ~5 fp32 operations an entry; d2 read once, cond_p written once
        flops=65.0 * 6.0 * nk, nbytes=4.0 * (2 * nk + n))

    # morton_encode on N points of an embedding-sized spread
    y = (torch.randn((n, 2), generator=gen) * 20.0).to(dev)
    cent, r_span = morton.span_radius(y)
    codes_k = ops.morton_encode_cuda(y, cent, r_span)
    codes_p = morton.morton_encode(y, cent, r_span)
    if not bool((codes_k == codes_p).all()):
        fail("morton_encode kernel is not bit-identical to its plain version")
    row("morton_encode", float((codes_k - codes_p).abs().max()),
        cuda_ms(lambda: ops.morton_encode_cuda(y, cent, r_span), inner=20),
        cuda_ms(lambda: morton.morton_encode(y, cent, r_span), inner=20),
        flops=6.0 * n, nbytes=8.0 * n + 8.0 * n + 12.0)

    # attractive_ell on the real symmetric graph of the main path
    sym_cols, sym_vals = similarity.symmetrize_ell(idx.cpu().numpy(), p_k.cpu().numpy())
    cols = torch.as_tensor(sym_cols, device=dev)
    vals = torch.as_tensor(sym_vals / sym_vals.sum(), device=dev).to(torch.float32)
    f_k, kl_k = ops.attractive_ell_cuda(y, cols, vals)
    f_p, kl_p = attractive.attractive_forces_ell(y, cols, vals)
    # summation order differs (warp tree vs torch reduction): rtol 1e-4 with
    # an absolute floor at 1e-5 of the largest force, KL to 1e-5 relative
    f_scale = float(f_p.abs().max())
    if not (torch.allclose(f_k, f_p, rtol=1e-4, atol=1e-5 * f_scale)
            and abs(float(kl_k) - float(kl_p)) <= 1e-5 * abs(float(kl_p))):
        fail("attractive_ell kernel disagrees with its plain version")
    nw = cols.numel()
    row("attractive_ell", float((f_k - f_p).abs().max()),
        cuda_ms(lambda: ops.attractive_ell_cuda(y, cols, vals), inner=10),
        cuda_ms(lambda: attractive.attractive_forces_ell(y, cols, vals)),
        flops=13.0 * nw, nbytes=8.0 * nw + 8.0 * n + 8.0 * n + 4.0)
    log(f"graph: N={n} K={k} W={cols.shape[1]}")
    return rows


def phase_gradient(x: torch.Tensor) -> None:
    from repro_torch.api import TSNE
    from repro_torch.core.tsne import TsneConfig, bh_gradient, preprocess

    n = 5000
    cfg = TsneConfig(perplexity=30.0, knn_block_q=KNN_BLOCK_Q, knn_block_db=KNN_BLOCK_DB)
    graph, _ = preprocess(x[:n].contiguous(), cfg)
    rng = np.random.default_rng(0)
    y = rng.normal(size=(n, 2)).astype(np.float32) * 5.0

    def grad_on(dev):
        res = bh_gradient(torch.as_tensor(y, device=dev), graph.p_cols.to(dev),
                          graph.p_vals.to(dev), None, 0.5, 12.0, 16,
                          graph.p_logp.to(dev))
        return res.grad.cpu(), float(res.kl)

    g_gpu, kl_gpu = grad_on(x.device)
    g_cpu, kl_cpu = grad_on("cpu")
    rel = float(torch.linalg.norm(g_gpu - g_cpu) / torch.linalg.norm(g_cpu))
    # same tree on both devices (bit-identical codes, stable sort); only
    # summation order differs, which can flip a rare opening decision
    log(f"gradient N={n}: |g_gpu - g_cpu| / |g_cpu| = {rel:.3e}, "
        f"KL gpu {kl_gpu:.6f} cpu {kl_cpu:.6f}")
    if not rel < 1e-3 or not abs(kl_gpu - kl_cpu) <= 1e-4 * abs(kl_cpu):
        fail("bh_gradient on the card disagrees with the CPU path")

    xs = x[:500].cpu().numpy()
    y0 = 1e-4 * rng.normal(size=(500, 2)).astype(np.float32)
    kls = {}
    for dev in (x.device, "cpu"):
        est = TSNE(perplexity=15.0, n_iter=100, kl_every=50, random_state=0, device=dev)
        est.fit(xs, y0=y0)
        kls[str(dev)] = est.kl_divergence_
    log(f"small fit N=500, 100 iterations: KL {kls}")
    a, b = kls.values()
    # trajectories drift apart through float order only; 2% on the final KL
    if not (np.isfinite(a) and abs(a - b) <= 0.02 * abs(b)):
        fail("small fit on the card disagrees with the CPU fit")


def phase_fit(x_np: np.ndarray, n_iter: int, exag_iters: int, kl_every: int):
    from repro_torch.api import TSNE
    from repro_torch.kernels import ops

    stats = []
    est = TSNE(method="barnes_hut", neighbor_method="exact", perplexity=30,
               random_state=0, n_iter=n_iter, kl_every=kl_every, verbose=1,
               callbacks=[stats.append],
               backend_options=dict(knn_block_q=KNN_BLOCK_Q, knn_block_db=KNN_BLOCK_DB,
                                    exaggeration_iters=exag_iters,
                                    momentum_switch_iter=exag_iters))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    est.fit(x_np)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    t = est.timings_
    log("fit phases (s): " + json.dumps(
        {k: t[k] for k in ("knn", "bsp", "symmetrize", "gradient_descent")}))
    log(f"fit: wall {wall:.2f} s, {t['gradient_descent'] / est.n_iter_:.4f} s per "
        f"descent step over {est.n_iter_} steps")
    log("fit KL checkpoints: " + json.dumps([[int(i), float(v)] for i, v in est.kl_history_]))
    log(f"fit max_traversal: {max(s.max_traversal for s in stats)}")
    log(f"fit launches: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"the fit never launched: {missing}")
    emb = est.embedding_
    if emb.shape != (x_np.shape[0], 2) or not np.isfinite(emb).all():
        fail(f"embedding not finite or of wrong shape {emb.shape}")
    if not np.isfinite(est.kl_divergence_):
        fail("final KL is not finite")
    return est, launches


def phase_breakdown(est) -> dict:
    """Seconds of each stage of one descent step at the fitted embedding
    (device synchronised around each stage; median of 3 steps)."""
    from repro_torch.core import morton, quadtree
    from repro_torch.core.repulsive import bh_repulsion_sorted
    from repro_torch.core.summarize import summarize
    from repro_torch.core.tsne import TsneState, combine_forces, gd_update
    from repro_torch.kernels import ops

    g = est.neighbor_graph_
    y = torch.as_tensor(est.embedding_).cuda()
    state = TsneState(y=y, velocity=torch.zeros_like(y), gains=torch.ones_like(y),
                      iteration=0)
    runs = []
    for _ in range(3):
        t = {}
        mark = [time.perf_counter()]

        def lap(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            t[name] = now - mark[0]
            mark[0] = now

        cent, r_span = morton.span_radius(y)
        codes = ops.morton_encode(y, cent, r_span, depth=16)
        lap("morton_encode")
        codes_s, y_s, perm = quadtree.sort_points_by_code(y, codes)
        lap("sort")
        tree = quadtree.build_quadtree(codes_s, depth=16)
        lap("build_quadtree")
        summ = summarize(tree, y_s, r_span)
        lap("summarize")
        rep = bh_repulsion_sorted(y_s, tree, summ, 0.5)
        lap("traversal")
        f_rep = torch.empty_like(y)
        f_rep[perm] = rep.force
        f_attr, kl_attr = ops.attractive_ell(y, g.p_cols, g.p_vals)
        lap("attractive")
        res = combine_forces(f_attr, kl_attr, f_rep, rep.z_per_point.sum(), 1.0,
                             g.p_logp, torch.max(rep.steps))
        gd_update(state, res.grad, est.learning_rate_, 0.8, 0.01)
        lap("combine_and_update")
        t["max_traversal"] = int(res.max_traversal)
        runs.append(t)
    out = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    total = sum(v for k, v in out.items() if k != "max_traversal")
    out["total"] = total
    out["traversal_share"] = out["traversal"] / total

    # device busy time of one BH gradient from a torch.profiler trace: the
    # summed durations of the CUDA kernel events (CPU ops' device time
    # would count each kernel twice); the share divides it by the
    # unprofiled step time measured above
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.tsne import bh_gradient
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bh_gradient(y, g.p_cols, g.p_vals, None, 0.5, 1.0, 16, g.p_logp)
        torch.cuda.synchronize()
    by_kernel: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_kernel.values())
    if busy_us > 0:
        out["device_busy_s"] = busy_us * 1e-6
        out["device_idle_share"] = 1.0 - min(1.0, out["device_busy_s"] / total)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        log("step device time by kernel (ms): " + json.dumps(
            {k[:70]: v * 1e-3 for k, v in top}))
    else:
        log("step device time: not measured (the profiler recorded no kernel)")
    log("step breakdown at the fitted embedding (s): " + json.dumps(out))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-iter", type=int, default=300)
    ap.add_argument("--exaggeration-iters", type=int, default=150)
    ap.add_argument("--kl-every", type=int, default=50)
    args = ap.parse_args()

    phase_device()
    from repro_torch.data.datasets import make_dataset
    phase_build()

    x_np, _ = make_dataset("mnist")
    x = torch.as_tensor(x_np).cuda()
    perplexity = 30.0
    rows = phase_kernels(x, int(3 * perplexity), perplexity)
    phase_gradient(x)
    est, launches = phase_fit(x_np, args.n_iter, args.exaggeration_iters, args.kl_every)
    phase_breakdown(est)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
