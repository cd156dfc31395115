"""Drive the PyTorch/CUDA port on one GPU: build, check, fit, report.

    python3 chip_smoke.py                  # the full run: one card, no arguments
    python3 chip_smoke.py --n-iter 300 --exaggeration-iters 150   # shorter descents

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device   -- a CUDA device is required; prints the card's name and power
               limit as nvidia-smi reports them; TF32 off for matmul/cuDNN.
2. build    -- compiles every kernel in src/repro_torch/csrc (one nvcc per
               source, all in parallel) and prints the seconds it took.
3. kernels  -- each kernel's wrapper (the call the main path makes)
               against its plain PyTorch twin on the card at
               the main path's shapes (MNIST size, 70 000 x 784, K = 90),
               with the tolerance stated beside each check; CUDA-event
               timings (median of several runs) of kernel, plain version
               and, where one exists, a single PyTorch library call,
               and the kernel's device time from a torch.profiler trace.
               pairwise is also checked on ragged tiles (the main path's
               last block and chunk), on rows at no 16-byte boundary and
               at D = 781, at 1, 2 and 3 query rows (an embedding-service
               admission's) against a full 8 192-row chunk and the train
               split's ragged last chunk, and by the KNN of 4 096 queries
               from its tiles against the KNN from the plain tiles; the KNN of 100 rows
               five times each on the card must give the plain CPU KNN's
               indices (equal distances in index order); attractive with the
               rows' real lengths (p_len, as the fits call it) and over
               the full width W, both timed.  bsp is also checked on
               4 096 rows at every K where ops.bsp_plan changes its
               choice (1 .. 1024), rows of all-equal distances and of
               zeros among them, at 1 and 3 rows (K = 90, an admission's),
               and the chunked search must repeat the whole one bit for
               bit; its bound counts the SFU's exponentials.
               The FFT path's spread and gather are also checked at
               128 boxes and exactly on planted lattice-node points, boxes
               overhanging the lattice's edges included; both are checked
               for a bit-identical result from two calls (48 and 128
               boxes) and over every lattice size (n_boxes 1-128,
               N = 5 000; the gather also at N = 1, 31 and 33); the
               gather with real weights on boxes that overhang the
               lattice (its checked path); the spread on a compressed
               lattice (one far outlier puts the other points into the
               first band), which is timed.
               Device times from torch.profiler for every kernel row; the
               spread's also at 128 boxes.  bh_traverse (the Barnes-Hut
               walk: a pack kernel, then a thread a point over the
               packed node records) must repeat its plain twin bit for
               bit (force, z, steps) at N = 1, 31, 33, 1 000, 5 000 and
               70 000, theta 0.5 and 0.2 (and 0 up to N = 1 000), on
               compressed and uncompressed trees, at a random embedding,
               on duplicate and on coincident points, and on clusters
               1e4 apart whose warps straddle them (N = 69 997); its
               packed records must equal pack_nodes bit for bit.
4. gradient -- bh_gradient and fft_repulsion at a fixed y, N = 5 000, on
               the card against the port's own CPU path; and small fits
               (N = 500, Barnes-Hut and FFT) on the card against the same
               fits on the CPU.
5. fit      -- repro_torch.api.TSNE(method="barnes_hut",
               neighbor_method="exact", perplexity=30, random_state=0) on
               make_dataset("mnist") (70 000 x 784), with every kernel's
               launch count reset before and read after, the default
               1 000 descent steps (250 exaggerated); pairwise and bsp
               must be > 0, morton, attractive and bh_traverse launched
               once a step, every attractive launch must carry p_len, and
               the embedding and KL must be finite.  The fit is traced
               (trace= a path under build/): its spans fit, knn, bsp,
               symmetrize, gradient_descent (the four children of fit),
               early_exaggeration, main_phase and checkpoint; timings_ the
               spans' durations; a Chrome trace that json.load reads; the
               fit.iterations metric n_iter_.  Then bh_traverse at
               the fitted embedding: checked bit for bit as in 3 and timed
               (its kernels-line row, the pack's and the walk's device
               times apart), with the warps' mean union length against
               the mean walk of their longest lane.
6. breakdown -- one Barnes-Hut step at the fitted embedding, stage by
               stage (Morton, sort, tree, summaries, traversal,
               attractive, update), to show where a step's time goes,
               held against the backend's own gradient; and the card's
               idle share: kernel time from a torch.profiler trace of one
               descent step over the CUDA-event time a step of several
               run back to back with no sync, as the fit runs them.
7. fft fit  -- the same fit with method="fft" (48 boxes a dimension),
               also 1 000 steps (250 exaggerated); pairwise, bsp,
               attractive, fft_spread and fft_gather must be > 0, with
               spread = gather = attractive = steps run; traced and
               checked as in 5.  A second, untraced descent from the fit's
               graph and initial embedding (core.tsne.descend, the loop
               run_tsne runs) must give a bit-identical embedding and KL.
8. fft breakdown -- one FFT step at its fitted embedding, stage by stage
               (coords, spread, convolution, gather, attractive, update)
               through the functions fft_repulsion calls, held against
               the backend's own gradient; the spread and gather kernels'
               device times at the fitted embedding, alone and in the
               profiled step; and the idle share as in 6.

9. approx-knn -- rp_forest (default options) and then nn_descent on all of
               make_dataset("mouse_1p3m") (1 291 337 x 20, K = 90): the
               seconds of each, every row valid (in range, no self, no
               duplicate), the reported d2 the true distance on 4 096
               sampled rows, and the recall on those rows against their
               exact neighbours (pairwise kernel tiles, self masked).  At
               N = 20 000 of the same rows the card's rp_forest graph
               against the CPU's (the same draws): recall of one against
               the other >= 0.99, their recalls against exact within 0.01.
10. approx fit -- TSNE(method="barnes_hut", neighbor_method="rp_forest",
               perplexity=30, random_state=0) on MNIST's train split (the
               first 60 000 rows) with a forest of 32 trees of >= 128
               points (APPROX_FOREST), at the other fits' steps: pairwise
               must launch 0 times, bsp > 0, morton, attractive and
               bh_traverse once a step; the same fit on the exact graph
               must end within 0.15 of its KL.
11. transform -- the 10 000 held-out rows through the rp_forest fit's
               query_index_ and through an exact index over the train
               split (rows/s of each at the default batch of 128; the
               exact one must launch pairwise_sq_dists and bsp_search,
               the forest one bsp_search); the forest query's recall
               against exact >= 0.9 (the default forest's printed beside
               it); embedding-space 5-NN label accuracy >= the input-space
               baseline - 0.05; 256 rows on the card against the CPU
               through the same exact index (the tolerance in the
               phase); save then load must serve the same transform.
12. service  -- EmbeddingService(slots=64, max_k=96) on the card, caching
               10's two fits as "mnist_forest" (its forest index) and
               "mnist_exact" (the exact-graph fit, whose ExactIndex runs
               pairwise tiles), traced; 2 048 held-out rows submitted to
               each, alternating, and drained with run(): every request
               done and finite; completed 4 096, slot occupancy up to 64,
               queue depth >= 1, both gauges 0 at the end; the
               transform_step probe grown by exactly 1 (the [64, 96]
               step); bsp_search launched once an admission, pairwise 8
               tiles an exact admission and none for a forest one.  Each
               model's results against its TSNE.transform of the same rows,
               and 256 requests on a CPU service against the card's
               (median |dy| <= 1e-5 x span, >= 98% of rows within 1e-3 x
               span).  Prints requests/s, latency p50/p95/p99, steps, ticks
               and the service.admit / service.tick span totals; then runs
               python -m repro_torch.embed.service --smoke --trace
               build/service_trace.json, which must exit 0 and write a
               trace that loads.

Every kernel must be launched by at least one of the two fits.  Each
driven path (the two fits and the service) has its launch counts set to
0 just before it and read just after.

The line before the last is the kernels JSON object; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM data-sheet peaks (dense): fp32 outside the tensor cores, TF32
# on the tensor cores, HBM3; and the special-function units (MUFU: exp2,
# log2, reciprocal), 16 results a clock on each of 132 SMs at 1.98 GHz.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
PEAK_SFU_OPS = 132 * 16 * 1.98e9

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build"

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


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS,
          sfu: float = 0.0) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the largest of flops at ``peak``, sfu
    special-function results (an expf is one) at the SFU rate, and nbytes
    at the HBM rate."""
    t_ops = max(flops / peak, sfu / PEAK_SFU_OPS) * 1e3
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
            if "entry function" in line:
                log(f"  {name}: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line:
                log(f"  {name}:   {line.strip()}")
    log(f"  pairwise: {build.load('pairwise').pairwise_smem_bytes()} bytes of dynamic "
        "shared memory a block")


def kernel_ms(fn, name: str, reps: int = 10) -> float | None:
    """Device milliseconds of one launch of the CUDA kernel whose name holds
    ``name`` (each wrapper launches one kernel a call): the mean over the
    launches that a torch.profiler trace of ``reps`` calls of ``fn``
    recorded.  The mean, not the sum over ``reps``: the trace can drop
    events.  None ("not measured") if three traces recorded no such launch."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):             # a trace that recorded no launch at all is taken again
        found = [us for k, durations in kernel_events(lambda: [fn() for _ in range(reps)]).items()
                 if name in k for us in durations]
        if len(found) != reps:
            log(f"device time of {name}: the trace recorded {len(found)} of {reps} launches")
        if found:
            return sum(found) * 1e-3 / len(found)
    return None


def pairwise_tol(d2, qn, cn):
    """The pairwise tolerance of a distance d2 between rows of squared norms
    qn and cn: the |q|^2+|c|^2-2qc form cancels, so its fp32 error scales
    with the norms."""
    return 2e-4 * d2.abs() + 1e-5 * (qn + cn)


def check_pairwise(what: str, q, c):
    """The kernel's tile against the plain version's (cuBLAS fp32) on the
    card; prints the error distribution and returns the largest error."""
    from repro_torch.core import _pairwise
    from repro_torch.kernels import ops
    qn, cn = torch.sum(q * q, 1), torch.sum(c * c, 1)
    out = ops.pairwise_sq_dists(q, c, qn, cn)
    ref = _pairwise.pairwise_sq_dists(q, c, qn, cn)
    err = (out - ref).abs()
    share = err / pairwise_tol(ref, qn[:, None], cn[None, :])
    sample = err.flatten()[::max(1, err.numel() // 1_000_000)].double()
    quant = torch.quantile(sample, torch.tensor([0.5, 0.99, 0.9999], dtype=torch.float64,
                                                device=sample.device)).tolist()
    log(f"pairwise {what}: [{q.shape[0]}, {q.shape[1]}] x [{c.shape[0]}, {c.shape[1]}], "
        f"byte offsets mod 16 {q.data_ptr() % 16} / {c.data_ptr() % 16}: max_abs_err "
        f"{float(err.max()):.3e} (|d| quantiles 50/99/99.99%: "
        f"{', '.join(f'{v:.3e}' for v in quant)}; largest distance {float(ref.max()):.3e}), "
        f"{float(share.max()):.3f} of the tolerance at most")
    if not bool((share <= 1.0).all()):
        fail(f"pairwise_sq_dists kernel disagrees with its plain version ({what})")
    return float(err.max())


def knn_rows(x, rows, k: int, dist):
    """K nearest neighbours of ``x[rows]`` among all rows of ``x`` (self
    excluded) from the tiles ``dist`` gives, in chunks of KNN_BLOCK_DB
    columns: (idx [R, k], d2 [R, k] ascending)."""
    n, nq = x.shape[0], rows.shape[0]
    q = x[rows].contiguous()
    q_sqn, sqn = torch.sum(q * q, 1), torch.sum(x * x, 1)
    big = torch.finfo(x.dtype).max
    best_d = torch.full((nq, k), big, dtype=x.dtype, device=x.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=x.device)
    for c0 in range(0, n, KNN_BLOCK_DB):
        c1 = min(c0 + KNN_BLOCK_DB, n)
        col = torch.arange(c0, c1, device=x.device)
        d2 = dist(q, x[c0:c1], q_sqn, sqn[c0:c1])
        d2 = d2.masked_fill(col[None, :] == rows[:, None], big)
        best_d, arg = torch.topk(torch.cat([best_d, d2], 1), k, dim=1, largest=False)
        best_i = torch.gather(torch.cat([best_i, col.expand(nq, -1)], 1), 1, arg)
    return best_i, best_d


def check_knn(x, k: int) -> None:
    """The KNN of the first KNN_BLOCK_Q rows from the kernel's tiles against
    the one from the plain tiles: every neighbour that one finds and the
    other does not must lie within the pairwise tolerance of the plain k-th
    distance (its own distance taken in float64)."""
    from repro_torch.core import _pairwise
    from repro_torch.kernels import ops
    nq = KNN_BLOCK_Q
    rows = torch.arange(nq, device=x.device)
    ik, _ = knn_rows(x, rows, k, ops.pairwise_sq_dists)
    ip, dp = knn_rows(x, rows, k, _pairwise.pairwise_sq_dists)
    sqn = torch.sum(x.double() ** 2, 1)
    worst = 0.0
    for mine, other in ((ik, ip), (ip, ik)):
        missed = ~(mine[:, :, None] == other[:, None, :]).any(-1)
        r, m = torch.nonzero(missed, as_tuple=True)
        j = mine[r, m]
        d_true = torch.sum((x[r].double() - x[j].double()) ** 2, 1)
        kth = dp[r, -1].double()
        if r.numel():
            tol = pairwise_tol(kth, sqn[r], sqn[j])
            worst = max(worst, float(((d_true - kth).abs() / tol).max()))
    shared = float((ik[:, :, None] == ip[:, None, :]).any(-1).float().mean())
    log(f"pairwise KNN check, {nq} queries x {k} neighbours: {shared:.6f} of the "
        f"neighbours shared; the others lie {worst:.3f} of the tolerance from the "
        f"plain k-th distance at most")
    if worst > 1.0:
        fail("the KNN from the kernel's tiles disagrees with the plain KNN")


def check_spread(what: str, g_k, g_p, quiet: bool = False) -> None:
    """The spread kernel's grid against the plain version's.  Both sum each
    node over the same products in other orders (the kernel's fixed
    in-order bands, the plain index_add_'s atomics on the card): rtol 1e-4
    with a floor at 1e-5 of the largest node value."""
    scale = float(g_p.abs().max())
    err = float((g_k - g_p).abs().max())
    if not torch.allclose(g_k, g_p, rtol=1e-4, atol=1e-5 * scale):
        fail(f"fft_spread kernel disagrees ({what}): max |d| {err:.3e} of max {scale:.3e}")
    if not quiet:
        log(f"fft_spread {what}: max_abs_err {err:.3e} (max {scale:.3e}; rtol 1e-4, "
            "atol 1e-5 x max)")


def check_bsp(what: str, p_k, b_k, p_p, b_p, quiet: bool = False) -> None:
    """The bsp kernel against the plain search: cond_p at rtol 1e-5 (atol
    1e-7), beta at rtol 1e-5, the Pallas kernel's parity target."""
    if not (torch.allclose(p_k, p_p, rtol=1e-5, atol=1e-7)
            and torch.allclose(b_k, b_p, rtol=1e-5)):
        fail(f"bsp_search kernel disagrees ({what}): max |dp| "
             f"{float((p_k - p_p).abs().max()):.3e}, max |dbeta|/beta "
             f"{float(((b_k - b_p).abs() / b_p.abs()).max()):.3e}")
    if not quiet:
        log(f"bsp_search {what}: max |dp| {float((p_k - p_p).abs().max()):.3e}, max "
            f"|dbeta|/beta {float(((b_k - b_p).abs() / b_p.abs()).nan_to_num().max()):.3e} "
            "(rtol 1e-5, atol 1e-7)")


def check_bsp_plans(gen, dev) -> None:
    """4 096 rows at every K where ops.bsp_plan changes its choice, and
    either side of it, with rows of all-equal distances and rows of zeros
    among them; perplexity K / 3, as the fits pick K, where that is above
    2 (K >= 7), and 1.5 below: at perplexity 1 or 2 the target entropy sits
    on the plateau of near-tied nearest neighbours (h tends to 0 or log 2
    as beta grows), where fp32 cannot decide the bisection (the plain
    search on the CPU and on the card disagree there in 15-502 of 4 096
    rows; chip_variants.py's bsp set, PERF.md)."""
    from repro_torch.core import bsp
    from repro_torch.kernels import ops
    changes = [k for k in range(2, ops.MAX_K + 1) if ops.bsp_plan(k) != ops.bsp_plan(k - 1)]
    ks = sorted({1, 5, 8, 16, 31, 32, 33, 64, 90, 96, 100, 128, 129, 256, 500, 1024}
                | set(changes) | {k - 1 for k in changes})
    for k in ks:
        d2 = torch.randn((4096, k), generator=gen).abs() * 4.0
        d2[::97] = 2.5           # all-equal distances
        d2[1::97] = 0.0          # zeros
        d2 = d2.to(dev)
        perp = k / 3.0 if k >= 7 else 1.5
        check_bsp(f"K = {k}", *ops.bsp_search(d2, perp),
                  *bsp.binary_search_perplexity_plain(d2, perp), quiet=True)
    log(f"bsp_search: K = {ks} (each side of every change of plan) on 4 096 rows, with "
        "all-equal and zero rows, within the tolerance")


def check_gather(what: str, ph_k, ph_p, quiet: bool = False) -> float:
    """The gather kernel against the plain gather: the same products and
    sum order, rtol 1e-5 with a floor at 1e-6 of the largest value where
    the 9 taps' signed Lagrange weights cancel.  Returns the largest error."""
    ph_scale = float(ph_p.abs().max()) if ph_p.numel() else 0.0
    err = float((ph_k - ph_p).abs().max()) if ph_p.numel() else 0.0
    if not torch.allclose(ph_k, ph_p, rtol=1e-5, atol=1e-6 * ph_scale):
        fail(f"fft_gather kernel disagrees ({what}): max |d| {err:.3e} of max {ph_scale:.3e}")
    if not quiet:
        log(f"fft_gather {what}: max_abs_err {err:.3e} (max {ph_scale:.3e}; rtol 1e-5, "
            "atol 1e-6 x max)")
    return err


def kernel_row(name, err, ms, plain_ms, flops, nbytes, library_ms=None,
               peak=PEAK_FP32_FLOPS, sfu=0.0, **extra) -> dict:
    """One entry of the kernels line (its launches are filled in after the
    fits), logged."""
    from repro_torch.kernels import ops
    b_ms, b_by = bound(flops, nbytes, peak, sfu)
    e = ops.kernel_registry()[name]
    log(f"kernel {name}: max_abs_err {err:.3e}  {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it)  "
        f"library {library_ms}" + "".join(f"  {k} {v}" for k, v in extra.items()))
    return dict(name=name, route="cuda", source=e["source"], replaces=e["replaces"],
                tpu_kernel=e["tpu"], launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, **extra)


def check_knn_ties(x: torch.Tensor) -> None:
    """KNN of 100 rows, each five times (adjacent, and 100 rows apart):
    on the card, through the pairwise kernel, the indices must be those of
    the plain KNN on the CPU, equal distances in index order as lax.top_k
    keeps them (the kernel must give a row's copies equal distances)."""
    from repro_torch.core import knn
    rows = x[:100]
    for layout, xs in (("adjacent", rows.repeat_interleave(5, 0)), ("apart", rows.repeat(5, 1))):
        for bq, bdb in ((128, 256), (512, 2048)):
            idx, d2 = knn.knn(xs, 6, bq, bdb)
            idx_p, d2_p = knn.knn(xs.cpu(), 6, bq, bdb)
            if not torch.equal(idx.cpu(), idx_p):
                fail(f"KNN of duplicated rows ({layout}, blocks {bq} x {bdb}): the card's "
                     f"indices differ from the CPU's in "
                     f"{int((idx.cpu() != idx_p).any(1).sum())} of {xs.shape[0]} rows")
    log("knn ties: 100 rows x 5 copies (adjacent and apart), k = 6, blocks 128 x 256 and "
        "512 x 2048: the card's indices equal the plain KNN's on the CPU")


def walk_inputs(y: torch.Tensor, compress: bool, depth: int = 16):
    """(y_sorted, tree, summaries) of embedding y, built as bh_gradient builds them."""
    from repro_torch.core import morton, quadtree
    from repro_torch.core.summarize import summarize
    from repro_torch.kernels import ops
    cent, r_span = morton.span_radius(y)
    codes_s, y_s, _ = quadtree.sort_points_by_code(y, ops.morton_encode(y, cent, r_span, depth))
    tree = quadtree.build_quadtree(codes_s, depth=depth, compress=compress)
    return y_s, tree, summarize(tree, y_s, r_span)


def check_traverse(what: str, y: torch.Tensor) -> None:
    """bh_traverse against its plain twin on the card, bit for bit (force,
    z and steps), at N = 1, 31, 33, 1 000, 5 000 and all of y, theta 0.5
    and 0.2, and 0 (every walk visits every node) up to N = 1 000, on the
    compressed and the uncompressed tree; and the records its first kernel
    packs against pack_nodes, bit for bit, over the valid nodes."""
    from repro_torch.core.repulsive import RECORD_WORDS, bh_repulsion_sorted, pack_nodes
    from repro_torch.kernels import ops
    longest = 0
    sizes = sorted({min(m, y.shape[0]) for m in (1, 31, 33, 1000, 5000, y.shape[0])})
    for m in sizes:
        for compress in (True, False):
            y_s, tree, summ = walk_inputs(y[:m].contiguous(), compress)
            n_nodes = int(tree.n_nodes)
            records = torch.full((tree.capacity, RECORD_WORDS), -1, dtype=torch.int32,
                                 device=y.device)
            ops.bh_traverse_cuda(y_s, tree, summ, 0.5, records=records)
            packed = pack_nodes(tree, summ)[:n_nodes]
            if not torch.equal(records[:n_nodes], packed):
                fail(f"bh_traverse's packed node records differ from pack_nodes ({what}, "
                     f"N = {m}, compress {compress}) at "
                     f"{int((records[:n_nodes] != packed).any(1).sum())} of {n_nodes} nodes")
            for theta in (0.5, 0.2, 0.0) if m <= 1000 else (0.5, 0.2):
                got = ops.bh_traverse(y_s, tree, summ, theta)
                ref = bh_repulsion_sorted(y_s, tree, summ, theta)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    fail(f"bh_traverse is not bit-identical to its plain twin ({what}, N = "
                         f"{m}, theta {theta}, compress {compress}): max |d force| "
                         f"{float((got.force - ref.force).abs().max()):.3e}, steps differ "
                         f"at {int((got.steps != ref.steps).sum())} points")
                longest = max(longest, int(ref.steps.max()))
    log(f"bh_traverse {what}: N = {', '.join(map(str, sizes))}; theta 0.5, 0.2 "
        f"(0 to N = 1 000); compressed and uncompressed trees: force, z and steps "
        f"bit-identical to the plain walk, packed records to pack_nodes (longest walk "
        f"{longest} steps)")


def phase_kernels(x: torch.Tensor, k: int, perplexity: float) -> list[dict]:
    from repro_torch.core import (
        _pairwise, attractive, bsp, fft_repulsion, knn, morton, similarity,
    )
    from repro_torch.kernels import ops

    dev = x.device
    n, d = x.shape
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = []

    def row(*args, **kwargs):
        rows.append(kernel_row(*args, **kwargs))

    # pairwise_sq_dists: one [KNN_BLOCK_Q, KNN_BLOCK_DB] x 784 tile of the KNN
    q = x[:KNN_BLOCK_Q].contiguous()
    c = x[KNN_BLOCK_Q:KNN_BLOCK_Q + KNN_BLOCK_DB].contiguous()
    qn, cn = torch.sum(q * q, 1), torch.sum(c * c, 1)
    err = check_pairwise("main tile", q, c)
    # ragged tiles: the main path's last query block and database chunk
    # (16-byte copies), and rows at no 16-byte boundary (4-byte copies): a
    # flat view one element in (x[1:1001] itself stays aligned at D = 784,
    # 3 136 bytes a row) and D = 781, not a multiple of 4
    check_pairwise("ragged last block", x[-(n % KNN_BLOCK_Q):], x[-(n % KNN_BLOCK_DB):])
    flat = x.reshape(-1)
    check_pairwise("misaligned flat view", flat[1:1 + 1000 * d].view(1000, d),
                   flat[5003 * d + 3:5003 * d + 3 + 3001 * d].view(3001, d))
    x781 = x[:, :781].contiguous()
    check_pairwise("D = 781", x781[1:1001], x781[5003:8004])
    # an admission's tiles: 1-3 held-out query rows against a full chunk
    # and the ragged last chunk of the train split
    last = TRAIN_ROWS // KNN_BLOCK_DB * KNN_BLOCK_DB
    for m in (1, 2, 3):
        qm = x[TRAIN_ROWS:TRAIN_ROWS + m]
        check_pairwise(f"{m} query rows, full chunk", qm, x[:KNN_BLOCK_DB])
        check_pairwise(f"{m} query rows, ragged last chunk", qm, x[last:TRAIN_ROWS])
    check_knn(x, k)
    nq, nc = q.shape[0], c.shape[0]
    log(f"pairwise yardstick: q @ c.T (cuBLAS fp32 product alone) "
        f"{cuda_ms(lambda: q @ c.T):.4f} ms")
    fp32_ms, _ = bound(2.0 * nq * nc * d + 3.0 * nq * nc,
                       4.0 * ((nq + nc) * d + nq + nc + nq * nc))
    ms = cuda_ms(lambda: ops.pairwise_sq_dists(q, c, qn, cn))
    # 3xTF32: three TF32 products on the tensor cores
    row("pairwise_sq_dists", err, ms, cuda_ms(lambda: _pairwise.pairwise_sq_dists(q, c, qn, cn)),
        flops=3 * 2.0 * nq * nc * d, nbytes=4.0 * ((nq + nc) * d + nq + nc + nq * nc),
        library_ms=cuda_ms(lambda: torch.cdist(q, c).square()), peak=PEAK_TF32_FLOPS,
        device_ms=kernel_ms(lambda: ops.pairwise_sq_dists(q, c, qn, cn), "pairwise"),
        bound_fp32_simt_ms=fp32_ms, fp32_simt_share=fp32_ms / ms)

    # bsp_search on the real [N, K] distances of the main path
    idx, d2 = knn.knn(x, k, KNN_BLOCK_Q, KNN_BLOCK_DB)
    p_k, b_k = ops.bsp_search(d2, perplexity)
    p_p, b_p = bsp.binary_search_perplexity_plain(d2, perplexity)
    check_bsp(f"[{n}, {k}], plan {tuple(ops.bsp_plan(k))}", p_k, b_k, p_p, b_p)
    # rows are independent and a row's arithmetic depends on K alone: the
    # chunked search (row slices at no 16-byte boundary) repeats it bit for bit
    p_c, b_c = bsp.binary_search_perplexity_chunked(d2, perplexity, chunk_size=10_007)
    if not (torch.equal(p_c, p_k) and torch.equal(b_c, b_k)):
        fail("bsp_search in chunks of 10 007 rows differs from the whole search")
    check_bsp_plans(torch.Generator(device="cpu").manual_seed(15), dev)
    # an admission's search: one row (and three), K = 90
    for rows_ in (d2[:1], d2[5:8]):
        check_bsp(f"[{rows_.shape[0]}, {k}]", *ops.bsp_search(rows_, perplexity),
                  *bsp.binary_search_perplexity_plain(rows_, perplexity))
    nk = d2.numel()
    fp32_ms, _ = bound(65.0 * 6.0 * nk, 0.0)
    row("bsp_search", float((p_k - p_p).abs().max()),
        cuda_ms(lambda: ops.bsp_search(d2, perplexity)),
        cuda_ms(lambda: bsp.binary_search_perplexity_plain(d2, perplexity), reps=3, inner=1),
        # 65 passes (64 bisection steps + the final one), each an expf (one
        # SFU result) and ~5 fp32 operations an entry; d2 read once,
        # cond_p written once
        flops=65.0 * 6.0 * nk, nbytes=4.0 * (2 * nk + n), sfu=65.0 * nk,
        device_ms=kernel_ms(lambda: ops.bsp_search(d2, perplexity), "bsp"),
        plan=list(ops.bsp_plan(k)), bound_fp32_ms=fp32_ms)

    check_knn_ties(x)

    # morton_encode on N points of an embedding-sized spread
    y = (torch.randn((n, 2), generator=gen) * 20.0).to(dev)
    cent, r_span = morton.span_radius(y)
    codes_k = ops.morton_encode(y, cent, r_span)
    codes_p = morton.morton_encode(y, cent, r_span)
    if not bool((codes_k == codes_p).all()):
        fail("morton_encode kernel is not bit-identical to its plain version")
    row("morton_encode", float((codes_k - codes_p).abs().max()),
        cuda_ms(lambda: ops.morton_encode(y, cent, r_span), inner=20),
        cuda_ms(lambda: morton.morton_encode(y, cent, r_span), inner=20),
        flops=6.0 * n, nbytes=8.0 * n + 8.0 * n + 12.0,
        device_ms=kernel_ms(lambda: ops.morton_encode(y, cent, r_span), "morton"))

    # bh_traverse on the same random embedding (its row, at the fitted
    # embedding, comes after the Barnes-Hut fit), on every third point
    # three times, on coincident points, and on far-apart clusters whose
    # Morton-consecutive points, the 32 of a warp, straddle them: every
    # other point in one of two clusters 1e4 apart, and clusters of 7
    # points on a grid 1e4 apart (N = 69 997, not a multiple of 32)
    check_traverse("random embedding", y)
    check_traverse("duplicate points", y[:n // 3].repeat_interleave(3, 0))
    check_traverse("coincident points", torch.zeros((33, 2), device=dev))
    far_gen = torch.Generator(device="cpu").manual_seed(19)
    far = torch.randn((69_997, 2), generator=far_gen)
    far[1::2] += 1e4
    check_traverse("two clusters 1e4 apart", far.to(dev))
    cluster = torch.arange(69_997) // 7
    far = torch.randn((69_997, 2), generator=far_gen) * 100.0 + 1e4 * torch.stack(
        [cluster % 100, cluster // 100], dim=1).to(torch.float32)
    check_traverse("7-point clusters 1e4 apart", far.to(dev))

    # attractive_ell on the real symmetric graph of the main path, with the
    # rows' real lengths (as the fits call it) and over the full width
    sym_cols, sym_vals = similarity.symmetrize_ell(idx.cpu().numpy(), p_k.cpu().numpy())
    cols = torch.as_tensor(sym_cols, device=dev)
    vals = torch.as_tensor(sym_vals / sym_vals.sum(), device=dev).to(torch.float32)
    p_len = torch.as_tensor(similarity.ell_row_lengths(sym_cols), device=dev)
    nnz, w = int(p_len.sum()), cols.shape[1]
    log(f"graph: N={n} K={k} W={w} nnz={nnz} ({nnz / (n * w):.1%} of N x W), row length "
        f"mean {nnz / n:.2f} max {int(p_len.max())}")
    errs = {}
    for what, lens in (("p_len", p_len), ("full W", None)):
        f_k, kl_k = ops.attractive_ell(y, cols, vals, lens)
        f_p, kl_p = attractive.attractive_forces_ell(y, cols, vals, lens)
        # summation order differs (warp tree vs torch reduction): rtol 1e-4
        # with an absolute floor at 1e-5 of the largest force, KL to 1e-5
        f_scale = float(f_p.abs().max())
        if not (torch.allclose(f_k, f_p, rtol=1e-4, atol=1e-5 * f_scale)
                and abs(float(kl_k) - float(kl_p)) <= 1e-5 * abs(float(kl_p))):
            fail(f"attractive_ell kernel ({what}) disagrees with its plain version")
        errs[what] = float((f_k - f_p).abs().max())
    full_ms = cuda_ms(lambda: ops.attractive_ell(y, cols, vals), inner=10)
    full_dev = kernel_ms(lambda: ops.attractive_ell(y, cols, vals), "attractive")
    # real entries only: cols and vals of nnz entries, y and row_len read,
    # force and the KL partials written; ~13 operations an entry
    a_flops, a_bytes = 13.0 * nnz, 8.0 * nnz + 8.0 * n + 4.0 * n + 8.0 * n + 4.0 * n
    a_bound, _ = bound(a_flops, a_bytes)
    log(f"attractive_ell full W (row_len=None): max_abs_err {errs['full W']:.3e}  "
        f"{full_ms:.4f} ms ({full_dev} ms on the device)  {a_bound / full_ms:.1%} "
        f"of the bound counted on nnz")
    row("attractive_ell", errs["p_len"],
        cuda_ms(lambda: ops.attractive_ell(y, cols, vals, p_len), inner=10),
        cuda_ms(lambda: attractive.attractive_forces_ell(y, cols, vals, p_len)),
        flops=a_flops, nbytes=a_bytes,
        device_ms=kernel_ms(lambda: ops.attractive_ell(y, cols, vals, p_len), "attractive"),
        nnz=nnz, full_w_ms=full_ms, full_w_device_ms=full_dev)

    # fft_spread / fft_gather on the same N points: 48 boxes (97 x 97
    # nodes, the main path's) for the rows, 128 boxes (257 x 257) checked
    # and timed too
    spread_extra = {}
    for n_boxes in (48, fft_repulsion.MAX_N_BOXES):
        base, wx, wy, _ = fft_repulsion.interp_coords(y, n_boxes)
        charges = fft_repulsion.point_charges(y)
        nodes = fft_repulsion.lattice_nodes(n_boxes)
        g_k = ops.fft_spread(base, wx, wy, charges, nodes)
        g_p = fft_repulsion.spread_to_grid(base, wx, wy, charges, nodes)
        check_spread(f"{n_boxes} boxes", g_k, g_p)
        # fixed-order sums: a second call gives the same bits
        if not torch.equal(ops.fft_spread(base, wx, wy, charges, nodes), g_k):
            fail(f"fft_spread kernel is not bit-identical from call to call at {n_boxes} boxes")
        pot = torch.randn((nodes, nodes, 4), generator=gen).to(dev)
        ph_k = ops.fft_gather(pot, base, wx, wy)
        ph_p = fft_repulsion.gather_from_grid(pot, base, wx, wy)
        check_gather(f"{n_boxes} boxes", ph_k, ph_p)
        # one order a point: a second call gives the same bits
        if not torch.equal(ops.fft_gather(pot, base, wx, wy), ph_k):
            fail(f"fft_gather kernel is not bit-identical from call to call at {n_boxes} boxes")
        log(f"fft interp {n_boxes} boxes: spread plan {tuple(ops.spread_plan(n, nodes))}; "
            "spread and gather bit-identical on a second call")
        # boxes that overhang the lattice (the gather's checked path): the
        # real weights, every 7th point's box moved one node past an edge
        ob = base.clone()
        ob[::7, 0] = -1
        ob[3::7, 1] = nodes - 2
        check_gather(f"{n_boxes} boxes, {int((ob != base).any(1).sum())} boxes overhanging",
                     ops.fft_gather(pot, ob, wx, wy),
                     fft_repulsion.gather_from_grid(pot, ob, wx, wy))

        # planted lattice-node points: one-hot weights, integer charges;
        # every partial sum is an exact integer, so both must be exact.
        # Boxes from -1 to n_boxes overhang both edges: taps off the
        # lattice are skipped by kernel and plain version alike
        pb = torch.randint(-1, n_boxes + 1, (n, 2), generator=gen, dtype=torch.int32) * 2
        taps = torch.randint(0, 3, (n, 2), generator=gen)
        pwx = torch.nn.functional.one_hot(taps[:, 0], 3).float()
        pwy = torch.nn.functional.one_hot(taps[:, 1], 3).float()
        pch = torch.randint(1, 5, (n, 3), generator=gen).float()
        ppot = torch.randint(-9, 9, (nodes, nodes, 4), generator=gen).float()
        pb, pwx, pwy, pch, ppot = (t.to(dev) for t in (pb, pwx, pwy, pch, ppot))
        if not torch.equal(ops.fft_spread(pb, pwx, pwy, pch, nodes),
                           fft_repulsion.spread_to_grid(pb, pwx, pwy, pch, nodes)):
            fail(f"fft_spread kernel is not exact on planted nodes at {n_boxes} boxes")
        if not torch.equal(ops.fft_gather(ppot, pb, pwx, pwy),
                           fft_repulsion.gather_from_grid(ppot, pb, pwx, pwy)):
            fail(f"fft_gather kernel is not exact on planted nodes at {n_boxes} boxes")
        log(f"fft interp {n_boxes} boxes: planted-node spread and gather exact "
            "(boxes overhanging the lattice included)")

        if n_boxes == 48:
            row_48 = (base, wx, wy, charges, nodes, g_k, g_p, pot, ph_k, ph_p)
        else:
            spread_extra.update(
                ms_128=cuda_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes), inner=20),
                device_ms_128=kernel_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes),
                                        "spread"))

    # every lattice size, N = 5 000, at the same tolerance; the gather also
    # at N = 1, 31 and 33 (a chunk's ragged tail)
    for n_boxes in range(1, fft_repulsion.MAX_N_BOXES + 1):
        ys = y[:5000]
        base, wx, wy, _ = fft_repulsion.interp_coords(ys, n_boxes)
        charges = fft_repulsion.point_charges(ys)
        nodes = fft_repulsion.lattice_nodes(n_boxes)
        check_spread(f"{n_boxes} boxes, N = 5 000", ops.fft_spread(base, wx, wy, charges, nodes),
                     fft_repulsion.spread_to_grid(base, wx, wy, charges, nodes), quiet=True)
        pot = torch.randn((nodes, nodes, 4), generator=gen).to(dev)
        for m in (5000, 1, 31, 33):
            b, xw, yw = base[:m].contiguous(), wx[:m].contiguous(), wy[:m].contiguous()
            check_gather(f"{n_boxes} boxes, N = {m}", ops.fft_gather(pot, b, xw, yw),
                         fft_repulsion.gather_from_grid(pot, b, xw, yw), quiet=True)
    log("fft_spread and fft_gather: n_boxes 1-128 at N = 5 000 (the gather also at "
        "N = 1, 31, 33) within the tolerance")

    # a compressed lattice: one point 1e4 away squeezes the other N - 1
    # into the first band (and the first columns), the worst balance of
    # the work between the kernel's blocks
    y_far = y.clone()
    y_far[0] = 1e4
    base, wx, wy, _ = fft_repulsion.interp_coords(y_far, 48)
    charges = fft_repulsion.point_charges(y_far)
    nodes = fft_repulsion.lattice_nodes(48)
    first_band = int((base[:, 0] < ops.spread_plan(n, nodes).rows_per_band).sum())
    check_spread(f"compressed lattice ({first_band} of {n} points meet the first band)",
                 ops.fft_spread(base, wx, wy, charges, nodes),
                 fft_repulsion.spread_to_grid(base, wx, wy, charges, nodes))
    spread_extra.update(
        compressed_ms=cuda_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes), inner=20),
        compressed_device_ms=kernel_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes),
                                       "spread"))

    base, wx, wy, charges, nodes, g_k, g_p, pot, ph_k, ph_p = row_48
    row("fft_spread", float((g_k - g_p).abs().max()),
        cuda_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes), inner=20),
        cuda_ms(lambda: fft_repulsion.spread_to_grid(base, wx, wy, charges, nodes)),
        # 9 tap weights + 27 products + 27 adds a point; base, weights and
        # charges read once, the grid written once
        flops=63.0 * n, nbytes=44.0 * n + 4.0 * nodes * nodes * 3,
        device_ms=kernel_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes), "spread"),
        **spread_extra)
    row("fft_gather", float((ph_k - ph_p).abs().max()),
        cuda_ms(lambda: ops.fft_gather(pot, base, wx, wy), inner=20),
        cuda_ms(lambda: fft_repulsion.gather_from_grid(pot, base, wx, wy)),
        # 9 tap weights + 36 products + 36 adds a point; base and weights
        # read, phi written, the potential read once
        flops=81.0 * n, nbytes=32.0 * n + 16.0 * n + 4.0 * nodes * nodes * 4,
        device_ms=kernel_ms(lambda: ops.fft_gather(pot, base, wx, wy), "gather"))
    return rows


def phase_gradient(x: torch.Tensor) -> None:
    from repro_torch.api import TSNE
    from repro_torch.core.fft_repulsion import fft_repulsion
    from repro_torch.core.tsne import TsneConfig, bh_gradient, preprocess

    n = 5000
    cfg = TsneConfig(perplexity=30.0, knn_block_q=KNN_BLOCK_Q, knn_block_db=KNN_BLOCK_DB)
    graph, _ = preprocess(x[:n].contiguous(), cfg)
    rng = np.random.default_rng(0)
    y = rng.normal(size=(n, 2)).astype(np.float32) * 5.0

    def grad_on(dev):
        res = bh_gradient(torch.as_tensor(y, device=dev), graph.p_cols.to(dev),
                          graph.p_vals.to(dev), None, 0.5, 12.0, 16,
                          graph.p_logp.to(dev), p_len=graph.p_len.to(dev))
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

    def fft_on(dev):
        f, z = fft_repulsion(torch.as_tensor(y, device=dev), n_boxes=48)
        return f.cpu(), float(z)

    f_gpu, z_gpu = fft_on(x.device)
    f_cpu, z_cpu = fft_on("cpu")
    rel = float(torch.linalg.norm(f_gpu - f_cpu) / torch.linalg.norm(f_cpu))
    z_rel = abs(z_gpu - z_cpu) / abs(z_cpu)
    # cuFFT vs pocketfft and the spread's sum order: forces to 1e-4
    # relative, z to 1e-5
    log(f"fft_repulsion N={n}, 48 boxes: |f_gpu - f_cpu| / |f_cpu| = {rel:.3e}, "
        f"z gpu {z_gpu:.6f} cpu {z_cpu:.6f} (rel {z_rel:.3e})")
    if not rel <= 1e-4 or not z_rel <= 1e-5:
        fail("fft_repulsion on the card disagrees with the CPU path")

    xs = x[:500].cpu().numpy()
    y0 = 1e-4 * rng.normal(size=(500, 2)).astype(np.float32)
    def small_fit_kl(method, dev):
        est = TSNE(method=method, perplexity=15.0, n_iter=100, kl_every=50,
                   random_state=0, device=dev)
        return est.fit(xs, y0=y0).kl_divergence_

    for method in ("barnes_hut", "fft"):
        a, b = (small_fit_kl(method, dev) for dev in (x.device, "cpu"))
        log(f"small {method} fit N=500, 100 iterations: KL card {a} cpu {b}")
        # trajectories drift apart through float order only; 2% on the final KL
        if not (np.isfinite(a) and abs(a - b) <= 0.02 * abs(b)):
            fail(f"small {method} fit on the card disagrees with the CPU fit")


# PR 17's untraced fits of the same configuration (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md section 5), printed beside the traced ones
PR17_FITS = {
    "barnes_hut": dict(knn=0.389, symmetrize=3.558, gradient_descent=10.54, kl=3.596582),
    "fft": dict(knn=0.390, symmetrize=4.173, gradient_descent=2.177, kl=3.762970),
}
FIT_PHASES = ("knn", "bsp", "symmetrize", "gradient_descent")


def phase_fit(x_np: np.ndarray, method: str, n_iter: int, exag_iters: int,
              kl_every: int, neighbor_method: str = "exact",
              neighbor_options: dict | None = None, label: str | None = None,
              trace: bool = False):
    """One fit through the estimator, every launch count reset before it
    and read after it; ``label`` names it in the log (default: ``method``).
    ``trace`` fits with ``trace=`` a Chrome-trace path under build/ and
    checks the spans (check_trace).  Returns (estimator, launches)."""
    from repro_torch.api import TSNE
    from repro_torch.kernels import ops

    stats = []
    name = label or method
    trace_path = BUILD / f"fit_trace_{name}.json" if trace else None
    if trace_path is not None:
        BUILD.mkdir(exist_ok=True)
    est = TSNE(method=method, neighbor_method=neighbor_method,
               neighbor_options=neighbor_options, perplexity=30,
               random_state=0, n_iter=n_iter, kl_every=kl_every, verbose=1,
               callbacks=[stats.append],
               backend_options=dict(knn_block_q=KNN_BLOCK_Q, knn_block_db=KNN_BLOCK_DB,
                                    exaggeration_iters=exag_iters,
                                    momentum_switch_iter=exag_iters),
               trace=None if trace_path is None else str(trace_path))
    # every attractive launch of the fit must carry the rows' real lengths
    with_len = []
    launch_attractive = ops.attractive_ell_cuda

    def attractive_spy(y, cols, vals, row_len=None):
        with_len.append(row_len is not None)
        return launch_attractive(y, cols, vals, row_len)

    ops.attractive_ell_cuda = attractive_spy
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        est.fit(x_np)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ops.attractive_ell_cuda = launch_attractive
    launches = dict(ops.LAUNCHES)
    log(f"{name} fit: {sum(with_len)} of {len(with_len)} attractive_ell launches "
        "with the rows' real lengths (p_len)")
    if not all(with_len):
        fail(f"the {name} fit launched attractive_ell without p_len")
    t = est.timings_
    log(f"{name} fit phases (s){', traced' if trace else ''}: " + json.dumps(
        {k: t[k] for k in FIT_PHASES}))
    log(f"{name} fit: wall {wall:.2f} s, {t['gradient_descent'] / est.n_iter_:.6f} s "
        f"per descent step over {est.n_iter_} steps")
    log(f"{name} fit KL checkpoints: " + json.dumps(
        [[int(i), float(v)] for i, v in est.kl_history_]))
    log(f"{name} fit max_traversal: {max(s.max_traversal for s in stats)}")
    log(f"{name} fit launches: {json.dumps(launches)}")
    emb = est.embedding_
    if emb.shape != (x_np.shape[0], 2) or not np.isfinite(emb).all():
        fail(f"{name}: embedding not finite or of wrong shape {emb.shape}")
    if not np.isfinite(est.kl_divergence_):
        fail(f"{name}: final KL is not finite")
    if trace_path is not None:
        check_trace(name, est, trace_path, exag_iters)
    return est, launches


def check_trace(name: str, est, path: Path, exag_iters: int) -> None:
    """A traced fit's spans: fit, knn, bsp, symmetrize and gradient_descent
    (the four phases children of fit), early_exaggeration, main_phase
    (when the fit ran past the exaggeration) and checkpoint; timings_ the
    spans' durations; the Chrome trace at ``path`` loadable with those
    events; fit.iterations = n_iter_.  Prints the timings beside PR 17's
    untraced fit of the same configuration."""
    tr = est.tracer_
    want = {"fit", *FIT_PHASES, "early_exaggeration", "checkpoint"}
    if est.n_iter_ > exag_iters:
        want.add("main_phase")
    missing = want - {s.name for s in tr.spans}
    if missing:
        fail(f"the traced {name} fit has no span {sorted(missing)}")
    fit = tr.last("fit")
    if any(tr.last(p).parent != fit.index for p in FIT_PHASES):
        fail(f"the traced {name} fit's phase spans are not children of fit")
    d = tr.durations()
    if any(est.timings_[p] != d[p] for p in FIT_PHASES):
        fail(f"the traced {name} fit's timings_ are not its spans' durations")
    with open(path) as f:
        events = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    if not want <= events:
        fail(f"the {name} fit's Chrome trace lacks {sorted(want - events)}")
    snap = est.metrics_.snapshot()
    if snap["fit.iterations"] != est.n_iter_:
        fail(f"the traced {name} fit counted {snap['fit.iterations']} iterations, ran "
             f"{est.n_iter_}")
    log(f"{name} fit traced: {len(tr.spans)} spans ({len(tr.find('checkpoint'))} "
        f"checkpoints) written to {path.name}; timings_ = span durations; "
        f"fit.iterations {snap['fit.iterations']}; fit span {d['fit']:.3f} s")
    ref = PR17_FITS.get(name)
    if ref is not None:
        log(f"{name} fit traced against PR 17's untraced (s): " + json.dumps(
            {p: [est.timings_[p], ref[p]] for p in ("knn", "symmetrize", "gradient_descent")})
            + f"; KL {est.kl_divergence_:.6f} against {ref['kl']}")


def check_launches(method: str, launches: dict, needed: tuple, per_step: tuple,
                   steps: int) -> None:
    """Each kernel of the path launched; the per-step kernels once a step."""
    missing = [k for k in needed if launches[k] <= 0]
    if missing:
        fail(f"the {method} fit never launched: {missing}")
    counts = {k: launches[k] for k in per_step}
    if any(v != steps for v in counts.values()):
        fail(f"the {method} fit ran {steps} steps but launched {counts}")


def phase_traverse(est) -> dict:
    """bh_traverse at the Barnes-Hut fit's embedding: checked bit for bit
    against the plain walk (check_traverse), then timed at the fit's
    settings (theta 0.5, depth 16, compressed tree): the kernels line's
    row, with the device times of its two kernels (pack, walk) apart and
    summed.  How far a warp's walks diverge: the union of its 32 walks
    (repulsive.warp_walk, a warp-shared schedule, which must give the
    kernel's bits) against its longest walk (the plain walk's steps).  Its
    bound counts the walks of this embedding: every visit's 15 fp32
    operations (the three an accepted node adds besides, and its
    reciprocal, not counted) at the fp32 rate, and each node's 40 bytes
    (start, end, skip, count, sum_y, side), the points and the outputs
    moved once; the packed records are the kernel's own scratch, not
    counted."""
    from repro_torch.core.repulsive import bh_repulsion_sorted, pack_nodes, warp_walk
    from repro_torch.kernels import ops
    y = torch.as_tensor(est.embedding_).cuda()
    check_traverse("fitted embedding", y)
    y_s, tree, summ = walk_inputs(y, compress=True)
    got = ops.bh_traverse(y_s, tree, summ, 0.5)
    n, visits, n_nodes = y.shape[0], int(got.steps.sum()), int(tree.n_nodes)
    sched, union = warp_walk(y_s, pack_nodes(tree, summ), summ.sum_y, tree.n_nodes, 0.5)
    if not all(torch.equal(a, b) for a, b in zip(sched, got)):
        fail("repulsive.warp_walk does not give bh_traverse's bits at the fitted embedding")
    steps = torch.zeros(union.shape[0] * 32, dtype=torch.int64, device=y.device)
    steps[:n] = got.steps
    longest = steps.view(-1, 32).amax(dim=1)
    walks = dict(warps=union.shape[0], union_mean=float(union.double().mean()),
                 longest_lane_mean=float(longest.double().mean()),
                 union_over_longest=float(union.sum()) / float(longest.sum()),
                 union_max=int(union.max()), longest_lane_max=int(longest.max()))
    log("bh_traverse warps at the fitted embedding: " + json.dumps(walks))
    pack_ms = kernel_ms(lambda: ops.bh_traverse(y_s, tree, summ, 0.5), "traverse_pack")
    walk_ms = kernel_ms(lambda: ops.bh_traverse(y_s, tree, summ, 0.5), "traverse_walk")
    return kernel_row(
        "bh_traverse", 0.0,
        cuda_ms(lambda: ops.bh_traverse(y_s, tree, summ, 0.5), inner=10),
        cuda_ms(lambda: bh_repulsion_sorted(y_s, tree, summ, 0.5), reps=3, inner=1),
        flops=15.0 * visits, nbytes=40.0 * n_nodes + 8.0 + (8.0 + 8.0 + 4.0 + 8.0) * n,
        device_ms=None if pack_ms is None or walk_ms is None else pack_ms + walk_ms,
        pack_device_ms=pack_ms, walk_device_ms=walk_ms,
        n_nodes=n_nodes, visits=visits, max_steps=int(got.steps.max()),
        mean_steps=visits / n, **walks)


def check_reproducible(est) -> None:
    """A second FFT descent from the fit's graph and initial embedding
    (core.tsne.descend, the loop run_tsne ran, with the fit's config and
    backend) must repeat the fit bit for bit: embedding and final KL."""
    from repro_torch.api import make_backend
    from repro_torch.core.tsne import descend, init_state
    config = est._build_config()
    n = est.embedding_.shape[0]
    t0 = time.perf_counter()
    state, kl, _, n_run = descend(init_state(n, config, "cuda"), est.neighbor_graph_, config,
                                  make_backend(config.method, config, n),
                                  config.resolve_lr(n), kl_every=est.kl_every)
    y = state.y.cpu().numpy()
    same = bool(np.array_equal(y, est.embedding_)) and kl == est.kl_divergence_
    log(f"{config.method} second descent, {n_run} steps in {time.perf_counter() - t0:.2f} s: "
        f"KL {kl} (fit {est.kl_divergence_}), max |d embedding| "
        f"{float(np.abs(y - est.embedding_).max()):.3e}, bit-identical {same}")
    if not same or n_run != est.n_iter_:
        fail(f"a second {config.method} descent from the same graph and initial embedding "
             "does not repeat the fit bit for bit")


def kernel_events(fn) -> dict[str, list[float]]:
    """Kernel name -> the durations (us) of its launches in one call of
    ``fn``, from a torch.profiler trace (the kernel events themselves: CPU
    ops' device time would count each kernel twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            events.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return events


def device_busy(fn) -> tuple[float, dict]:
    """Seconds of CUDA kernel time in one call of ``fn`` (the summed
    durations of its kernel events), and the same by kernel name (us)."""
    by_kernel = {k: sum(v) for k, v in kernel_events(fn).items()}
    return sum(by_kernel.values()) * 1e-6, by_kernel


def add_busy_share(out: dict, step, inner: int) -> dict:
    """out gains step_s (CUDA-event time of ``inner`` back-to-back calls of
    ``step`` with no sync between them, as the fit runs its steps, over
    ``inner``; median of 3), device_busy_s (kernel time of one profiled
    ``step``) and device_idle_share = 1 - busy / step_s.  Returns the
    profiled step's kernel time by kernel name (us)."""
    out["step_s"] = cuda_ms(step, reps=3, inner=inner) * 1e-3
    busy_s, by_kernel = device_busy(step)
    if busy_s > 0:
        if busy_s > out["step_s"]:
            fail(f"device busy {busy_s:.6f} s exceeds the step's {out['step_s']:.6f} s")
        out["device_busy_s"] = busy_s
        out["device_idle_share"] = 1.0 - busy_s / out["step_s"]
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        log("step device time by kernel (ms): " + json.dumps(
            {k[:70]: v * 1e-3 for k, v in top}))
    else:
        log("step device time: not measured (the profiler recorded no kernel)")
    return by_kernel


def check_same_step(what: str, res, ref, f_rep) -> None:
    """The breakdown's stage-by-stage GradResult ``res`` against the
    backend's own ``ref``: a breakdown that drifted from the step it times
    fails here.  The two calls run the same kernels on the same inputs;
    they can differ only where an operation sums in a run-dependent order.
    At a fitted embedding the gradient is a small difference of the
    attractive and repulsive terms, so its difference is measured against
    the repulsive term 4 F_rep / Z.  The FFT force y * phi0 - phi1 is
    itself a cancelling difference, which turns ~1e-7 of reordering noise
    in the lattice into ~5e-5 of the term; a drifted step differs by the
    order of the term.  So: below 1e-3, and Z to 1e-5."""
    term = float(torch.linalg.norm(4.0 * f_rep / res.z))
    rel = float(torch.linalg.norm(res.grad - ref.grad)) / term
    z_rel = abs(float(res.z) - float(ref.z)) / float(ref.z)
    log(f"{what} breakdown vs backend.gradient: |d grad| / |4 F_rep / Z| = {rel:.3e}, "
        f"Z relative {z_rel:.3e}, bit-identical {torch.equal(res.grad, ref.grad)}")
    if not (rel <= 1e-3 and z_rel <= 1e-5):
        fail(f"{what} breakdown's step differs from the backend's")


class Laps:
    """Seconds of consecutive stages, the device synchronised at each mark."""

    def __init__(self):
        self.t: dict[str, float] = {}
        torch.cuda.synchronize()
        self.mark = time.perf_counter()

    def __call__(self, name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.t[name] = now - self.mark
        self.mark = now


def median_laps(runs: list[dict]) -> dict:
    out = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    out["total"] = sum(out.values())
    return out


def phase_breakdown(est) -> dict:
    """Seconds of each stage of one Barnes-Hut step at the fitted embedding
    (device synchronised around each stage; median of 3 steps)."""
    from repro_torch.api import make_backend
    from repro_torch.core import attractive, morton, quadtree
    from repro_torch.core.summarize import summarize
    from repro_torch.core.tsne import (
        TsneConfig, TsneState, combine_forces, gd_update, tsne_step,
    )
    from repro_torch.kernels import ops

    g = est.neighbor_graph_
    y = torch.as_tensor(est.embedding_).cuda()
    state = TsneState(y=y, velocity=torch.zeros_like(y), gains=torch.ones_like(y),
                      iteration=0)
    backend = make_backend("barnes_hut", TsneConfig(), y.shape[0])   # the fit's
    runs, max_traversal = [], 0
    for _ in range(3):
        lap = Laps()
        cent, r_span = morton.span_radius(y)
        codes = ops.morton_encode(y, cent, r_span, depth=backend.depth)
        lap("morton_encode")
        codes_s, y_s, perm = quadtree.sort_points_by_code(y, codes)
        lap("sort")
        tree = quadtree.build_quadtree(codes_s, depth=backend.depth,
                                       compress=backend.compress_tree)
        lap("build_quadtree")
        summ = summarize(tree, y_s, r_span)
        lap("summarize")
        rep = ops.bh_traverse(y_s, tree, summ, backend.theta)
        lap("traversal")
        f_rep = torch.empty_like(y)
        f_rep[perm] = rep.force
        f_attr, kl_attr = attractive.ell_forces(backend.attractive_impl)(
            y, g.p_cols, g.p_vals, g.p_len)
        lap("attractive")
        res = combine_forces(f_attr, kl_attr, f_rep, rep.z_per_point.sum(), 1.0,
                             g.p_logp, torch.max(rep.steps))
        gd_update(state, res.grad, est.learning_rate_, 0.8, 0.01)
        lap("combine_and_update")
        max_traversal = int(res.max_traversal)
        runs.append(lap.t)
    check_same_step("bh", res, backend.gradient(y, g, 1.0), f_rep)
    out = median_laps(runs)
    out["max_traversal"] = max_traversal
    out["traversal_share"] = out["traversal"] / out["total"]
    # the card's busy time over one whole descent step (gradient + update)
    add_busy_share(out, lambda: tsne_step(state, g, 1.0, 0.8, backend=backend,
                                          lr=est.learning_rate_, min_gain=0.01), inner=3)
    log("bh step breakdown at the fitted embedding (s): " + json.dumps(out))
    return out


def phase_fft_breakdown(est) -> dict:
    """Seconds of each stage of one FFT step at the fitted embedding
    (device synchronised around each stage; median of 10 steps)."""
    from repro_torch.api import make_backend
    from repro_torch.core import attractive
    from repro_torch.core import fft_repulsion as fr
    from repro_torch.core.tsne import (
        TsneConfig, TsneState, combine_forces, gd_update, tsne_step,
    )
    from repro_torch.kernels import ops

    g = est.neighbor_graph_
    y = torch.as_tensor(est.embedding_).cuda()
    state = TsneState(y=y, velocity=torch.zeros_like(y), gains=torch.ones_like(y),
                      iteration=0)
    backend = make_backend("fft", TsneConfig(), y.shape[0])   # the fit's: 48 boxes
    runs = []
    # fft_repulsion's stages, each through the function fft_repulsion calls
    for _ in range(10):
        lap = Laps()
        base, wx, wy, h = fr.interp_coords(y, backend.n_boxes)
        charges = fr.point_charges(y)
        lap("coords")
        grid = ops.fft_spread(base, wx, wy, charges, fr.lattice_nodes(backend.n_boxes))
        lap("spread")
        pot = fr.convolve(grid, h)
        lap("convolution")
        phi = ops.fft_gather(pot, base, wx, wy)
        lap("gather")
        f_attr, kl_attr = attractive.ell_forces(backend.attractive_impl)(
            y, g.p_cols, g.p_vals, g.p_len)
        lap("attractive")
        f_rep, z = fr.forces_from_potentials(y, phi)
        res = combine_forces(f_attr, kl_attr, f_rep, z, 1.0, g.p_logp)
        gd_update(state, res.grad, est.learning_rate_, 0.8, 0.01)
        lap("combine_and_update")
        runs.append(lap.t)
    check_same_step("fft", res, backend.gradient(y, g, 1.0), f_rep)
    out = median_laps(runs)
    nodes = fr.lattice_nodes(backend.n_boxes)
    out["spread_plan"] = list(ops.spread_plan(y.shape[0], nodes))
    out["spread_device_ms"] = kernel_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes),
                                        "spread")
    out["gather_device_ms"] = kernel_ms(lambda: ops.fft_gather(pot, base, wx, wy), "gather")
    # the card's busy time over one whole descent step (gradient + update)
    by_kernel = add_busy_share(out, lambda: tsne_step(state, g, 1.0, 0.8, backend=backend,
                                                      lr=est.learning_rate_, min_gain=0.01),
                               inner=20)
    # the spread and gather kernels' device time in the profiled step,
    # beside kernel_ms's
    for name in ("spread", "gather"):
        us = [v for k, v in by_kernel.items() if f"{name}_kernel" in k]
        out[f"{name}_step_device_ms"] = sum(us) * 1e-3 if us else None
    log("fft step breakdown at the fitted embedding (s): " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The approximate neighbours and the out-of-sample transform
# ---------------------------------------------------------------------------

# The approximate fit's forest.  The defaults (8 trees, leaves of >= 64
# points: 118 at 60 000 rows) route the held-out rows to 59% of their 90
# exact neighbours (the port and the JAX package alike; PERF.md), below
# the reference's 0.9 query bar; 32 trees of >= 128 points (235) reach
# 0.99.
APPROX_FOREST = {"n_trees": 32, "leaf_size": 128}
RECALL_ROWS = 4096          # sampled rows whose exact neighbours are computed
TRAIN_ROWS = 60_000         # MNIST's own train split; the other 10 000 are new points


def synced_seconds(fn):
    """(fn(), its seconds, the card synchronised at both ends)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_graph(what: str, x: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                rows: torch.Tensor, ref_idx: torch.Tensor) -> float:
    """Every row of the graph valid (in range, no self, no duplicate); on
    the sampled ``rows`` the reported d2 the true squared distance (fp64),
    within pairwise_tol of the norms.  Returns the recall on ``rows``
    against their exact neighbours ``ref_idx``."""
    from repro_torch.neighbors import recall_at_k
    n, k = idx.shape
    i64 = idx.long()
    if not bool(((i64 >= 0) & (i64 < n)).all()):
        fail(f"{what}: a neighbour index out of range")
    if bool((i64 == torch.arange(n, device=x.device)[:, None]).any()):
        fail(f"{what}: a row lists itself")
    srt = torch.sort(i64, dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        fail(f"{what}: a row lists a neighbour twice")
    xs, nb = x[rows].double(), x[i64[rows]].double()
    true = torch.sum((xs[:, None, :] - nb) ** 2, -1)
    sqn = torch.sum(x.double() ** 2, 1)
    tol = pairwise_tol(true, sqn[rows][:, None], sqn[i64[rows]])
    share = float(((d2[rows].double() - true).abs() / tol).max())
    recall = recall_at_k(ref_idx.cpu().numpy(), idx[rows].cpu().numpy())
    log(f"{what}: {n} rows x {k} valid (in range, no self, no duplicate); d2 on "
        f"{rows.shape[0]} sampled rows {share:.3f} of the tolerance from the true distance "
        f"at most; recall on them {recall:.6f}")
    if share > 1.0:
        fail(f"{what}: reported distances are not the true ones")
    return recall


def phase_approx_knn(k: int) -> dict:
    """rp_forest (default options) and nn_descent on all of mouse_1p3m
    (1 291 337 x 20) on the card: seconds, validity, recall on sampled
    rows.  Then at N = 20 000 the card's rp_forest graph against the CPU's
    (the same draws)."""
    from repro_torch.core.knn import knn
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import ops
    from repro_torch.neighbors import NNDescentNeighbors, RPForestNeighbors, recall_at_k

    x_np, _ = make_dataset("mouse_1p3m")
    x = torch.as_tensor(x_np).cuda()
    n = x.shape[0]
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(17))[:RECALL_ROWS].cuda()
    ref_idx, _ = knn_rows(x, rows, k, ops.pairwise_sq_dists)
    out = {}
    for backend in (RPForestNeighbors(), NNDescentNeighbors()):
        torch.cuda.reset_peak_memory_stats()
        (idx, d2), secs = synced_seconds(lambda: backend.neighbors(x, k))
        recall = check_graph(f"{backend.name} on mouse_1p3m [{n}, {x.shape[1]}], K = {k}",
                             x, idx, d2, rows, ref_idx)
        out[backend.name] = dict(seconds=secs, recall=recall,
                                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"{backend.name} on mouse_1p3m: {secs:.3f} s, recall {recall:.6f} on "
            f"{RECALL_ROWS} rows, peak {out[backend.name]['peak_gib']:.2f} GiB ({backend})")
        del idx, d2

    # the card's graph against the CPU's at N = 20 000: the same draws
    # (a CPU generator), so the two graphs differ only where float order
    # swaps near-tied neighbours
    m = 20_000
    xs = x[:m].contiguous()
    card, _ = RPForestNeighbors().neighbors(xs, k)
    cpu, _ = RPForestNeighbors().neighbors(xs.cpu(), k)
    exact, _ = knn(xs, k, KNN_BLOCK_Q, KNN_BLOCK_DB)
    exact = exact.cpu().numpy()
    same = recall_at_k(cpu.numpy(), card.cpu().numpy())
    r_card, r_cpu = recall_at_k(exact, card.cpu().numpy()), recall_at_k(exact, cpu.numpy())
    log(f"rp_forest at N = {m}: card's graph against the CPU's {same:.6f} (>= 0.99); "
        f"recall against exact: card {r_card:.6f}, cpu {r_cpu:.6f} (within 0.01)")
    if same < 0.99 or abs(r_card - r_cpu) > 0.01:
        fail("rp_forest on the card disagrees with the CPU's graph of the same draws")
    out["n20000"] = dict(card_vs_cpu=same, recall_card=r_card, recall_cpu=r_cpu)
    return out


def phase_approx_fit(x_np: np.ndarray, n_iter: int, exag_iters: int, kl_every: int):
    """The Barnes-Hut fit on an rp_forest graph of MNIST's train split, and
    the same fit on the exact graph: KLs within 0.15 (the reference's bar,
    tests/test_neighbors.py::test_bh_kl_on_approximate_graph).  The
    approximate fit must launch no pairwise tile, bsp, and morton,
    attractive and bh_traverse once a step.  Returns (approximate fit,
    exact fit)."""
    train = x_np[:TRAIN_ROWS]
    steps = (n_iter, exag_iters, kl_every)
    est_rp, launches = phase_fit(train, "barnes_hut", *steps, neighbor_method="rp_forest",
                                 neighbor_options=APPROX_FOREST, label="rp_forest bh")
    if launches["pairwise_sq_dists"] != 0:
        fail(f"the rp_forest fit launched {launches['pairwise_sq_dists']} pairwise tiles")
    check_launches("rp_forest bh", launches, ("bsp_search",),
                   ("morton_encode", "attractive_ell", "bh_traverse"), est_rp.n_iter_)
    est_ex, _ = phase_fit(train, "barnes_hut", *steps, label="exact-graph bh (train split)")
    gap = abs(est_rp.kl_divergence_ - est_ex.kl_divergence_)
    log(f"approx fit: KL rp_forest {est_rp.kl_divergence_:.6f} (earlier runs: 3.479328), exact "
        f"graph {est_ex.kl_divergence_:.6f}, gap {gap:.6f} (< 0.15); knn "
        f"{est_rp.timings_['knn']:.3f} s "
        f"against {est_ex.timings_['knn']:.3f} s")
    if not gap < 0.15:
        fail("the rp_forest fit's KL is not within 0.15 of the exact-graph fit's")
    return est_rp, est_ex


def knn_labels(train_t: torch.Tensor, test_t: torch.Tensor, train_labels: np.ndarray,
               chunk: int = 1024) -> np.ndarray:
    """The 5-NN vote of each test row among the train rows (squared
    euclidean distance; ties of the vote to the smaller label, as
    np.bincount(...).argmax())."""
    idx = []
    for r0 in range(0, test_t.shape[0], chunk):
        d2 = torch.cdist(test_t[r0:r0 + chunk], train_t)
        idx.append(torch.topk(d2, 5, dim=1, largest=False).indices.cpu().numpy())
    votes = train_labels[np.concatenate(idx)]
    return np.array([np.bincount(v).argmax() for v in votes])


def query_rows(index, q: torch.Tensor, k: int, chunk: int = 128) -> np.ndarray:
    """index.query in chunks of ``chunk`` rows (a transform batch's)."""
    return np.concatenate([index.query(q[r0:r0 + chunk], k)[0].cpu().numpy()
                           for r0 in range(0, q.shape[0], chunk)])


class Replay:
    """A query index that answers with given (idx, d2), chunk after chunk,
    in the order transform_batch asks."""

    def __init__(self, idx: torch.Tensor, d2: torch.Tensor):
        self.idx, self.d2, self.at = idx, d2, 0

    def query(self, q: torch.Tensor, k: int):
        rows = slice(self.at, self.at + q.shape[0])
        self.at += q.shape[0]
        return self.idx[rows].to(q.device), self.d2[rows].to(q.device)


def phase_transform(est, x_np: np.ndarray, labels: np.ndarray) -> dict:
    """The held-out 10 000 rows through the rp_forest fit's query_index_
    and through an exact index over the train split: rows/s, the forest
    query's recall (>= 0.9), label accuracy against the input-space
    baseline, 256 rows on the card against the CPU, and save/load."""
    import tempfile

    from repro_torch.api import TSNE
    from repro_torch.embed.transform import TransformConfig, prepare_batch, transform_batch
    from repro_torch.kernels import ops
    from repro_torch.neighbors import (
        ExactNeighbors, RPForestNeighbors, build_query_index, recall_at_k,
    )

    cfg = TransformConfig()
    train_t = torch.as_tensor(x_np[:TRAIN_ROWS]).cuda()
    test_np = x_np[TRAIN_ROWS:]
    test_t = torch.as_tensor(test_np).cuda()
    y_ref = torch.as_tensor(est.embedding_).cuda()
    k, perp = est.query_k_, float(est.perplexity)
    out = {"batch_size": cfg.batch_size, "rows": test_np.shape[0], "k": k}

    forest, out["forest_build_s"] = synced_seconds(lambda: est.query_index_)
    exact_index = build_query_index(ExactNeighbors(), train_t)
    runs = {}
    for name, index in (("forest", forest), ("exact", exact_index)):
        transform_batch(test_t[:cfg.batch_size], index, y_ref, k=k, perplexity=perp,
                        config=cfg)                                 # warm-up batch
        ops.reset_launch_counts()
        (y, stats), secs = synced_seconds(lambda: transform_batch(
            test_t, index, y_ref, k=k, perplexity=perp, config=cfg))
        launches = dict(ops.LAUNCHES)
        runs[name] = y
        out[name] = dict(seconds=secs, rows_per_s=test_np.shape[0] / secs,
                         steps_mean=float(stats.n_steps.mean()),
                         launches={kk: v for kk, v in launches.items() if v})
        log(f"transform via the {name} index: {test_np.shape[0]} rows in batches of "
            f"{cfg.batch_size}: {secs:.3f} s, {out[name]['rows_per_s']:.1f} rows/s, "
            f"{out[name]['steps_mean']:.1f} steps a row on average; launches "
            f"{json.dumps(out[name]['launches'])}")
        if not np.isfinite(y).all():
            fail(f"the {name} transform is not finite")
    if out["exact"]["launches"].get("pairwise_sq_dists", 0) <= 0 or \
            out["exact"]["launches"].get("bsp_search", 0) <= 0 or \
            out["forest"]["launches"].get("bsp_search", 0) <= 0:
        fail("the transform did not launch pairwise_sq_dists (exact index) and bsp_search")

    exact_idx = query_rows(exact_index, test_t, k)
    out["forest_recall"] = recall_at_k(exact_idx, query_rows(forest, test_t, k))
    default = RPForestNeighbors(seed=0).build_index(train_t)
    out["default_forest_recall"] = recall_at_k(exact_idx, query_rows(default, test_t, k))
    log(f"forest query recall at k = {k} on {test_np.shape[0]} held-out rows: "
        f"{out['forest_recall']:.6f} (>= 0.9) with {APPROX_FOREST} ({tuple(forest.leaves.shape)}"
        f" leaves); the default forest ({tuple(default.leaves.shape)}): "
        f"{out['default_forest_recall']:.6f}")
    if out["forest_recall"] < 0.9:
        fail("the forest query's recall is below 0.9")

    train_labels, test_labels = labels[:TRAIN_ROWS], labels[TRAIN_ROWS:]
    base = float((knn_labels(train_t, test_t, train_labels) == test_labels).mean())
    for name, y in runs.items():
        acc = float((knn_labels(y_ref, torch.as_tensor(y).cuda(), train_labels)
                     == test_labels).mean())
        out[f"label_acc_{name}"] = acc
        log(f"5-NN label accuracy, {name} transform: embedding {acc:.4f}, input space "
            f"{base:.4f} (>= baseline - 0.05)")
        if acc < base - 0.05:
            fail(f"the {name} transform's points do not land in their own clusters")
    out["label_acc_input"] = base

    # 256 rows on the card against the CPU through the same exact index,
    # stage by stage.  (1) The query: the card's pairwise tile (3xTF32) is
    # not bit-identical to the CPU's fp32, so a row's neighbour set may
    # differ (<= 1% of rows) and the distances may differ within the
    # pairwise tolerance.  (2) prepare_batch from the same query answers
    # (the CPU's, replayed on the card): p within the bsp kernel's
    # tolerance on every row, y0 within 1e-4 of the fitted embedding's
    # span.  (3) The transformed points: median |dy| <= 1e-5 x span and
    # >= 98% of rows within 1e-3 x span.  A per-row bound on the output
    # does not hold: rows that stop at the step cap on a ridge between two
    # basins move far under last-bit differences (one moved 5.2 units on a
    # span of 190.8, and 0.034 under 1e-6 relative noise in p on the CPU
    # alone; PERF.md).
    m = 256
    cpu_index = build_query_index(ExactNeighbors(), train_t.cpu())
    q = test_t[:m]
    (i_card, d_card), (i_cpu, d_cpu) = exact_index.query(q, k), cpu_index.query(q.cpu(), k)
    o_card, o_cpu = torch.sort(i_card.cpu(), 1), torch.sort(i_cpu, 1)
    same_set = (o_card.values == o_cpu.values).all(1)
    sqn = torch.sum(train_t.cpu() ** 2, 1)
    d_c = torch.gather(d_card.cpu(), 1, o_card.indices)[same_set]
    d_p = torch.gather(d_cpu, 1, o_cpu.indices)[same_set]
    tol = pairwise_tol(d_p, torch.sum(q.cpu() ** 2, 1)[same_set][:, None],
                       sqn[o_cpu.values[same_set].long()])
    d_share = float(((d_c - d_p).abs() / tol).max())
    span = float(np.ptp(est.embedding_))
    p_card, _, y0_card = prepare_batch(q, Replay(i_cpu, d_cpu), y_ref, k, perp)
    p_cpu, _, y0_cpu = prepare_batch(q.cpu(), cpu_index, y_ref.cpu(), k, perp)
    p_err = float((p_card.cpu() - p_cpu).abs().max())
    y0_err = float((y0_card.cpu() - y0_cpu).abs().max())
    y_cpu, _ = transform_batch(q.cpu(), cpu_index, y_ref.cpu(), k=k, perplexity=perp, config=cfg)
    y_card, _ = transform_batch(q, exact_index, y_ref, k=k, perplexity=perp, config=cfg)
    dy = np.abs(y_card - y_cpu).max(1)
    out["card_vs_cpu"] = dict(
        other_sets=int((~same_set).sum()), d2_share=d_share, p_max_abs_err=p_err,
        y0_max_abs_err=y0_err, span=span, median_dy=float(np.median(dy)),
        max_dy=float(dy.max()), rows_over=int((dy > 1e-3 * span).sum()))
    log(f"transform card vs cpu, {m} rows, exact index: {int((~same_set).sum())} rows with "
        f"another neighbour set (<= 1%), distances {d_share:.3f} of the pairwise tolerance at "
        f"most; from the same query answers p max |d| {p_err:.3e} (rtol 1e-5, atol 1e-7), "
        f"y0 max |d| {y0_err:.3e} (<= 1e-4 x span {span:.3f}); transformed points median "
        f"|dy| {np.median(dy):.3e} (<= 1e-5 x span), max {dy.max():.3e}, "
        f"{int((dy > 1e-3 * span).sum())} rows over 1e-3 x span (<= 2%)")
    if (~same_set).float().mean() > 0.01 or d_share > 1.0 or \
            not torch.allclose(p_card.cpu(), p_cpu, rtol=1e-5, atol=1e-7) or \
            y0_err > 1e-4 * span or np.median(dy) > 1e-5 * span or \
            (dy > 1e-3 * span).mean() > 0.02:
        fail("the transform on the card disagrees with the CPU's")

    # save, then load: the loaded model serves the same transform (its
    # forest rebuilt from the same draws); the reference's round-trip bar
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "mnist_rp.npz"
        est.save(path)
        loaded = TSNE.load(path)
        again = loaded.transform(test_np[:m])
    first = est.transform(test_np[:m])
    err = float(np.abs(again - first).max())
    log(f"save/load: the loaded model's transform of {m} rows, max |dy| {err:.3e} "
        "(atol 1e-5)")
    if not np.allclose(again, first, atol=1e-5):
        fail("a saved and loaded model does not serve the same transform")
    log("transform summary: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The embedding service
# ---------------------------------------------------------------------------

SERVICE_ROWS = 2048         # held-out rows submitted to each of the two models
SERVICE_CPU_ROWS = 256      # requests replayed on a CPU service


def service_bars(what: str, y: np.ndarray, y_ref: np.ndarray, span: float) -> dict:
    """Phase 11's distribution bars between two placements of the same
    rows: median |dy| <= 1e-5 x span, >= 98% of rows within 1e-3 x span
    (rows that stop at the step cap on a ridge between two basins move far
    under last-bit differences, so no per-row bound holds; PERF.md)."""
    dy = np.abs(y - y_ref).max(1)
    out = dict(median_dy=float(np.median(dy)), max_dy=float(dy.max()),
               rows_over=int((dy > 1e-3 * span).sum()), rows=int(dy.shape[0]), span=span)
    log(f"service {what}: {dy.shape[0]} rows, median |dy| {out['median_dy']:.3e} "
        f"(<= 1e-5 x span {span:.3f}), max {out['max_dy']:.3e}, {out['rows_over']} rows "
        "over 1e-3 x span (<= 2%)")
    if not (out["median_dy"] <= 1e-5 * span and (dy > 1e-3 * span).mean() <= 0.02):
        fail(f"the service's placements disagree ({what})")
    return out


def run_service(service, models: dict, rows: np.ndarray) -> tuple[list, float]:
    """Submit every row to each model in turn (request ids 0, 1, ... in that
    order) and drain with run(): (requests in id order, seconds)."""
    from repro_torch.embed import TransformRequest
    reqs = [TransformRequest(rid=len(models) * i + j, dataset=name, x=xi)
            for i, xi in enumerate(rows) for j, name in enumerate(models)]
    t0 = time.perf_counter()
    for r in reqs:
        service.submit(r)
    done = service.run()
    secs = time.perf_counter() - t0
    if sorted(r.rid for r in done) != list(range(len(reqs))):
        fail(f"the service completed {len(done)} of {len(reqs)} requests")
    return reqs, secs


def phase_service(est_forest, est_exact, x_np: np.ndarray) -> dict:
    """EmbeddingService(slots=64, max_k=96) on the card over phase 10's two
    fits; see the module docstring (phase 12)."""
    import tempfile

    from repro_torch import obs
    from repro_torch.api import TSNE
    from repro_torch.convert import forest_index_from_numpy
    from repro_torch.embed import EmbeddingService
    from repro_torch.embed.transform import RETRACE_PROBE
    from repro_torch.kernels import ops

    models = {"mnist_forest": est_forest, "mnist_exact": est_exact}
    rows = x_np[TRAIN_ROWS:TRAIN_ROWS + SERVICE_ROWS]
    for est in models.values():
        est.query_index_             # built before the run, not on a request's clock
    tracer = obs.Tracer()
    service = EmbeddingService(slots=64, max_k=96, tracer=tracer)
    for name, est in models.items():
        service.add_model(name, est)
    # pairwise launches by each model's admissions
    pairwise_by = dict.fromkeys(models, 0)
    admit = service._admit

    def counted_admit(slot, req):
        before = ops.LAUNCHES["pairwise_sq_dists"]
        admit(slot, req)
        pairwise_by[req.dataset] += ops.LAUNCHES["pairwise_sq_dists"] - before

    service._admit = counted_admit
    probe_before = RETRACE_PROBE.count
    ops.reset_launch_counts()
    reqs, secs = run_service(service, models, rows)
    launches = dict(ops.LAUNCHES)
    n_req = len(reqs)
    s = service.stats()
    spans = tracer.durations()
    index = est_exact.query_index_
    tiles = -(-TRAIN_ROWS // index.block_db) * -(-1 // index.block_q)
    out = dict(requests=n_req, seconds=secs, requests_per_s=n_req / secs,
               latency_s_p50=s["latency_s_p50"], latency_s_p95=s["latency_s_p95"],
               latency_s_p99=s["latency_s_p99"], latency_s_max=s["latency_s_max"],
               steps_mean=s["steps_mean"], steps_max=s["steps_max"], ticks=s["ticks"],
               admit_s=spans.get("service.admit", 0.0), tick_s=spans.get("service.tick", 0.0),
               launches={k: v for k, v in launches.items() if v},
               pairwise_by_model=pairwise_by, tiles_per_exact_admission=tiles,
               transform_step_shapes_added=RETRACE_PROBE.count - probe_before)
    log(f"service: {n_req} requests ({SERVICE_ROWS} rows x 2 models, 64 slots, max_k 96) in "
        f"{secs:.3f} s: {out['requests_per_s']:.1f} requests/s; latency p50/p95/p99 "
        f"{s['latency_s_p50']:.4f} / {s['latency_s_p95']:.4f} / {s['latency_s_p99']:.4f} s "
        f"(max {s['latency_s_max']:.4f}; every request queued at once); steps mean "
        f"{s['steps_mean']:.2f} (max {s['steps_max']}); {s['ticks']} ticks")
    admit_by = {name: sum(sp.duration_s for sp in tracer.find("service.admit")
                          if sp.attrs["dataset"] == name) for name in models}
    out["admit_s_by_model"] = admit_by
    log(f"service spans: service.admit {out['admit_s']:.3f} s over "
        f"{len(tracer.find('service.admit'))} admissions "
        f"({out['admit_s'] / n_req * 1e3:.3f} ms each; by model "
        + ", ".join(f"{k} {v:.3f} s, {v / SERVICE_ROWS * 1e3:.3f} ms each"
                    for k, v in admit_by.items())
        + f"), service.tick {out['tick_s']:.3f} s over {s['ticks']} ticks "
        f"({out['tick_s'] / s['ticks'] * 1e3:.3f} ms each); "
        f"{secs - out['admit_s'] - out['tick_s']:.3f} s outside both")
    log(f"service launches: {json.dumps(out['launches'])}; pairwise by model "
        f"{json.dumps(pairwise_by)} ({tiles} tiles an exact admission, blocks "
        f"{index.block_q} x {index.block_db}); transform_step shapes added "
        f"{out['transform_step_shapes_added']}")
    if not all(r.done and r.y is not None and np.isfinite(r.y).all() for r in reqs):
        fail("a service request finished without a finite result")
    m = service.metrics
    if s["completed"] != n_req or s["slot_occupancy_max"] != 64 or \
            s["queue_depth_max"] < 1 or m.gauge("service.queue_depth").value != 0 or \
            m.gauge("service.slot_occupancy").value != 0:
        fail(f"the service's telemetry is off: {json.dumps(s)}")
    if out["transform_step_shapes_added"] != 1:
        fail(f"the service added {out['transform_step_shapes_added']} transform_step "
             "shapes, not one ([64, 96])")
    if launches["bsp_search"] != n_req or pairwise_by["mnist_forest"] != 0 or \
            pairwise_by["mnist_exact"] != tiles * SERVICE_ROWS:
        fail(f"the admissions launched bsp {launches['bsp_search']} times (want {n_req}) "
             f"and pairwise {json.dumps(pairwise_by)} (want 0 and {tiles * SERVICE_ROWS})")

    # each model's placements against its batch transform of the same rows
    t0 = time.perf_counter()
    for j, (name, est) in enumerate(models.items()):
        y_srv = np.stack([r.y for r in reqs[j::len(models)]])
        out[f"vs_transform_{name}"] = service_bars(
            f"{name} against TSNE.transform", y_srv, est.transform(rows),
            float(np.ptp(est.embedding_)))

    log(f"service: the two batch transforms and their comparison took "
        f"{time.perf_counter() - t0:.1f} s")

    # the first SERVICE_CPU_ROWS requests on a CPU service: the same models
    # saved and loaded on the CPU, the forest model given the card's forest
    t0 = time.perf_counter()
    cpu_models = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, est in models.items():
            est.save(Path(tmp) / f"{name}.npz")
            cpu_models[name] = TSNE.load(Path(tmp) / f"{name}.npz", device="cpu")
    f = est_forest.query_index_
    cpu_models["mnist_forest"]._query_index = forest_index_from_numpy(
        f.x_ref.cpu().numpy(), f.leaves.cpu().numpy(), f.dirs.cpu().numpy(),
        [t.cpu().numpy() for t in f.thrs], device="cpu")
    cpu_service = EmbeddingService(slots=64, max_k=96, device="cpu")
    for name, est in cpu_models.items():
        cpu_service.add_model(name, est)
    cpu_reqs, cpu_secs = run_service(cpu_service, cpu_models,
                                     rows[:SERVICE_CPU_ROWS // len(models)])
    log(f"service on the CPU: {len(cpu_reqs)} requests in {cpu_secs:.3f} s (save, load "
        f"and run {time.perf_counter() - t0:.1f} s)")
    for j, (name, est) in enumerate(models.items()):
        out[f"card_vs_cpu_{name}"] = service_bars(
            f"{name}, card against CPU",
            np.stack([r.y for r in reqs[:SERVICE_CPU_ROWS][j::len(models)]]),
            np.stack([r.y for r in cpu_reqs[j::len(models)]]), float(np.ptp(est.embedding_)))

    # the smoke entry point, traced, as a user runs it
    trace = BUILD / "service_trace.json"
    BUILD.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.embed.service", "--smoke", "--trace", str(trace)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), capture_output=True,
        text=True, timeout=600)
    log(f"service smoke entry point: rc {proc.returncode} in {time.perf_counter() - t0:.1f} s: "
        f"{proc.stdout.strip()}")
    if proc.returncode != 0:
        fail(f"python -m repro_torch.embed.service --smoke failed:\n{proc.stderr[-4000:]}")
    with open(trace) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"}
    if not {"fit", "service.admit", "service.tick"} <= names:
        fail(f"the smoke's trace lacks service spans: {sorted(names)}")
    log("service summary: " + json.dumps(out))
    return out


BH_KERNELS = ("pairwise_sq_dists", "bsp_search", "morton_encode", "attractive_ell",
              "bh_traverse")
FFT_KERNELS = ("pairwise_sq_dists", "bsp_search", "attractive_ell", "fft_spread",
               "fft_gather")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-iter", type=int, default=1000,
                    help="descent steps of both fits (default: 1000, the estimator's)")
    ap.add_argument("--exaggeration-iters", type=int, default=250,
                    help="exaggerated steps of both fits (default: 250, the estimator's)")
    ap.add_argument("--kl-every", type=int, default=50)
    args = ap.parse_args()

    phase_device()
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import ops
    phase_build()

    x_np, labels = make_dataset("mnist")
    x = torch.as_tensor(x_np).cuda()
    perplexity = 30.0
    rows = phase_kernels(x, int(3 * perplexity), perplexity)
    phase_gradient(x)

    fit_steps = (args.n_iter, args.exaggeration_iters, args.kl_every)
    est, bh_launches = phase_fit(x_np, "barnes_hut", *fit_steps, trace=True)
    check_launches("barnes_hut", bh_launches, BH_KERNELS,
                   ("morton_encode", "attractive_ell", "bh_traverse"), est.n_iter_)
    rows.append(phase_traverse(est))
    phase_breakdown(est)
    est, fft_launches = phase_fit(x_np, "fft", *fit_steps, trace=True)
    check_launches("fft", fft_launches, FFT_KERNELS,
                   ("attractive_ell", "fft_spread", "fft_gather"), est.n_iter_)
    check_reproducible(est)
    fft_breakdown = phase_fft_breakdown(est)

    phase_approx_knn(int(3 * perplexity))
    est_rp, est_ex = phase_approx_fit(x_np, *fit_steps)
    phase_transform(est_rp, x_np, labels)
    service = phase_service(est_rp, est_ex, x_np)

    unlaunched = [k for k in ops.LAUNCHES if bh_launches[k] + fft_launches[k] == 0]
    if unlaunched:
        fail(f"neither fit launched {unlaunched}")
    for r in rows:
        path = "barnes_hut" if r["name"] in BH_KERNELS else "fft"
        r["path"] = path
        r["launches"] = (bh_launches if path == "barnes_hut" else fft_launches)[r["name"]]
        if r["name"] in ("pairwise_sq_dists", "bsp_search"):
            r["service_launches"] = service["launches"].get(r["name"], 0)
        if r["name"] in ("fft_spread", "fft_gather"):
            r["fitted_device_ms"] = fft_breakdown[f"{r['name'][4:]}_device_ms"]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
