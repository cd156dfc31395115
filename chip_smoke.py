"""Drive the PyTorch/CUDA port on one GPU: build, check, fit, report.

    python3 chip_smoke.py                  # the full run: one card, no arguments
    python3 chip_smoke.py --n-iter 10      # shorter descents (both fits), same phases

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
               at D = 781, and by the KNN of 4 096 queries from its tiles
               against the KNN from the plain tiles; attractive with the
               rows' real lengths (p_len, as the fits call it) and over
               the full width W, both timed.
               The FFT path's spread and gather are also checked at
               128 boxes and exactly on planted lattice-node points, boxes
               overhanging the lattice's edges included; the spread is
               also checked for a bit-identical grid from two calls (48
               and 128 boxes), over every lattice size (n_boxes 1-128,
               N = 5 000), and on a compressed lattice (one far outlier
               puts the other points into the first band), which is timed.
               Device times from torch.profiler for every kernel row; the
               spread's also at 128 boxes.
4. gradient -- bh_gradient and fft_repulsion at a fixed y, N = 5 000, on
               the card against the port's own CPU path; and small fits
               (N = 500, Barnes-Hut and FFT) on the card against the same
               fits on the CPU.
5. fit      -- repro_torch.api.TSNE(method="barnes_hut",
               neighbor_method="exact", perplexity=30, random_state=0) on
               make_dataset("mnist") (70 000 x 784), with every kernel's
               launch count reset before and read after; pairwise, bsp,
               morton and attractive must be > 0, every attractive launch
               must carry p_len, and the embedding and KL
               must be finite.  300 descent steps (150 exaggerated)
               instead of the default 1 000 keep the script well inside
               its time limit.
6. breakdown -- one Barnes-Hut step at the fitted embedding, stage by
               stage (Morton, sort, tree, summaries, traversal,
               attractive, update), to show where a step's time goes,
               held against the backend's own gradient; and the card's
               idle share: kernel time from a torch.profiler trace of one
               descent step over the CUDA-event time a step of several
               run back to back with no sync, as the fit runs them.
7. fft fit  -- the same fit with method="fft" (48 boxes a dimension) and
               the default 1 000 steps (250 exaggerated); pairwise, bsp,
               attractive, fft_spread and fft_gather must be > 0, with
               spread = gather = attractive = steps run.  A second descent
               from the fit's graph and initial embedding
               (core.tsne.descend, the loop run_tsne runs) must give a
               bit-identical embedding and KL.
8. fft breakdown -- one FFT step at its fitted embedding, stage by stage
               (coords, spread, convolution, gather, attractive, update)
               through the functions fft_repulsion calls, held against
               the backend's own gradient; the spread kernel's device
               time at the fitted embedding; and the idle share as in 6.

Every kernel must be launched by at least one of the two fits.

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

# H100 SXM data-sheet peaks (dense): fp32 outside the tensor cores, TF32
# on the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
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


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the larger of flops at ``peak`` and
    nbytes at the HBM rate."""
    t_ops = flops / peak * 1e3
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


def knn_rows(x, nq: int, k: int, dist):
    """K nearest neighbours of the first ``nq`` rows of ``x`` among all its
    rows (self excluded) from the tiles ``dist`` gives, merged as
    core/knn.py merges them: (idx [nq, k], d2 [nq, k] ascending)."""
    n = x.shape[0]
    sqn = torch.sum(x * x, 1)
    big = torch.finfo(x.dtype).max
    rows = torch.arange(nq, device=x.device)
    best_d = torch.full((nq, k), big, dtype=x.dtype, device=x.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=x.device)
    for c0 in range(0, n, KNN_BLOCK_DB):
        c1 = min(c0 + KNN_BLOCK_DB, n)
        col = torch.arange(c0, c1, device=x.device)
        d2 = dist(x[:nq], x[c0:c1], sqn[:nq], sqn[c0:c1])
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
    ik, _ = knn_rows(x, nq, k, ops.pairwise_sq_dists)
    ip, dp = knn_rows(x, nq, k, _pairwise.pairwise_sq_dists)
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


def phase_kernels(x: torch.Tensor, k: int, perplexity: float) -> list[dict]:
    from repro_torch.core import (
        _pairwise, attractive, bsp, fft_repulsion, knn, morton, similarity,
    )
    from repro_torch.kernels import ops

    reg = ops.kernel_registry()
    dev = x.device
    n, d = x.shape
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = []

    def row(name, err, ms, plain_ms, flops, nbytes, library_ms=None,
            peak=PEAK_FP32_FLOPS, **extra):
        b_ms, b_by = bound(flops, nbytes, peak)
        e = reg[name]
        rows.append(dict(name=name, route="cuda", source=e["source"],
                         replaces=e["replaces"], tpu_kernel=e["tpu"], launches=0,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, **extra))
        log(f"kernel {name}: max_abs_err {err:.3e}  {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it)  "
            f"library {library_ms}" + "".join(f"  {k} {v}" for k, v in extra.items()))

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
    # rtol 1e-5: the parity target of the Pallas kernel against XLA
    if not (torch.allclose(p_k, p_p, rtol=1e-5, atol=1e-7)
            and torch.allclose(b_k, b_p, rtol=1e-5)):
        fail(f"bsp_search kernel disagrees: max |dp| {float((p_k - p_p).abs().max()):.3e}, "
             f"max |dbeta|/beta {float(((b_k - b_p).abs() / b_p.abs()).max()):.3e}")
    nk = d2.numel()
    row("bsp_search", float((p_k - p_p).abs().max()),
        cuda_ms(lambda: ops.bsp_search(d2, perplexity)),
        cuda_ms(lambda: bsp.binary_search_perplexity_plain(d2, perplexity), reps=3, inner=1),
        # 65 passes (64 bisection steps + the final one), each an exp and
        # ~5 fp32 operations an entry; d2 read once, cond_p written once
        flops=65.0 * 6.0 * nk, nbytes=4.0 * (2 * nk + n))

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
        # the same products and sum order as the plain version: rtol 1e-5,
        # with a floor at 1e-6 of the largest value where the 9 taps'
        # signed Lagrange weights cancel
        ph_scale = float(ph_p.abs().max())
        if not torch.allclose(ph_k, ph_p, rtol=1e-5, atol=1e-6 * ph_scale):
            fail(f"fft_gather kernel disagrees at {n_boxes} boxes: max |d| "
                 f"{float((ph_k - ph_p).abs().max()):.3e} of max {ph_scale:.3e}")
        log(f"fft interp {n_boxes} boxes: spread plan {tuple(ops.spread_plan(n, nodes))}, "
            f"bit-identical on a second call; gather max_abs_err "
            f"{float((ph_k - ph_p).abs().max()):.3e} (max {ph_scale:.3e}; rtol 1e-5, "
            "atol 1e-6 x max)")

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

    # every lattice size, N = 5 000, at the same tolerance
    for n_boxes in range(1, fft_repulsion.MAX_N_BOXES + 1):
        ys = y[:5000]
        base, wx, wy, _ = fft_repulsion.interp_coords(ys, n_boxes)
        charges = fft_repulsion.point_charges(ys)
        nodes = fft_repulsion.lattice_nodes(n_boxes)
        check_spread(f"{n_boxes} boxes, N = 5 000", ops.fft_spread(base, wx, wy, charges, nodes),
                     fft_repulsion.spread_to_grid(base, wx, wy, charges, nodes), quiet=True)
    log("fft_spread: n_boxes 1-128 at N = 5 000 within the tolerance")

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


def phase_fit(x_np: np.ndarray, method: str, n_iter: int, exag_iters: int,
              kl_every: int):
    """One fit through the estimator, every launch count reset before it
    and read after it.  Returns (estimator, launches)."""
    from repro_torch.api import TSNE
    from repro_torch.kernels import ops

    stats = []
    est = TSNE(method=method, neighbor_method="exact", perplexity=30,
               random_state=0, n_iter=n_iter, kl_every=kl_every, verbose=1,
               callbacks=[stats.append],
               backend_options=dict(knn_block_q=KNN_BLOCK_Q, knn_block_db=KNN_BLOCK_DB,
                                    exaggeration_iters=exag_iters,
                                    momentum_switch_iter=exag_iters))
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
    log(f"{method} fit: {sum(with_len)} of {len(with_len)} attractive_ell launches "
        "with the rows' real lengths (p_len)")
    if not all(with_len):
        fail(f"the {method} fit launched attractive_ell without p_len")
    t = est.timings_
    log(f"{method} fit phases (s): " + json.dumps(
        {k: t[k] for k in ("knn", "bsp", "symmetrize", "gradient_descent")}))
    log(f"{method} fit: wall {wall:.2f} s, {t['gradient_descent'] / est.n_iter_:.6f} s "
        f"per descent step over {est.n_iter_} steps")
    log(f"{method} fit KL checkpoints: " + json.dumps(
        [[int(i), float(v)] for i, v in est.kl_history_]))
    log(f"{method} fit max_traversal: {max(s.max_traversal for s in stats)}")
    log(f"{method} fit launches: {json.dumps(launches)}")
    emb = est.embedding_
    if emb.shape != (x_np.shape[0], 2) or not np.isfinite(emb).all():
        fail(f"{method}: embedding not finite or of wrong shape {emb.shape}")
    if not np.isfinite(est.kl_divergence_):
        fail(f"{method}: final KL is not finite")
    return est, launches


def check_launches(method: str, launches: dict, needed: tuple, steps: int | None = None):
    """Each kernel of the path launched; per-step kernels once a step."""
    missing = [k for k in needed if launches[k] <= 0]
    if missing:
        fail(f"the {method} fit never launched: {missing}")
    if steps is not None:
        per_step = {k: launches[k] for k in ("attractive_ell", "fft_spread", "fft_gather")}
        if any(v != steps for v in per_step.values()):
            fail(f"the {method} fit ran {steps} steps but launched {per_step}")


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
    from repro_torch.core.repulsive import bh_repulsion_sorted
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
        rep = bh_repulsion_sorted(y_s, tree, summ, backend.theta)
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
    # the card's busy time over one whole descent step (gradient + update)
    by_kernel = add_busy_share(out, lambda: tsne_step(state, g, 1.0, 0.8, backend=backend,
                                                      lr=est.learning_rate_, min_gain=0.01),
                               inner=20)
    # the spread kernel's device time in the profiled step, beside kernel_ms's
    spread_us = [us for k, us in by_kernel.items() if "spread" in k]
    out["spread_step_device_ms"] = sum(spread_us) * 1e-3 if spread_us else None
    log("fft step breakdown at the fitted embedding (s): " + json.dumps(out))
    return out


BH_KERNELS = ("pairwise_sq_dists", "bsp_search", "morton_encode", "attractive_ell")
FFT_KERNELS = ("pairwise_sq_dists", "bsp_search", "attractive_ell", "fft_spread",
               "fft_gather")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-iter", type=int, default=None,
                    help="descent steps of both fits (default: 300 Barnes-Hut, 1000 FFT)")
    ap.add_argument("--exaggeration-iters", type=int, default=None,
                    help="exaggerated steps of both fits (default: 150 Barnes-Hut, 250 FFT)")
    ap.add_argument("--kl-every", type=int, default=50)
    args = ap.parse_args()

    phase_device()
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import ops
    phase_build()

    x_np, _ = make_dataset("mnist")
    x = torch.as_tensor(x_np).cuda()
    perplexity = 30.0
    rows = phase_kernels(x, int(3 * perplexity), perplexity)
    phase_gradient(x)

    def steps(default_iter, default_exag):
        n_iter = default_iter if args.n_iter is None else args.n_iter
        exag = default_exag if args.exaggeration_iters is None else args.exaggeration_iters
        return n_iter, exag

    est, bh_launches = phase_fit(x_np, "barnes_hut", *steps(300, 150), args.kl_every)
    check_launches("barnes_hut", bh_launches, BH_KERNELS)
    phase_breakdown(est)
    est, fft_launches = phase_fit(x_np, "fft", *steps(1000, 250), args.kl_every)
    check_launches("fft", fft_launches, FFT_KERNELS, steps=est.n_iter_)
    check_reproducible(est)
    fft_breakdown = phase_fft_breakdown(est)

    unlaunched = [k for k in ops.LAUNCHES if bh_launches[k] + fft_launches[k] == 0]
    if unlaunched:
        fail(f"neither fit launched {unlaunched}")
    for r in rows:
        path = "barnes_hut" if r["name"] in BH_KERNELS else "fft"
        r["path"] = path
        r["launches"] = (bh_launches if path == "barnes_hut" else fft_launches)[r["name"]]
        if r["name"] == "fft_spread":
            r["fitted_device_ms"] = fft_breakdown["spread_device_ms"]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
