"""Time edited variants of the port's CUDA kernels side by side on one GPU.

    python3 chip_variants.py                            # every set
    python3 chip_variants.py --sets bsp,gather          # some sets
    python3 chip_variants.py --sets bsp,gather,spread --baseline DIR
    python3 chip_variants.py --sets wrappers --src DIR  # another checkout's wrappers

Each variant is a copy of ``src/repro_torch/csrc/<source>.cu`` with a few
text replacements (a tile size, a rounding, a pipeline depth), built with
the port's own nvcc flags into ``build/variants/``, loaded with ctypes and
launched on the same inputs at the main path's shapes (MNIST size,
70 000 x 784): ``pairwise`` on one 4096 x 8192 x 784 KNN tile (checked
against the plain tile at the chip_smoke.py tolerance), ``attractive`` on
the real symmetrized graph with and without the rows' lengths (checked
against the plain version).  Each variant prints one JSON line: ptxas
registers, CUDA-event ms (median of 7 x 10 back-to-back launches, two
passes in turn) and the error.  A variant that breaks the arithmetic on
purpose (``no_split``) shows what the rest of the kernel costs; its
error is expected to fail the tolerance.

``spread`` runs the FFT fit of chip_smoke.py (48 boxes, 1 000 steps) and
spreads its fitted embedding, a random one at 48 and 128 boxes, and a
compressed lattice (one far outlier): each launch plan (bands of R rows x
S slices x W warps, ``ops.spread_plan``'s numbers changed) and each
scan-depth variant (SCAN) is checked against the plain spread at the
chip_smoke.py tolerance and for a bit-identical second call, and timed on
the device (torch.profiler, the kernel alone) and by CUDA events.

``bsp`` runs each launch plan (G lanes a row x values a lane) of
``bsp.cu`` and its ``expf`` variant (the bisection's exponentials as
expf, not exp2f) on the main path's [70 000, 90] KNN distances, checked
against the plain search at chip_smoke.py's tolerance, with the SASS
instruction and MUFU counts of every instantiation (cuobjdump; the
listings go to build/variants/), and at K = 3, 6, 12 and perplexity 1,
1.5, 2 and K / 3 the rows whose beta leaves rtol 1e-5 of the plain search
on the card, for the plain search on the CPU and each kernel.  ``gather``
runs ``gather.cu`` with 64, 128 or 256 threads a CTA on the spread set's
inputs with a random potential and on a copy at no 16-byte boundary:
checked against the plain gather and for a bit-identical second call.
Both sets print registers, device ms and CUDA-event ms, two rounds.

With ``--baseline DIR`` the spread.cu, bsp.cu, gather.cu and traverse.cu
of another checkout (unpacked at DIR, e.g. the parent commit's) are timed
on the same inputs (the spread's zeroing separately); the gather set
checks that the two gathers give the same bits, and times the other
gather before and after each round; the traverse set pairs the other
walk with this one in place of the earlier kernel.  ``knn`` times the knn phase at MNIST size with the
port's merge of the chunks (torch.topk over distance-index keys) beside
a stable sort and the tie-blind torch.topk.  ``traverse`` times
``traverse.cu`` (a pack kernel, then a thread a point over the packed
node records) beside the earlier kernel over the tree's own arrays
(``variants/traverse_arrays.cu``) in alternating pairs, its CTA sizes, a
shared-memory copy of the top of the pre-order and one CTA an SM, and a
warp-shared walk through the union of the lanes' walks
(``variants/traverse_warp.cu``) with and without its prefetch, and two
lanes a point (``variants/traverse_pairs.cu``), on a random embedding and
a fitted one, each checked bit for bit against the plain walk; then one
Barnes-Hut descent step with either kernel, in alternating pairs.
``wrappers`` times the
wrappers at the main path's shapes on random inputs (CUDA-event ms and
the host's microseconds a call; bh_traverse where the port has it) and
the pieces of a launch; ``--src DIR`` times another checkout's port
instead (run parent, this, this, parent to compare).

``neighbors`` measures recall@90 (against exact, on 1 000 sampled rows)
of rp_forest on mouse_1p3m against N (20 000 to all 1 291 337 rows,
with and without its refine rounds) and against its options at all rows,
and of nn_descent against its rounds; and the forest query's recall on
MNIST's split (60 000 fitted rows, 10 000 queries) against the forest's
options.  ``transform`` fits chip_smoke.py's rp_forest model and holds
the transform of 256 held-out rows on the card against the CPU stage by
stage (the full path; from the CPU's query answers; from the CPU's p),
beside the CPU under 1e-6 and 1e-7 relative noise in p; then times the
exact index's transform of the 10 000 held-out rows at batches of 128,
512 and 2 048.

Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "variants"

PAIRWISE = {
    "base": [],
    # the conversion unit's rounding instead of the integer one
    "cvt_rna": [("return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 'uint32_t r; asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x)); return r;')],
    # every mma into the running accumulator: no fresh fragment a chunk
    "no_fresh_fragment": [
        (f"mma_tf32(part[i][j], {a}, {b});", f"mma_tf32(acc[i][j], {a}, {b});")
        for a, b in (("a_small[i]", "b_big[j]"), ("a_big[i]", "b_small[j]"),
                     ("a_big[i]", "b_big[j]"))],
    # 16 warps of 32 x 32 (at most 128 registers a thread)
    "warps16": [("constexpr int WM = 64;", "constexpr int WM = 32;")],
    # 64 x 64 blocks of 4 warps, three blocks an SM
    "block64": [("constexpr int BM = 128;", "constexpr int BM = 64;"),
                ("constexpr int BN = 128;", "constexpr int BN = 64;"),
                ("constexpr int WM = 64;", "constexpr int WM = 32;"),
                ("__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, 3)")],
    # D chunks of 16 through a 4-stage ring
    "bk16_stages4": [("constexpr int BK = 32;", "constexpr int BK = 16;"),
                     ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    # wrong on purpose: raw fp32 bits as both halves, the mmas unchanged
    "no_split": [("  big = to_tf32(a);\n  small = to_tf32(a - __uint_as_float(big));",
                  "  big = __float_as_uint(a);\n  small = big;")],
}
ATTRACTIVE = {
    "base": [],
    "unroll2": [("constexpr int UNROLL = 4;", "constexpr int UNROLL = 2;")],
    "unroll8": [("constexpr int UNROLL = 4;", "constexpr int UNROLL = 8;")],
    "warps4": [("constexpr int WARPS = 8;", "constexpr int WARPS = 4;")],
}


def build_variants(source: str, variants: dict, path: Path | None = None,
                   tag: str | None = None) -> dict:
    """name -> (ctypes library, registers reported by ptxas -v); ``path``
    is the source to edit (default the port's own), ``tag`` the prefix of
    the built files (default ``source``)."""
    from repro_torch.kernels import build
    text = (path or build.CSRC / f"{source}.cu").read_text()
    tag = tag or source
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        edited = text
        for old, new in edits:
            if old not in edited:
                raise SystemExit(f"variant {source}/{name}: {old!r} not in the source")
            edited = edited.replace(old, new)
        cu = OUT / f"{tag}-{name}.cu"
        cu.write_text(edited)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {source}/{name}:\n{log}")
        regs = [int(line.split("Used ")[1].split()[0]) for line in log.splitlines()
                if "registers" in line]
        libs[name] = (ctypes.CDLL(str(OUT / f"{tag}-{name}.so")), regs)
    return libs


def sass_counts(so: Path, dump: Path | None = None) -> dict:
    """kernel function -> [SASS instructions, MUFU instructions] of a built
    library (cuobjdump beside nvcc); ``dump`` keeps the whole listing."""
    from repro_torch.kernels import build
    out = subprocess.run([str(Path(build.nvcc()).with_name("cuobjdump")), "-sass", str(so)],
                         capture_output=True, text=True, check=True).stdout
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text(out)
    funcs, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = [0, 0]
        elif cur and re.search(r"/\*[0-9a-f]{4}\*/", line):
            funcs[cur][0] += 1
            funcs[cur][1] += "MUFU" in line
    return funcs


def event_ms(fn, reps: int = 7, inner: int = 10) -> float:
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


P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def run_pairwise(x: torch.Tensor, stream: int) -> None:
    from repro_torch.core import _pairwise
    d = x.shape[1]
    q, c = x[:4096].contiguous(), x[4096:12288].contiguous()
    qn, cn = torch.sum(q * q, 1), torch.sum(c * c, 1)
    ref = _pairwise.pairwise_sq_dists(q, c, qn, cn)
    tol = 2e-4 * ref.abs() + 1e-5 * (qn[:, None] + cn[None, :])
    out = torch.empty_like(ref)
    libs = build_variants("pairwise", PAIRWISE)
    for rnd in range(2):
        for name, (lib, regs) in libs.items():
            f = lib.pairwise_sq_dists
            f.argtypes = [P, P, P, P, P, I, I, I, P]
            call = lambda: f(q.data_ptr(), c.data_ptr(), qn.data_ptr(), cn.data_ptr(),
                             out.data_ptr(), q.shape[0], c.shape[0], d, stream)
            call()
            torch.cuda.synchronize()
            print(json.dumps(dict(kernel="pairwise", variant=name, round=rnd, registers=regs,
                                  ms=event_ms(call),
                                  err_over_tol=float(((out - ref).abs() / tol).max()))),
                  flush=True)
    print(json.dumps(dict(kernel="pairwise", yardstick="torch.cdist(q,c).square()",
                          ms=event_ms(lambda: torch.cdist(q, c).square()))), flush=True)


def run_attractive(x: torch.Tensor, stream: int) -> None:
    from repro_torch.core import attractive, knn, similarity
    from repro_torch.kernels import ops
    n = x.shape[0]
    idx, d2 = knn.knn(x, 90, 4096, 8192)
    p, _ = ops.bsp_search(d2, 30.0)
    sym_cols, sym_vals = similarity.symmetrize_ell(idx.cpu().numpy(), p.cpu().numpy())
    cols = torch.as_tensor(sym_cols).cuda()
    vals = torch.as_tensor(sym_vals / sym_vals.sum()).to(torch.float32).cuda()
    p_len = torch.as_tensor(similarity.ell_row_lengths(sym_cols)).cuda()
    y = (torch.randn((n, 2), generator=torch.Generator().manual_seed(0)) * 20.0).cuda()
    force = torch.empty((n, 2), device="cuda")
    kl_rows = torch.empty((n,), device="cuda")
    f_ref, _ = attractive.attractive_forces_ell(y, cols, vals, p_len)
    libs = build_variants("attractive", ATTRACTIVE)
    for rnd in range(2):
        for name, (lib, regs) in libs.items():
            f = lib.attractive_ell
            f.argtypes = [P, P, P, P, P, P, I, I, P]
            for lens in (p_len, None):
                call = lambda: f(y.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                                 None if lens is None else lens.data_ptr(),
                                 force.data_ptr(), kl_rows.data_ptr(), n, cols.shape[1],
                                 stream)
                call()
                torch.cuda.synchronize()
                print(json.dumps(dict(kernel="attractive", variant=name, round=rnd,
                                      row_len="p_len" if lens is not None else "None",
                                      registers=regs, ms=event_ms(call, inner=20),
                                      max_abs_err=float((force - f_ref).abs().max()))),
                      flush=True)


def device_ms(fn, name: str, reps: int = 20) -> dict:
    """Device milliseconds of ``fn``'s kernels from a torch.profiler trace
    of ``reps`` calls: {"match": the mean launch of the kernels whose name
    holds ``name`` (one a call), "other": the other kernels' time a call,
    "recorded": the matching launches the trace holds}.  The mean, not the
    sum over ``reps``: the trace can drop events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    match, other = [], 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if name in e.name:
                match.append(e.time_range.elapsed_us() * 1e-3)
            else:
                other += e.time_range.elapsed_us() * 1e-3 / reps
    return {"match": sum(match) / len(match) if match else None, "other": other,
            "recorded": len(match)}


# compile-time variants of csrc/spread.cu: the batches of 32 points a warp
# scans a segment (its shared memory from the variant's own
# fft_spread_smem_bytes); the launch plans are run-time arguments
SPREAD = {
    "base": [],
    "scan4": [("constexpr int SCAN = 8;", "constexpr int SCAN = 4;")],
    "scan16": [("constexpr int SCAN = 8;", "constexpr int SCAN = 16;")],
    # at most 64 registers a thread: twice the resident warps
    "regs64": [("__launch_bounds__(MAX_WARPS * 32)", "__launch_bounds__(MAX_WARPS * 32, 2)")],
    # no __syncwarp between the points of a batch (no memory ordering
    # between the lanes that add into one node)
    "no_point_sync": [("__syncwarp();              // the next point may add into the same nodes",
                       "")],
    # wrong on purpose: the points' adds dropped, scan and records kept
    "no_adds": [("        *node = __fadd_rn(*node, p);\n", "        (void)node;\n")],
}


_INPUTS: dict = {}


def spread_inputs(x_np: np.ndarray) -> dict:
    """name -> (base, wx, wy, charges, nodes) on the card: the FFT fit's
    embedding (chip_smoke.py's fit, 48 boxes), a random one at 48 and 128
    boxes, the random one with one point moved 1e4 away (every other point
    in the lattice's first band), and no points at all.  Made once a run."""
    if _INPUTS:
        return _INPUTS
    from repro_torch.api import TSNE
    from repro_torch.core import fft_repulsion as fr
    n = x_np.shape[0]
    est = TSNE(method="fft", neighbor_method="exact", perplexity=30, random_state=0,
               backend_options=dict(knn_block_q=4096, knn_block_db=8192,
                                    exaggeration_iters=250, momentum_switch_iter=250))
    y_fit = torch.as_tensor(est.fit(x_np).embedding_).cuda()
    y_rand = (torch.randn((n, 2), generator=torch.Generator().manual_seed(0)) * 20.0).cuda()
    y_far = y_rand.clone()
    y_far[0] = 1e4
    out = {}
    for name, y, n_boxes in (("fitted_48", y_fit, 48), ("random_48", y_rand, 48),
                             ("random_128", y_rand, 128), ("compressed_48", y_far, 48)):
        base, wx, wy, _ = fr.interp_coords(y, n_boxes)
        out[name] = (base, wx, wy, fr.point_charges(y), fr.lattice_nodes(n_boxes))
    # no points: the launch, the reductions and the stores alone
    out["empty_48"] = (torch.zeros((0, 2), dtype=torch.int32, device="cuda"),
                       *(torch.zeros((0, 3), device="cuda") for _ in range(3)),
                       fr.lattice_nodes(48))
    _INPUTS.update(out)
    return _INPUTS


def run_spread(x_np: np.ndarray, stream: int, baseline: Path | None) -> None:
    from repro_torch.core import fft_repulsion as fr
    from repro_torch.kernels import ops
    inputs = spread_inputs(x_np)
    refs = {k: fr.spread_to_grid(*v) for k, v in inputs.items()}
    libs = build_variants("spread", SPREAD)
    # base: every plan below; the other variants: the plan ops.spread_plan ships
    plans = [(r, s, 8) for r in (2, 4, 8) for s in (1, 2, 4, 8)] + [(4, 8, 4), (4, 8, 16)]
    for name, (lib, regs) in libs.items():
        f = lib.fft_spread
        f.argtypes = [P, P, P, P, P, I, I, I, I, I, I, L, P]
        lib.fft_spread_smem_bytes.argtypes = [I, I, I, I]
        lib.fft_spread_smem_bytes.restype = L
        for what, (base, wx, wy, ch, nodes) in inputs.items():
            n, c = ch.shape
            grid = torch.empty((nodes, nodes, c), device="cuda")
            # stage-depth variants run the default plan only
            shipped = [tuple(ops.spread_plan(n, nodes, c))[:3]]
            for rows, slices, warps in plans if name == "base" else shipped:
                smem = lib.fft_spread_smem_bytes(nodes, c, rows, warps)
                if smem > ops.SMEM_LIMIT:
                    continue       # over a block's shared memory at this lattice

                def call():
                    err = f(base.data_ptr(), wx.data_ptr(), wy.data_ptr(), ch.data_ptr(),
                            grid.data_ptr(), n, nodes, c, rows, slices, warps, smem, stream)
                    if err:
                        raise SystemExit(f"spread {name} {what} plan {rows, slices, warps}: "
                                         f"error {err}")

                call()
                first = grid.clone()
                call()
                torch.cuda.synchronize()
                ref = refs[what]
                scale = float(ref.abs().max()) if n else 0.0
                dev = device_ms(call, "spread")
                print(json.dumps(dict(
                    kernel="spread", variant=name, input=what, rows=rows, slices=slices,
                    warps=warps, ctas=slices * -(-nodes // rows), smem=smem, registers=regs,
                    device_ms=dev["match"], recorded=dev["recorded"], ms=event_ms(call, inner=20),
                    max_abs_err=float((grid - ref).abs().max()),
                    within_tol=bool(torch.allclose(grid, ref, rtol=1e-4, atol=1e-5 * scale)),
                    bit_identical=bool(torch.equal(grid, first)))), flush=True)
    if baseline is None:
        return
    # the other checkout's kernel: fft_spread(base, wx, wy, ch, grid, n, nodes, c,
    # stream) adding into a zeroed grid
    old = build_variants("spread", {"baseline": []},
                         path=baseline / "src/repro_torch/csrc/spread.cu", tag="spread-other")
    (lib, regs), = old.values()
    f = lib.fft_spread
    f.argtypes = [P, P, P, P, P, I, I, I, P]
    for what, (base, wx, wy, ch, nodes) in inputs.items():
        n, c = ch.shape
        grid = torch.empty((nodes, nodes, c), device="cuda")

        def call():
            grid.zero_()
            err = f(base.data_ptr(), wx.data_ptr(), wy.data_ptr(), ch.data_ptr(),
                    grid.data_ptr(), n, nodes, c, stream)
            if err:
                raise SystemExit(f"baseline spread {what}: error {err}")

        call()
        torch.cuda.synchronize()
        ref = refs[what]
        dev = device_ms(call, "spread")
        print(json.dumps(dict(
            kernel="spread", variant="baseline", input=what, registers=regs,
            device_ms=dev["match"], recorded=dev["recorded"], zeroing_device_ms=dev["other"],
            ms=event_ms(call, inner=20),
            max_abs_err=float((grid - ref).abs().max()),
            within_tol=bool(torch.allclose(grid, ref, rtol=1e-4,
                                           atol=1e-5 * float(ref.abs().max()) if n else 0.0)))),
            flush=True)


# compile-time variants of csrc/bsp.cu; the launch plans (lanes a row,
# values a lane) are run-time arguments
BSP = {
    "base": [],
    # the bisection's exponentials as expf of d2n, as the final pass
    "expf": [("  float x2[VALUES];                  // d2n log2(e): exp2f(-x2 beta) = exp(-d2n beta)\n"
              "#pragma unroll\n"
              "  for (int v = 0; v < VALUES; ++v) x2[v] = x[v] * 1.4426950408889634f;\n", ""),
             ("const float p = exp2f(-x2[v] * beta);", "const float p = expf(-x[v] * beta);")],
}
BSP_TOL = dict(rtol=1e-5, atol=1e-7)   # chip_smoke.py's: cond_p; beta at rtol 1e-5


def bsp_ok(p, b, p_ref, b_ref) -> bool:
    return bool(torch.allclose(p, p_ref, **BSP_TOL) and torch.allclose(b, b_ref, rtol=1e-5))


def run_bsp(x: torch.Tensor, stream: int, baseline: Path | None) -> None:
    """The bsp kernel's plans and variants on the main path's [70 000, 90]
    KNN distances, against the plain search."""
    from repro_torch.core import bsp, knn
    _, d2 = knn.knn(x, 90, 4096, 8192)
    n, k = d2.shape
    log_u = bsp.log_perplexity(30.0)
    p_ref, b_ref = bsp.binary_search_perplexity_plain(d2, 30.0)
    p, b = torch.empty_like(d2), torch.empty((n,), device="cuda")
    libs = build_variants("bsp", BSP)
    if baseline is not None:
        libs["baseline"] = build_variants(
            "bsp", {"baseline": []}, path=baseline / "src/repro_torch/csrc/bsp.cu",
            tag="bsp-other")["baseline"]
    for name in BSP:
        print(json.dumps(dict(kernel="bsp", variant=name, sass=sass_counts(
            OUT / f"bsp-{name}.so", OUT / f"bsp-{name}.sass"))), flush=True)
    bsp_conditioning(libs, stream)
    for rnd in range(2):
        for name, (lib, regs) in libs.items():
            f = lib.bsp_search
            if name == "baseline":   # bsp_search(d2, cond_p, beta, n, k, log_u, tol, iters, stream)
                f.argtypes = [P, P, P, I, I, ctypes.c_float, ctypes.c_float, I, P]
                plans = [None]
            else:
                f.argtypes = [P, P, P, I, I, ctypes.c_float, ctypes.c_float, I, I, I, P]
                plans = [(4, 24), (8, 12), (16, 6), (32, 3)]
            for plan in plans:
                extra = () if plan is None else plan

                def call():
                    err = f(d2.data_ptr(), p.data_ptr(), b.data_ptr(), n, k, log_u, 1e-5, 64,
                            *extra, stream)
                    if err:
                        raise SystemExit(f"bsp {name} plan {plan}: error {err}")

                call()
                torch.cuda.synchronize()
                dev = device_ms(call, "bsp", reps=10)
                print(json.dumps(dict(
                    kernel="bsp", variant=name, round=rnd, lanes=plan and plan[0],
                    values=plan and plan[1], registers=regs, device_ms=dev["match"],
                    recorded=dev["recorded"], ms=event_ms(call, reps=5, inner=5),
                    max_abs_err=float((p - p_ref).abs().max()),
                    beta_max_rel=float(((b - b_ref).abs() / b_ref.abs()).max()),
                    within_tol=bsp_ok(p, b, p_ref, b_ref))), flush=True)


def bsp_conditioning(libs: dict, stream: int) -> None:
    """At small K and perplexity 1 or 2, fp32 cannot decide the bisection:
    4 096 rows (all-equal and zero rows among them, as chip_smoke.py's
    check) at each (K, perplexity), the rows whose beta differs from the
    plain search on the card beyond rtol 1e-5, for the plain search on the
    CPU and for each built kernel."""
    from repro_torch.core import bsp
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(15)
    for k in (3, 6, 12):
        d2c = torch.randn((4096, k), generator=gen).abs() * 4.0
        d2c[::97] = 2.5
        d2c[1::97] = 0.0
        d2 = d2c.cuda()
        for perp in sorted({1.0, 1.5, 2.0, k / 3.0}):
            _, b_ref = bsp.binary_search_perplexity_plain(d2, perp)
            off = {"plain_cpu": bsp.binary_search_perplexity_plain(d2c, perp)[1].cuda()}
            for name, (lib, _) in libs.items():
                p, b = torch.empty_like(d2), torch.empty((4096,), device="cuda")
                plan = () if name == "baseline" else tuple(ops.bsp_plan(k))
                f = lib.bsp_search
                f.argtypes = [P, P, P, I, I, ctypes.c_float, ctypes.c_float, I] + [I] * len(plan) + [P]
                f(d2.data_ptr(), p.data_ptr(), b.data_ptr(), 4096, k, bsp.log_perplexity(perp),
                  1e-5, 64, *plan, stream)
                torch.cuda.synchronize()
                off[name] = b
            print(json.dumps(dict(kernel="bsp", conditioning=dict(k=k, perplexity=perp), rows_off={
                name: int((~torch.isclose(b, b_ref, rtol=1e-5)).sum()) for name, b in off.items()})),
                flush=True)


# variants of csrc/gather.cu
GATHER = {
    "base": [],
    "threads256": [("constexpr int THREADS = 128;", "constexpr int THREADS = 256;")],
    "threads64": [("constexpr int THREADS = 128;", "constexpr int THREADS = 64;")],
}
GATHER_TOL = 1e-5      # chip_smoke.py's: rtol 1e-5, atol 1e-6 x the largest value


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of t whose data starts 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def run_gather(x_np: np.ndarray, stream: int, baseline: Path | None) -> None:
    """The gather kernel's variants on the spread set's inputs with a
    random potential, against the plain gather and, with a baseline, bit
    for bit against the other checkout's kernel."""
    from repro_torch.core import fft_repulsion as fr
    inputs = {k: v[:3] + (v[4],) for k, v in spread_inputs(x_np).items()}
    base, wx, wy, nodes = inputs["random_48"]
    inputs["misaligned_48"] = (misaligned(base), misaligned(wx), misaligned(wy), nodes)
    gen = torch.Generator().manual_seed(1)
    pots = {nd: torch.randn((nd, nd, 4), generator=gen).cuda()
            for nd in {v[3] for v in inputs.values()}}
    refs = {k: fr.gather_from_grid(pots[v[3]], *v[:3]) for k, v in inputs.items()}
    libs = build_variants("gather", GATHER)
    other = {}

    def run(lib, regs, variant, rnd=None, baseline_run=False):
        """fft_gather(pot, base, wx, wy, phi, n, nodes, stream) of one
        build on every input, checked and timed."""
        f = lib.fft_gather
        f.argtypes = [P, P, P, P, P, I, I, P]
        for what, (base, wx, wy, nodes) in inputs.items():
            n = base.shape[0]
            phi = torch.empty((n, 4), device="cuda")

            def call():
                err = f(pots[nodes].data_ptr(), base.data_ptr(), wx.data_ptr(),
                        wy.data_ptr(), phi.data_ptr(), n, nodes, stream)
                if err:
                    raise SystemExit(f"gather {variant} {what}: error {err}")

            call()
            first = phi.clone()
            call()
            torch.cuda.synchronize()
            if baseline_run:
                other[what] = phi.clone()
            ref = refs[what]
            scale = float(ref.abs().max()) if n else 0.0
            dev = device_ms(call, "gather") if n else {"match": None, "recorded": 0}
            print(json.dumps(dict(
                kernel="gather", variant=variant, round=rnd, input=what, registers=regs,
                device_ms=dev["match"], recorded=dev["recorded"], ms=event_ms(call, inner=20),
                max_abs_err=float((phi - ref).abs().max()) if n else 0.0,
                within_tol=bool(torch.allclose(phi, ref, rtol=GATHER_TOL,
                                               atol=0.1 * GATHER_TOL * scale)),
                bit_identical=bool(torch.equal(phi, first)),
                same_bits_as_baseline=bool(torch.equal(phi, other[what]))
                if what in other and not baseline_run else None)), flush=True)

    if baseline is not None:   # the other checkout's kernel before and after each round
        (other_lib, other_regs), = build_variants(
            "gather", {"baseline": []}, path=baseline / "src/repro_torch/csrc/gather.cu",
            tag="gather-other").values()
        run(other_lib, other_regs, "baseline", baseline_run=True)
    for rnd in range(2):
        for name, (lib, regs) in libs.items():
            run(lib, regs, name, rnd)
        if baseline is not None:
            run(other_lib, other_regs, "baseline", baseline_run=True)


def knn_merged(x: torch.Tensor, k: int, merge: str, block_q: int = 4096,
               block_db: int = 8192):
    """core/knn.py's blocked KNN with another merge of the chunks: "sort",
    a stable sort of [best | chunk] by distance keeping the first k (ties
    in index order, as lax.top_k); "topk", torch.topk on the distances
    (ties in no order); "keys_cat", torch.topk over the distance-index
    keys built by whole-array ops (int64 cast, shift, or) and torch.cat,
    where core/knn.py writes them in place.  Returns (idx [N, k], d2 [N, k])."""
    from repro_torch.kernels import ops
    n = x.shape[0]
    sqn = torch.sum(x * x, dim=1)
    big = torch.finfo(x.dtype).max
    out_d, out_i = [], []
    for q0 in range(0, n, block_q):
        q1 = min(q0 + block_q, n)
        q_idx = torch.arange(q0, q1, device=x.device)
        best_d = torch.full((q1 - q0, k), big, device=x.device)
        best_i = torch.full((q1 - q0, k), n, dtype=torch.int64, device=x.device)
        for c0 in range(0, n, block_db):
            c1 = min(c0 + block_db, n)
            col = torch.arange(c0, c1, device=x.device)
            d2 = ops.pairwise_sq_dists(x[q0:q1], x[c0:c1], sqn[q0:q1], sqn[c0:c1])
            if c0 < q1 and q0 < c1:
                d2 = d2.masked_fill(col[None, :] == q_idx[:, None], big)
            if merge == "keys_cat":
                keys = d2.view(torch.int32).to(torch.int64)
                keys <<= 32
                keys |= col
                best_key = best_i if c0 else (best_d.view(torch.int32).to(torch.int64) << 32) | n
                best_i = torch.topk(torch.cat([best_key, keys], dim=1), k, dim=1,
                                    largest=False, sorted=True).values
                continue
            cat_d = torch.cat([best_d, d2], dim=1)
            cat_i = torch.cat([best_i, col.expand(q1 - q0, -1)], dim=1)
            if merge == "sort":
                best_d, arg = torch.sort(cat_d, dim=1, stable=True)
                best_d, arg = best_d[:, :k], arg[:, :k]
            else:
                best_d, arg = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
            best_i = torch.gather(cat_i, 1, arg)
        if merge == "keys_cat":
            best_d = (best_i >> 32).to(torch.int32).view(torch.float32)
            best_i = best_i & 0xFFFFFFFF
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_i).to(torch.int32), torch.cat(out_d)


def run_knn(x: torch.Tensor) -> None:
    """The knn phase at MNIST size (K = 90, blocks 4096 x 8192) with each
    merge: the port's (torch.topk over 64-bit distance-index keys), a
    stable sort, and the tie-blind torch.topk of the parent; seconds of
    the whole KNN (synchronised), median of 3, two rounds in turn.  The
    sort's indices must equal the port's."""
    import time
    from repro_torch.core import knn
    runs = {"keys": lambda: knn.knn(x, 90, 4096, 8192),
            "keys_cat": lambda: knn_merged(x, 90, "keys_cat"),
            "sort": lambda: knn_merged(x, 90, "sort"),
            "topk": lambda: knn_merged(x, 90, "topk")}
    i_keys, d_keys = runs["keys"]()
    same = {}
    for name in ("keys_cat", "sort"):
        i, d = runs[name]()
        same[f"{name}_equals_keys"] = bool(torch.equal(i, i_keys) and torch.equal(d, d_keys))
    i_topk, _ = runs["topk"]()
    print(json.dumps(dict(knn="check", **same,
                          topk_rows_differing=int((i_topk != i_keys).any(1).sum()))),
          flush=True)
    for rnd in range(2):
        for name, fn in runs.items():
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            print(json.dumps(dict(knn=name, round=rnd, s=float(np.median(times)),
                                  runs=times)), flush=True)


# compile-time variants of csrc/traverse.cu (the pack kernel, then one
# thread a point walking the packed records, 256-thread CTAs: "base")
TRAVERSE = {
    "base": [],
    "threads64": [("constexpr int THREADS = 256;", "constexpr int THREADS = 64;")],
    "threads128": [("constexpr int THREADS = 256;", "constexpr int THREADS = 128;")],
    "threads512": [("constexpr int THREADS = 256;", "constexpr int THREADS = 512;")],
    # the first 512 nodes of the pre-order (every walk's first steps) in
    # shared memory
    "smem_top512": [
        ("__device__ __forceinline__ Node load_node(const Node* __restrict__ nodes, int k) {\n",
         "constexpr int TOP = 512;\n__shared__ Node top[TOP];\n\n"
         "__device__ __forceinline__ Node load_node(const Node* __restrict__ nodes, int k) {\n"
         "  if (k < TOP) return top[k];\n"),
        ("  if (i >= n) return;\n",
         "  {\n    const int nn = valid_nodes(n_nodes, cap);\n"
         "    for (int k = threadIdx.x; k < min(TOP, nn); k += THREADS) {\n"
         "      top[k].f = __ldg(&nodes[k].f);\n      top[k].i = __ldg(&nodes[k].i);\n    }\n"
         "    __syncthreads();\n  }\n  if (i >= n) return;\n")],
    # one CTA an SM: ceil(warps / SMs) warps a CTA, so that each SM walks
    # one contiguous run of points
    "cta_per_sm": [
        ("constexpr int THREADS = 256;", "constexpr int THREADS = 1024;"),
        ("const int i = blockIdx.x * THREADS + threadIdx.x;",
         "const int i = blockIdx.x * blockDim.x + threadIdx.x;"),
        ("traverse_walk_kernel<false><<<blocks(n, THREADS), THREADS, 0, s>>>(",
         "traverse_walk_kernel<false><<<blocks(n, sm_threads(n)), sm_threads(n), 0, s>>>("),
        ("}  // namespace\n",
         "int sm_threads(int n) {\n  int dev = 0, sms = 1;\n  cudaGetDevice(&dev);\n"
         "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
         "  const long long per_sm = ((n + 31LL) / 32 + sms - 1) / sms;\n"
         "  return (int)(32 * (per_sm < 32 ? per_sm : 32));\n}\n\n}  // namespace\n")],
}
# the warp-shared design (variants/traverse_warp.cu: the warp steps through
# the union of its lanes' walks, the record of w + 1 loaded ahead) and the
# same source with one step taken out or changed at a time
_NO_PREFETCH = [
    ("    const Node next = load_node(nodes, min(w + 1, cap - 1));   // w's successor if it opens\n",
     ""),
    ("cur = w_next == w + 1 ? next : load_node(", "cur = load_node("),
]
_PER_LANE = [("__reduce_min_sync(FULL, ptr)", "ptr")]   # each lane walks on its own
TRAVERSE_WARP = {
    "warp": [],
    "warp_no_prefetch": _NO_PREFETCH,
    "lane_prefetch": _PER_LANE,
    "lane": _PER_LANE + _NO_PREFETCH,          # the port's walk, written as a loop of votes
    "warp_threads64": [("constexpr int THREADS = 256;", "constexpr int THREADS = 64;")],
    "warp_threads512": [("constexpr int THREADS = 256;", "constexpr int THREADS = 512;")],
}
# two lanes a point, each loading half of the record (variants/traverse_pairs.cu)
TRAVERSE_PAIRS = {
    "pairs": [],
    "pairs_threads128": [("constexpr int THREADS = 256;", "constexpr int THREADS = 128;")],
    "pairs_threads512": [("constexpr int THREADS = 256;", "constexpr int THREADS = 512;")],
}
# the earlier kernel, one thread a point over the tree's own arrays: kept
# beside chip_variants.py, not in csrc/, which holds the port's kernels only
VARIANTS = ROOT / "variants"
_ARRAYS_ARGTYPES = [P] * 8 + [ctypes.c_float] + [P] * 3 + [I, I, P]
# the C entry before the walk took positions (the sharded gradient's
# ``pos``): traverse_warp.cu, traverse_pairs.cu and a --baseline checkout's
# traverse.cu from before it
_RECORDS_ARGTYPES = [P] * 8 + [ctypes.c_float] + [P] * 4 + [I, I, P]


def run_traverse(x_np: np.ndarray, stream: int, baseline: Path | None,
                 pairs: int = 10) -> None:
    """The port's kernel (csrc/traverse.cu: pack, then a thread a point over
    the packed records) and its variants, the warp-shared and the
    two-lanes-a-point designs and their variants, and the earlier kernel
    over the tree's own arrays, on a
    random embedding (randn x 20, as chip_smoke.py's kernels phase) and at
    the embedding of a Barnes-Hut fit of 1 000 steps (theta 0.5, compressed
    tree).  Each is checked bit for bit against the plain walk (force, z,
    steps; the pack's records against pack_nodes); then the warps' union
    length against their longest lane (repulsive.warp_walk on the card),
    ``pairs`` alternating pairs earlier kernel / port's (CUDA-event ms of
    10 back-to-back calls, median of 7; device ms of each kernel by
    torch.profiler), every variant twice, and the whole descent step with
    either kernel (run_traverse_step).  With ``baseline`` the other
    checkout's traverse.cu (built as "baseline") takes the earlier
    kernel's place in the pairs: the walk without positions against the
    same walk before the C entry took them."""
    from repro_torch.api import TSNE
    from repro_torch.core import morton, quadtree, summarize
    from repro_torch.core.repulsive import (
        RECORD_WORDS, bh_repulsion_sorted, pack_nodes, theta_squared, warp_walk,
    )
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(0)
    est = TSNE(perplexity=30, random_state=0, backend_options=dict(
        knn_block_q=4096, knn_block_db=8192)).fit(x_np)
    inputs = {"random": (torch.randn((70_000, 2), generator=gen) * 20.0).cuda(),
              "fitted": torch.as_tensor(est.embedding_).cuda()}
    libs = build_variants("traverse", TRAVERSE)
    libs.update(build_variants("traverse", TRAVERSE_WARP, path=VARIANTS / "traverse_warp.cu",
                               tag="traverse_warp"))
    libs.update(build_variants("traverse", TRAVERSE_PAIRS, path=VARIANTS / "traverse_pairs.cu",
                               tag="traverse_pairs"))
    libs["arrays"] = build_variants("traverse", {"arrays": []},
                                    path=VARIANTS / "traverse_arrays.cu",
                                    tag="traverse_arrays")["arrays"]
    if baseline is not None:
        libs["baseline"] = build_variants(
            "traverse", {"baseline": []}, path=baseline / "src/repro_torch/csrc/traverse.cu",
            tag="traverse-other")["baseline"]
    older = {"arrays"} | set(TRAVERSE_WARP) | set(TRAVERSE_PAIRS) | {"baseline"}
    earlier = "baseline" if baseline is not None else "arrays"
    symbol, argtypes = ops._SIGNATURES["traverse"]
    kernels = {name: ("traverse_kernel",) if name == "arrays"
               else ("traverse_pack", "traverse_walk") for name in libs}
    t2 = theta_squared(0.5)
    for what, y in inputs.items():
        cent, r_span = morton.span_radius(y)
        codes_s, y_s, _ = quadtree.sort_points_by_code(y, ops.morton_encode(y, cent, r_span))
        tree = quadtree.build_quadtree(codes_s)
        summ = summarize.summarize(tree, y_s, r_span)
        ref = bh_repulsion_sorted(y_s, tree, summ, 0.5)
        n, cap, n_nodes = y.shape[0], tree.capacity, int(tree.n_nodes)
        out = (torch.empty((n, 2), device="cuda"), torch.empty((n,), device="cuda"),
               torch.empty((n,), dtype=torch.int64, device="cuda"))
        records = torch.empty((cap, RECORD_WORDS), dtype=torch.int32, device="cuda")
        tree_args = (y_s.data_ptr(), tree.start.data_ptr(), tree.end.data_ptr(),
                     tree.skip.data_ptr(), tree.n_nodes.data_ptr(), summ.count.data_ptr(),
                     summ.sum_y.data_ptr(), summ.side.data_ptr(), t2)
        outs = tuple(t.data_ptr() for t in out)
        calls = {}
        for name, (lib, regs) in libs.items():
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            if name == "arrays":
                fn.argtypes = _ARRAYS_ARGTYPES
                args = tree_args + outs + (n, cap, stream)
            elif name in older:
                fn.argtypes = _RECORDS_ARGTYPES
                args = tree_args + (records.data_ptr(),) + outs + (n, cap, stream)
            else:      # no positions: every point in order
                fn.argtypes = argtypes
                args = tree_args + (records.data_ptr(), None) + outs + (n, n, cap, stream)

            def call(fn=fn, args=args, name=name):
                err = fn(*args)
                if err:
                    raise SystemExit(f"traverse/{name}: launch error {err}")

            calls[name] = call
            records.fill_(-1)
            call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            if name != "arrays":
                same = same and torch.equal(records[:n_nodes], pack_nodes(tree, summ)[:n_nodes])
            print(json.dumps(dict(kernel="traverse", variant=name, input=what, registers=regs,
                                  bit_identical=same)), flush=True)
        _, union = warp_walk(y_s, pack_nodes(tree, summ), summ.sum_y, tree.n_nodes, 0.5)
        steps = torch.zeros(union.shape[0] * 32, dtype=torch.int64, device="cuda")
        steps[:n] = ref.steps
        longest = steps.view(-1, 32).amax(dim=1)
        print(json.dumps(dict(kernel="traverse", input=what, n_nodes=n_nodes,
                              visits=int(ref.steps.sum()), warps=union.shape[0],
                              union_mean=float(union.double().mean()),
                              longest_lane_mean=float(longest.double().mean()),
                              union_over_longest=float(union.sum() / longest.sum()),
                              union_max=int(union.max()), longest_max=int(longest.max()))),
              flush=True)

        def timing(name):
            dev = {k: device_ms(calls[name], k) for k in kernels[name]}
            return dict(ms=event_ms(calls[name]),
                        device_ms=sum(d["match"] or 0.0 for d in dev.values()),
                        device={k: d["match"] for k, d in dev.items()},
                        recorded={k: d["recorded"] for k, d in dev.items()})

        for i in range(pairs):
            for name in (earlier, "base") if i % 2 == 0 else ("base", earlier):
                print(json.dumps(dict(kernel="traverse", input=what, pair=i, variant=name,
                                      **timing(name))), flush=True)
        for rnd in range(2):
            for name in libs:
                print(json.dumps(dict(kernel="traverse", input=what, round=rnd, variant=name,
                                      **timing(name))), flush=True)
    run_traverse_step(est, libs["arrays"][0], pairs)


def run_traverse_step(est, arrays_lib, pairs: int) -> None:
    """One Barnes-Hut descent step (core.tsne.tsne_step, the fit's backend)
    at the fitted embedding with the port's bh_traverse and with the
    earlier kernel behind it (ops.bh_traverse_cuda swapped): ``pairs``
    alternating pairs of CUDA-event ms (10 back-to-back steps, median of 7)."""
    from repro_torch.api import make_backend
    from repro_torch.core.repulsive import RepulsionResult, theta_squared
    from repro_torch.core.tsne import TsneConfig, TsneState, tsne_step
    from repro_torch.kernels import ops
    fn = getattr(arrays_lib, ops._SIGNATURES["traverse"][0])
    fn.argtypes, fn.restype = _ARRAYS_ARGTYPES, ctypes.c_int

    def arrays_cuda(y_s, tree, summ, theta, records=None, pos=None):
        if pos is not None:
            raise ValueError("the earlier kernel walks every point: no pos")
        n = y_s.shape[0]
        out = RepulsionResult(torch.empty((n, 2), device=y_s.device),
                              torch.empty((n,), device=y_s.device),
                              torch.empty((n,), dtype=torch.int64, device=y_s.device))
        err = fn(y_s.data_ptr(), tree.start.data_ptr(), tree.end.data_ptr(),
                 tree.skip.data_ptr(), tree.n_nodes.data_ptr(), summ.count.data_ptr(),
                 summ.sum_y.data_ptr(), summ.side.data_ptr(), theta_squared(theta),
                 *(t.data_ptr() for t in out), n, tree.capacity,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"traverse/arrays: launch error {err}")
        return out

    g = est.neighbor_graph_
    y = torch.as_tensor(est.embedding_).cuda()
    state = TsneState(y=y, velocity=torch.zeros_like(y), gains=torch.ones_like(y), iteration=0)
    backend = make_backend("barnes_hut", TsneConfig(), y.shape[0])
    kernels = {"base": ops.bh_traverse_cuda, "arrays": arrays_cuda}

    def step():
        return tsne_step(state, g, 1.0, 0.8, backend=backend, lr=est.learning_rate_,
                         min_gain=0.01)

    try:
        ys = {}
        for name, kernel in kernels.items():
            ops.bh_traverse_cuda = kernel
            ys[name] = step()[0].y
        same = torch.equal(ys["base"], ys["arrays"])
        for i in range(pairs):
            for name in ("arrays", "base") if i % 2 == 0 else ("base", "arrays"):
                ops.bh_traverse_cuda = kernels[name]
                print(json.dumps(dict(kernel="traverse", input="bh_step", pair=i, variant=name,
                                      same_step=same, ms=event_ms(step))), flush=True)
    finally:
        ops.bh_traverse_cuda = kernels["base"]


def recall_rows(x: torch.Tensor, rows: torch.Tensor, k: int) -> np.ndarray:
    """Exact k nearest neighbours of ``x[rows]`` among all of ``x`` (self
    excluded), through the exact query index."""
    from repro_torch.neighbors import ExactNeighbors
    idx, _ = ExactNeighbors(block_q=1024, block_db=65536).build_index(x).query(x[rows], k + 1)
    idx, rows_h = idx.cpu().numpy(), rows.cpu().numpy()
    return np.stack([r[r != i][:k] for r, i in zip(idx, rows_h)])


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_neighbors() -> None:
    """Recall@90 of rp_forest against N (default options, with and without
    the refine rounds) and against its options at 1.29 M rows, and of
    nn_descent against its rounds, on mouse_1p3m (1 000 sampled rows);
    the forest query's recall against the forest's options on MNIST's
    split (60 000 fitted rows, the 10 000 others as queries)."""
    from repro_torch.data.datasets import make_dataset
    from repro_torch.neighbors import (
        ExactNeighbors, NNDescentNeighbors, RPForestNeighbors, recall_at_k,
    )
    k = 90
    x_all = torch.as_tensor(make_dataset("mouse_1p3m")[0]).cuda()
    gen = torch.Generator().manual_seed(0)
    for n in (20_000, 80_000, 320_000, x_all.shape[0]):
        x = x_all[:n]
        rows = torch.randperm(n, generator=gen)[:1000].cuda()
        ref = recall_rows(x, rows, k)
        backends = [RPForestNeighbors(refine_iters=0), RPForestNeighbors()]
        if n == x_all.shape[0]:
            backends += [RPForestNeighbors(n_trees=t, leaf_size=s)
                         for t, s in ((16, 128), (32, 128), (32, 256))]
            backends += [NNDescentNeighbors(n_iters=i) for i in (10, 20, 40)]
        for nb in backends:
            (idx, _), secs = timed(lambda: nb.neighbors(x, k))
            print(json.dumps(dict(set="neighbors", data="mouse_1p3m", n=n, backend=repr(nb),
                                  recall=recall_at_k(ref, idx[rows].cpu().numpy()),
                                  seconds=secs)), flush=True)
            del idx
    x_np = make_dataset("mnist")[0]
    train, test = torch.as_tensor(x_np[:60_000]).cuda(), torch.as_tensor(x_np[60_000:]).cuda()
    exact = ExactNeighbors().build_index(train)
    ref = np.concatenate([exact.query(test[r:r + 128], k)[0].cpu().numpy()
                          for r in range(0, test.shape[0], 128)])
    for t, s in ((8, 64), (16, 128), (32, 128), (16, 512), (32, 256)):
        index, build_s = timed(lambda: RPForestNeighbors(n_trees=t, leaf_size=s).build_index(train))
        got, query_s = timed(lambda: np.concatenate(
            [index.query(test[r:r + 128], k)[0].cpu().numpy()
             for r in range(0, test.shape[0], 128)]))
        print(json.dumps(dict(set="neighbors", data="mnist query", n_trees=t, leaf_size=s,
                              leaves=list(index.leaves.shape), recall=recall_at_k(ref, got),
                              build_s=build_s, query_s=query_s)), flush=True)


def run_transform() -> None:
    """The transform of 256 held-out MNIST rows into the rp_forest fit of
    chip_smoke.py (32 trees of >= 128 points, 1 000 steps), card against
    CPU stage by stage: the full path, the card from the CPU's query
    answers, the card from the CPU's p, and the CPU alone with p scaled
    by 1 + 1e-6 and 1 + 1e-7 times N(0, 1) noise.  Then rows/s of the
    exact index's transform of the 10 000 held-out rows against the batch
    size."""
    from repro_torch.api import TSNE
    from repro_torch.core import bsp
    from repro_torch.data.datasets import make_dataset
    from repro_torch.embed import transform as tr
    from repro_torch.neighbors import ExactNeighbors

    x_np = make_dataset("mnist")[0]
    est = TSNE(neighbor_method="rp_forest", neighbor_options={"n_trees": 32, "leaf_size": 128},
               perplexity=30, random_state=0,
               backend_options=dict(knn_block_q=4096, knn_block_db=8192)).fit(x_np[:60_000])
    k, span = est.query_k_, float(np.ptp(est.embedding_))
    train = torch.as_tensor(x_np[:60_000]).cuda()
    test = torch.as_tensor(x_np[60_000:]).cuda()
    y_ref = torch.as_tensor(est.embedding_).cuda()
    q = test[:256]
    card_index = ExactNeighbors().build_index(train)
    cpu_index = ExactNeighbors().build_index(train.cpu())
    q_card, q_cpu = card_index.query(q, k), cpu_index.query(q.cpu(), k)
    p_cpu = bsp.binary_search_perplexity(q_cpu[1], 30.0)[0]

    class Answers:
        """Replays given (idx, d2) chunk after chunk."""
        def __init__(self, idx, d2):
            self.idx, self.d2, self.at = idx, d2, 0

        def query(self, x, kk):
            r = slice(self.at, self.at + x.shape[0])
            self.at += x.shape[0]
            return self.idx[r].to(x.device), self.d2[r].to(x.device)

    def run(dev, answers, p_given=None, noise=0.0):
        search = tr.bsp.binary_search_perplexity
        at = [0]

        def with_p(d2, perp, *a, **kw):
            p, beta = search(d2, perp, *a, **kw)
            r = slice(at[0], at[0] + d2.shape[0])
            at[0] += d2.shape[0]
            if p_given is not None:
                p = p_given[r].to(d2.device)
            if noise:
                g = torch.Generator().manual_seed(at[0])
                p = p * (1 + noise * torch.randn(p.shape, generator=g)).to(d2.device)
            return p, beta

        tr.bsp.binary_search_perplexity = with_p
        try:
            return tr.transform_batch(q.to(dev), Answers(*answers), y_ref.to(dev), k=k,
                                      perplexity=30.0)
        finally:
            tr.bsp.binary_search_perplexity = search

    y_cpu, stats = run("cpu", q_cpu)
    same = (torch.sort(q_card[0].cpu(), 1).values == torch.sort(q_cpu[0], 1).values).all(1)
    d2_rel = float(((q_card[1].cpu() - q_cpu[1]).abs() / q_cpu[1]).max())
    print(json.dumps(dict(set="transform", rows=256, span=span, same_sets=int(same.sum()),
                          d2_max_rel=d2_rel, at_step_cap=float((stats.n_steps == 120).mean()),
                          mean_steps=float(stats.n_steps.mean()))), flush=True)
    card = test.device
    for name, (y, _) in (("card", run(card, q_card)),
                         ("card from the cpu's query answers", run(card, q_cpu)),
                         ("card from the cpu's p", run(card, q_cpu, p_given=p_cpu)),
                         ("cpu, p x (1 + 1e-6 noise)", run("cpu", q_cpu, noise=1e-6)),
                         ("cpu, p x (1 + 1e-7 noise)", run("cpu", q_cpu, noise=1e-7))):
        dy = np.abs(y - y_cpu).max(1)
        print(json.dumps(dict(set="transform", against="cpu", run=name, max_dy=float(dy.max()),
                              median_dy=float(np.median(dy)),
                              p99_dy=float(np.quantile(dy, 0.99)), worst_row=int(dy.argmax()),
                              rows_over_1e3_span=int((dy > 1e-3 * span).sum()))), flush=True)
    for batch in (128, 512, 2048):
        cfg = tr.TransformConfig(batch_size=batch)
        tr.transform_batch(test[:batch], card_index, y_ref, k=k, perplexity=30.0, config=cfg)
        (_, st), secs = timed(lambda: tr.transform_batch(test, card_index, y_ref, k=k,
                                                         perplexity=30.0, config=cfg))
        print(json.dumps(dict(set="transform", index="exact", batch_size=batch,
                              rows_per_s=test.shape[0] / secs, seconds=secs,
                              mean_steps=float(st.n_steps.mean()))), flush=True)


def enter_device(dev: torch.device) -> None:
    with torch.cuda.device(dev):
        pass


def run_wrappers() -> None:
    """Each wrapper (the call the main path makes) at the main
    path's shapes on random inputs: CUDA-event ms of back-to-back calls and
    the host's microseconds a call (perf_counter over calls enqueued with
    no sync), and the host cost of the launch's pieces.  Times the port on
    sys.path: run it once with --src of another checkout to compare."""
    import time
    from repro_torch.core import fft_repulsion as fr
    from repro_torch.core import morton
    from repro_torch.kernels import build, ops
    print(f"wrappers of {Path(ops.__file__).resolve().parents[1]}", flush=True)
    build.build_all()
    gen = torch.Generator().manual_seed(0)
    n, dev = 70_000, torch.device("cuda", 0)
    q = torch.randn((4096, 784), generator=gen).cuda()
    c = torch.randn((8192, 784), generator=gen).cuda()
    d2 = (torch.randn((n, 90), generator=gen).abs() * 4).cuda()
    y = (torch.randn((n, 2), generator=gen) * 20).cuda()
    cent, r_span = morton.span_radius(y)
    cols = torch.randint(0, n, (n, 160), generator=gen, dtype=torch.int32).cuda()
    vals = torch.rand((n, 160), generator=gen).cuda() / (n * 160)
    p_len = torch.randint(0, 160, (n,), generator=gen, dtype=torch.int32).cuda()
    base, wx, wy, _ = fr.interp_coords(y, 48)
    charges = fr.point_charges(y)
    nodes = fr.lattice_nodes(48)
    pot = torch.randn((nodes, nodes, 4), generator=gen).cuda()
    calls = {
        "pairwise_sq_dists": lambda: ops.pairwise_sq_dists(q, c),
        "bsp_search": lambda: ops.bsp_search(d2, 30.0),
        "morton_encode": lambda: ops.morton_encode(y, cent, r_span),
        "attractive_ell": lambda: ops.attractive_ell(y, cols, vals, p_len),
        "fft_spread": lambda: ops.fft_spread(base, wx, wy, charges, nodes),
        "fft_gather": lambda: ops.fft_gather(pot, base, wx, wy),
    }
    if hasattr(ops, "bh_traverse"):
        from repro_torch.core import quadtree, summarize
        codes_s, y_s, _ = quadtree.sort_points_by_code(y, ops.morton_encode(y, cent, r_span))
        tree = quadtree.build_quadtree(codes_s)
        summ = summarize.summarize(tree, y_s, r_span)
        calls["bh_traverse"] = lambda: ops.bh_traverse(y_s, tree, summ, 0.5)
    pieces = {
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "with torch.cuda.device(dev): pass": lambda: enter_device(dev),
        "torch.empty((n, 4), device=dev)": lambda: torch.empty((n, 4), device=dev),
        "tensor.data_ptr()": pot.data_ptr,
        "tensor.device": lambda: pot.device,
    }

    def host_us(fn, calls_a_rep: int) -> float:
        times = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls_a_rep):
                fn()
            times.append((time.perf_counter() - t0) / calls_a_rep * 1e6)
            torch.cuda.synchronize()
        return float(np.median(times))

    if hasattr(ops, "_ENTRIES"):      # a launch path that binds each C entry once
        entry = ops._entry("gather")
        phi = torch.empty((n, 4), device=dev)
        args = (pot.data_ptr(), base.data_ptr(), wx.data_ptr(), wy.data_ptr(), phi.data_ptr(),
                n, nodes)
        pieces.update({
            "torch._C._cuda_getCurrentRawStream(0)": lambda: torch._C._cuda_getCurrentRawStream(0),
            "ops.fft_gather_cuda (no input checks)": lambda: ops.fft_gather_cuda(pot, base, wx, wy),
            "C entry, launch included": lambda: entry(*args, stream),
            "C entry, n = 0 (ctypes alone)": lambda: entry(*args[:5], 0, nodes, stream),
        })
        stream = torch._C._cuda_getCurrentRawStream(0)
    for name, fn in pieces.items():
        print(json.dumps(dict(piece=name, host_us=host_us(fn, 1000))), flush=True)
    for name, fn in calls.items():
        inner = 5 if name in ("pairwise_sq_dists", "bsp_search") else 100
        print(json.dumps(dict(wrapper=name, ms=event_ms(fn, reps=21, inner=inner),
                              host_us=host_us(fn, inner))), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sets",
                    default="pairwise,attractive,spread,bsp,gather,knn,traverse,wrappers,"
                            "neighbors,transform",
                    help="comma-separated sets (pairwise, attractive, spread, bsp, gather, "
                         "knn, traverse, wrappers, neighbors, transform)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="root of another checkout whose spread.cu, bsp.cu and gather.cu "
                         "are timed beside")
    ap.add_argument("--src", type=Path, default=None,
                    help="root of another checkout whose port the wrappers set times")
    args = ap.parse_args()
    sets = args.sets.split(",")
    if args.src is not None:
        sys.path.insert(0, str(args.src.resolve() / "src"))
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.data.datasets import make_dataset

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    if "wrappers" in sets:
        run_wrappers()
    if "neighbors" in sets:
        run_neighbors()
    if "transform" in sets:
        run_transform()
    if not set(sets) & {"pairwise", "attractive", "spread", "bsp", "gather", "knn",
                        "traverse"}:
        return
    x_np = make_dataset("mnist")[0]
    x = torch.as_tensor(x_np).cuda()
    if "pairwise" in sets:
        run_pairwise(x, stream)
    if "attractive" in sets:
        run_attractive(x, stream)
    if "bsp" in sets:
        run_bsp(x, stream, args.baseline)
    if "knn" in sets:
        run_knn(x)
    if "traverse" in sets:
        run_traverse(x_np, stream, args.baseline)
    if "spread" in sets:
        run_spread(x_np, stream, args.baseline)
    if "gather" in sets:
        run_gather(x_np, stream, args.baseline)


if __name__ == "__main__":
    main()
