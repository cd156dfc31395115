"""Time edited variants of the port's CUDA kernels side by side on one GPU.

    python3 chip_variants.py                       # every set
    python3 chip_variants.py --sets spread         # one set
    python3 chip_variants.py --sets spread --spread-baseline DIR

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
the device (torch.profiler, the kernel alone) and by CUDA events.  With
``--spread-baseline DIR`` the spread.cu of another checkout (unpacked at
DIR, e.g. the parent commit's, whose C entry takes no plan and adds into a
zeroed grid) is timed on the same inputs, its zeroing separately.

Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
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


def spread_inputs(x_np: np.ndarray) -> dict:
    """name -> (base, wx, wy, charges, nodes) on the card: the FFT fit's
    embedding (chip_smoke.py's fit, 48 boxes), a random one at 48 and 128
    boxes, the random one with one point moved 1e4 away (every other point
    in the lattice's first band), and no points at all."""
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
    return out


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sets", default="pairwise,attractive,spread",
                    help="comma-separated kernel sets (pairwise, attractive, spread)")
    ap.add_argument("--spread-baseline", type=Path, default=None,
                    help="root of another checkout whose spread.cu is timed beside")
    args = ap.parse_args()
    sets = args.sets.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.data.datasets import make_dataset

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    x_np = make_dataset("mnist")[0]
    x = torch.as_tensor(x_np).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    if "pairwise" in sets:
        run_pairwise(x, stream)
    if "attractive" in sets:
        run_attractive(x, stream)
    if "spread" in sets:
        run_spread(x_np, stream, args.spread_baseline)


if __name__ == "__main__":
    main()
