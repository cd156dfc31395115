"""Time edited variants of the port's CUDA kernels side by side on one GPU.

    python3 chip_variants.py

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
error is expected to fail the tolerance.  Needs a CUDA device; exits
non-zero without one.
"""
from __future__ import annotations

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


def build_variants(source: str, variants: dict) -> dict:
    """name -> (ctypes library, registers reported by ptxas -v)."""
    from repro_torch.kernels import build
    text = (build.CSRC / f"{source}.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        edited = text
        for old, new in edits:
            if old not in edited:
                raise SystemExit(f"variant {source}/{name}: {old!r} not in the source")
            edited = edited.replace(old, new)
        cu = OUT / f"{source}-{name}.cu"
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
        libs[name] = (ctypes.CDLL(str(OUT / f"{source}-{name}.so")), regs)
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import _pairwise, attractive, knn, similarity
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    x = torch.as_tensor(make_dataset("mnist")[0]).cuda()
    n, d = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int

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


if __name__ == "__main__":
    main()
