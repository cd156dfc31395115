"""pairwise_roofline.fit: percent of its roofline that the KNN distance
kernel (``csrc/pairwise.cu``) reaches over one traced fit.

Work, counted from the inputs: the n x n distances of n points of d
dimensions, 2 n^2 d FLOPs at the TF32 tensor-core peak (the kernel's
3xTF32 products do three TF32 products for each; they are not counted),
against the bytes of reading the points once and writing k neighbours a
row; the larger time is the bound.  Time: the summed device time of
every launch of the kernel in the traced fit."""
from portbench import common

UNIT = "%"
KERNEL = "pairwise_kernel"


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernel_seconds(KERNEL)
    if not times:
        return None
    n, d = run.ref["n"], run.ref["dim"]
    k = min(int(3 * run.cell.config["perplexity"]), n - 1)
    bound_ms, _ = common.bound(2.0 * n * n * d, 4.0 * n * d + 8.0 * n * k,
                               peak=common.PEAK_TF32_FLOPS)
    return 100.0 * bound_ms * 1e-3 / sum(times)
