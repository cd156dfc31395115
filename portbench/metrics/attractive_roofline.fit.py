"""attractive_roofline.fit: percent of its roofline that the attractive
force kernel (``csrc/attractive.cu``) reaches over one traced fit.

Bytes of one launch, counted once from the reference's P of the traced
fit's input: each real entry's 4-byte column and 4-byte value, the n row
lengths (4 bytes), y read (8 bytes a point), the force (8) and the row's
KL term (4) written.  Time: the mean device time of the kernel's
launches in the traced fit."""
from portbench import common

UNIT = "%"
KERNEL = "attractive_kernel"


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernel_seconds(KERNEL)
    if not times or "nnz" not in run.ref:
        return None
    n = run.ref["n"]
    nbytes = 8.0 * run.ref["nnz"] + (4.0 + 8.0 + 8.0 + 4.0) * n
    bound_ms, _ = common.bound(0.0, nbytes)
    return 100.0 * bound_ms * 1e-3 / (sum(times) / len(times))
