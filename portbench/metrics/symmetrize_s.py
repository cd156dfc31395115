"""symmetrize_s: seconds of the fit's ``symmetrize`` span (host numpy),
mean over the window's fits."""
UNIT = "s"


def read(run):
    spans = [u["timings"]["symmetrize"] for u in run.units if "timings" in u]
    return sum(spans) / len(spans) if spans else None
