"""knn_s: seconds of the fit's ``knn`` span (``TSNE.timings_``, the card
synchronised at its exit), mean over the window's fits."""
UNIT = "s"


def read(run):
    spans = [u["timings"]["knn"] for u in run.units if "timings" in u]
    return sum(spans) / len(spans) if spans else None
