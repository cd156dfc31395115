"""descent_ms.fit: milliseconds a descent step, the fit's
``gradient_descent`` span over its ``n_iter_``, mean over the window's fits."""
UNIT = "ms"


def read(run):
    per = [u["timings"]["gradient_descent"] / u["steps"] * 1e3
           for u in run.units if "timings" in u and u["steps"]]
    return sum(per) / len(per) if per else None
