"""The port's observability layer against the JAX package's.

Tracer, metrics registry and step probe are driven with the same inputs
in both packages (an injected clock for the tracer) and must give equal
records; a traced fit of the port on the CPU must have the reference's
span tree.  Inputs are made from a seed with numpy.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.api import TSNE as JTSNE  # noqa: E402
from repro.data.datasets import make_dataset as jmake_dataset  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.api import TSNE  # noqa: E402
from repro_torch.embed.transform import TransformState  # noqa: E402
from repro_torch.obs.tracer import cuda_devices  # noqa: E402


def counting_clock():
    """A clock that returns 0.0, 0.5, 1.0, ...: every read advances it."""
    state = {"t": -0.5, "reads": 0}

    def clock():
        state["t"] += 0.5
        state["reads"] += 1
        return state["t"]
    return clock, state


def drive(tracer):
    """One span sequence: nesting, attributes, annotate, a sibling root."""
    with tracer.span("fit", n=260, method="barnes_hut"):
        with tracer.span("knn", backend="exact", k=24) as sp:
            sp.annotate(mean_d2=1.25)
        with tracer.span("gradient_descent", lr=50.0):
            with tracer.span("early_exaggeration", start_iter=0, exaggeration=12.0):
                with tracer.span("checkpoint", iteration=30, kl=2.5):
                    pass
    with tracer.span("transform", m=3, impl=None):
        pass
    return tracer


# -------------------------------------------------------------- tracer ------

def test_tracer_records_as_the_reference():
    ours = drive(obs.Tracer(clock=counting_clock()[0]))
    ref = drive(jobs.Tracer(clock=counting_clock()[0]))
    assert [s.to_dict() for s in ours.spans] == [s.to_dict() for s in ref.spans]
    assert ours.chrome_trace("tsne.fit") == ref.chrome_trace("tsne.fit")
    assert ours.durations() == ref.durations()
    assert ours.last("checkpoint").to_dict() == ref.last("checkpoint").to_dict()
    assert [s.index for s in ours.find("fit")] == [s.index for s in ref.find("fit")]


def test_jsonl_as_the_reference(tmp_path):
    drive(obs.Tracer(clock=counting_clock()[0])).to_jsonl(tmp_path / "ours.jsonl")
    drive(jobs.Tracer(clock=counting_clock()[0])).to_jsonl(tmp_path / "ref.jsonl")
    ours = [json.loads(ln) for ln in (tmp_path / "ours.jsonl").read_text().splitlines()]
    assert ours == [json.loads(ln) for ln in (tmp_path / "ref.jsonl").read_text().splitlines()]
    assert [d["name"] for d in ours][:2] == ["knn", "checkpoint"]


def test_disabled_tracer_is_a_shared_noop():
    clock, state = counting_clock()
    t = obs.Tracer(enabled=False, clock=clock)
    reads = state["reads"]
    ctx = t.span("anything", n=3)
    assert ctx is obs.NULL_SPAN
    with ctx as sp:
        sp.annotate(a=1)
        x = torch.ones(3)
        assert sp.sync(x) is x
    assert state["reads"] == reads            # no clock read
    assert t.spans == [] and t.durations() == {}


def test_sync_on_cpu_tensors_needs_no_device(monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("a CPU tensor must not synchronise a device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    state = TransformState(y=torch.zeros(4, 2), velocity=torch.zeros(4, 2),
                           gains=torch.ones(4, 2))
    t = obs.Tracer()
    with t.span("step") as sp:
        assert sp.sync(state) is state
        sp.sync({"a": [torch.ones(2), (torch.zeros(1), 3)]})
    assert t.last("step").duration_s >= 0
    assert cuda_devices(state) == set() and cuda_devices([state, {"x": 1}]) == set()


@pytest.mark.parametrize("value,want", [("", False), ("0", False), ("false", False),
                                        ("off", False), ("1", True), ("yes", True),
                                        (None, False)])
def test_env_gate(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("TSNE_TRACE", raising=False)
    else:
        monkeypatch.setenv("TSNE_TRACE", value)
    assert obs.env_trace_enabled() is want is jobs.env_trace_enabled()


def test_global_tracer_reaches_an_untraced_estimator():
    x, _ = jmake_dataset("digits", n=120)
    before = obs.get_tracer()
    try:
        g = obs.set_tracer(obs.Tracer())
        with obs.trace("outer"):
            est = TSNE(perplexity=5.0, n_iter=10, kl_every=5, random_state=0,
                       device="cpu").fit(x)
        assert est.tracer_ is g and est.metrics_ is obs.get_metrics()
        assert g.last("fit").parent == g.last("outer").index
    finally:
        obs.set_tracer(before)


# ------------------------------------------------------------- metrics ------

def observe(m, seed):
    rng = np.random.default_rng(seed)
    for v in rng.integers(0, 5, 20):
        m.counter(f"c{v % 3}").inc(int(v))
    for v in rng.normal(size=30):
        m.gauge("depth").set(float(v))
    for v in rng.exponential(size=5000):
        m.histogram("latency_s").observe(float(v))     # past the 4 096 reservoir
    for v in rng.normal(size=10):
        m.histogram("small", max_samples=4).observe(float(v))
    return m


def test_metrics_snapshot_and_merge_as_the_reference():
    ours, ref = observe(obs.MetricsRegistry(), 0), observe(jobs.MetricsRegistry(), 0)
    assert ours.snapshot() == ref.snapshot()
    ours.merge(observe(obs.MetricsRegistry(), 1))
    ref.merge(observe(jobs.MetricsRegistry(), 1))
    assert ours.snapshot() == ref.snapshot()
    assert ours.counter_values("c") == ref.counter_values("c")
    h, hr = ours.histogram("latency_s"), ref.histogram("latency_s")
    assert h.percentile(99) == hr.percentile(99) and h.mean == hr.mean
    json.dumps(ours.snapshot())


# ------------------------------------------------------ step probe ----------

def test_recompile_probe_counts_as_the_reference():
    ours = obs.RecompileProbe("f", registry=obs.MetricsRegistry())
    ref = jobs.RecompileProbe("f", registry=jobs.MetricsRegistry())
    keys = [((128, 2), (128, 90), 0.5, 0.01)] * 3 + [((64, 2), (64, 96), 0.5, 0.01),
                                                      ((128, 2), (128, 90), 0.5, 0.01)]
    for key in keys:
        ours.record(*key)
        ref.record(*key)
    assert ours.count == ref.count == 2 and ours.keys == ref.keys
    assert ours.calls == len(keys)               # every call of the port's step
    assert ours._counter.value == 2
    ours.reset()
    assert ours.count == 0 and ours.calls == 0


# --------------------------------------------------------- traced fit -------

# the reference's TestTracedFit configuration; the second case reaches the
# main phase
FIT_CASES = {"default": {}, "main_phase": {"exaggeration_iters": 30,
                                           "momentum_switch_iter": 30}}


@pytest.fixture(scope="module", params=sorted(FIT_CASES))
def traced_fits(request, tmp_path_factory):
    x, _ = jmake_dataset("digits", n=260)
    out = tmp_path_factory.mktemp("obs")
    kw = dict(perplexity=8.0, n_iter=60, kl_every=30, random_state=0,
              backend_options=FIT_CASES[request.param])
    ours = TSNE(trace=str(out / "ours.json"), device="cpu", **kw).fit(x)
    ref = JTSNE(trace=str(out / "ref.json"), **kw).fit(x)
    return ours, ref, out / "ours.json"


def span_tree(tracer):
    by_index = {s.index: s for s in tracer.spans}
    return [(s.name, s.depth, by_index[s.parent].name if s.parent >= 0 else None)
            for s in tracer.spans]


def test_traced_fit_has_the_reference_span_tree(traced_fits):
    ours, ref, _ = traced_fits
    assert span_tree(ours.tracer_) == span_tree(ref.tracer_)
    assert [s.attrs["iteration"] for s in ours.tracer_.find("checkpoint")] == \
        [s.attrs["iteration"] for s in ref.tracer_.find("checkpoint")]
    fit = ours.tracer_.last("fit")
    for child in ("knn", "bsp", "symmetrize", "gradient_descent"):
        sp = ours.tracer_.last(child)
        assert sp.parent == fit.index and sp.depth == 1 and sp.duration_s > 0
    assert set(ours.tracer_.last("knn").attrs) == set(ref.tracer_.last("knn").attrs)
    assert set(ours.tracer_.last("checkpoint").attrs) == \
        set(ref.tracer_.last("checkpoint").attrs)


def test_traced_fit_timings_are_the_span_durations(traced_fits):
    ours, _, _ = traced_fits
    d = ours.tracer_.durations()
    for phase in ("knn", "bsp", "symmetrize", "gradient_descent"):
        assert ours.timings_[phase] == d[phase] > 0


def test_traced_fit_writes_a_chrome_trace_and_metrics(traced_fits):
    ours, ref, path = traced_fits
    doc = json.loads(path.read_text())
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"fit", "knn", "bsp", "symmetrize", "gradient_descent", "checkpoint"} <= names
    snap, ref_snap = ours.metrics_.snapshot(), ref.metrics_.snapshot()
    assert snap["fit.iterations"] == ours.n_iter_ == ref_snap["fit.iterations"]
    assert set(snap) == set(ref_snap)
    assert snap["fit.grad_norm"]["count"] == ref_snap["fit.grad_norm"]["count"] == 2


def test_untraced_fit_has_timings_but_no_tracer():
    x, _ = jmake_dataset("digits", n=200)
    est = TSNE(perplexity=6.0, n_iter=30, kl_every=30, random_state=0, device="cpu").fit(x)
    assert est.tracer_ is None and est.metrics_ is None
    for phase in ("knn", "bsp", "symmetrize", "gradient_descent"):
        assert est.timings_[phase] > 0
