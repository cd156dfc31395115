"""The port's EmbeddingService, traced transform and launcher against the
JAX package.

A JAX fit saved by ``repro.api.TSNE.save`` is loaded by the port on the
CPU; both packages' services serve the same requests.  The reference's
own service tests (``tests/test_transform.py``) are ported beside them.
Inputs are made from a seed with numpy; every tolerance is stated with
its reason.
"""
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.api import TSNE as JTSNE  # noqa: E402
from repro.data.datasets import make_dataset as jmake_dataset  # noqa: E402
from repro.embed.service import (  # noqa: E402
    EmbeddingService as JEmbeddingService, TransformRequest as JTransformRequest,
)
from repro_torch import obs  # noqa: E402
from repro_torch.api import TSNE, EmbeddingService, TransformConfig, TransformRequest  # noqa: E402
from repro_torch.embed.transform import RETRACE_PROBE, transform_batch  # noqa: E402
from repro_torch.launch import tsne_run  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def digits_split():
    """The train/held-out split of the reference's tests/test_transform.py."""
    x, labels = jmake_dataset("digits", n=700)
    return (x[:600], labels[:600]), (x[600:], labels[600:])


@pytest.fixture(scope="module")
def jax_model(digits_split, tmp_path_factory):
    """The reference's ``fitted`` model (a JAX fit of the 600 training
    rows) and the npz its save() wrote."""
    (train_x, _), _ = digits_split
    est = JTSNE(perplexity=12.0, n_iter=250, kl_every=125, random_state=0)
    est.fit(train_x)
    path = tmp_path_factory.mktemp("jax_model") / "digits.npz"
    est.save(path)
    return est, path


@pytest.fixture(scope="module")
def fitted(jax_model):
    """The port's estimator, loaded on the CPU from the JAX file."""
    return TSNE.load(jax_model[1], device="cpu")


def submit_rows(service, request_cls, rows, dataset="digits", rid0=0):
    for i, x in enumerate(rows):
        service.submit(request_cls(rid=rid0 + i, dataset=dataset, x=x))


def by_rid(done):
    return sorted(done, key=lambda r: r.rid)


# ------------------------------------------------ against the reference ---

def test_service_matches_the_jax_service(digits_split, jax_model, fitted):
    _, (test_x, _) = digits_split
    ours = EmbeddingService(slots=8, max_k=48, device="cpu")
    ours.add_model("digits", fitted)
    ref = JEmbeddingService(slots=8, max_k=48)
    ref.add_model("digits", jax_model[0])
    submit_rows(ours, TransformRequest, test_x[:32])
    submit_rows(ref, JTransformRequest, test_x[:32])
    done, done_ref = by_rid(ours.run()), by_rid(ref.run())
    assert [r.rid for r in done] == list(range(32)) == [r.rid for r in done_ref]
    # The same admissions in the same order and one-step descents that
    # agree to float order: every point within 1e-5 of the span, the bar
    # of the batch transform's parity test (test_torch_transform.py).
    # Measured: 6.4e-6 at most on a span of 11.9.
    span = float(np.ptp(fitted.embedding_))
    y, y_ref = np.stack([r.y for r in done]), np.stack([r.y for r in done_ref])
    assert np.abs(y - y_ref).max() <= 1e-5 * span
    # Retirement reads each step's gradient norm against min_grad_norm
    # (1e-5).  Near a point's equilibrium that norm is a cancelling sum of
    # K terms of order 1, and the two packages' fp32 sums of the same row
    # differ by up to ~7e-6 (measured at retirement), so a row whose norm
    # crosses 1e-5 within that noise retires a few steps apart (4 of 32
    # rows here, 1-3 steps).  Bar: equal steps on >= 80% of the rows, a
    # mean within one step, and the pool's ticks within 10%.
    steps = np.array([r.n_steps for r in done])
    steps_ref = np.array([r.n_steps for r in done_ref])
    assert (steps == steps_ref).mean() >= 0.8
    assert abs(steps.mean() - steps_ref.mean()) <= 1.0
    s, s_ref = ours.stats(), ref.stats()
    assert set(s) == set(s_ref)
    for key in ("completed", "slot_occupancy_max", "queue_depth_max"):
        assert s[key] == s_ref[key], key
    assert abs(s["ticks"] - s_ref["ticks"]) <= 0.1 * s_ref["ticks"]
    assert s["recompiles"]["recompiles.transform_step"] >= 1


# -------------------------------------------- the reference's own tests ---

def test_drains_32_requests_through_8_slots(digits_split, fitted):
    _, (test_x, _) = digits_split
    service = EmbeddingService(slots=8, max_k=48, device="cpu")
    service.add_model("digits", fitted)
    submit_rows(service, TransformRequest, test_x[:32])
    done = service.run()
    assert len(done) == 32
    for req in done:
        assert req.done and req.y is not None and np.isfinite(req.y).all()
        assert req.n_steps >= 1 and np.isfinite(req.grad_norm)
        assert req.latency_s > 0 and req.service_s > 0
    s = service.stats()
    assert s["completed"] == 32 and s["queued"] == 0
    assert s["latency_s_p50"] <= s["latency_s_p95"] <= s["latency_s_p99"] <= s["latency_s_max"]
    assert s["slot_occupancy_max"] == 8 and 1 <= s["queue_depth_max"] <= 32
    m = service.metrics
    assert m.counter("service.completed").value == 32
    assert m.counter("service.ticks").value == s["ticks"]
    assert m.histogram("service.latency_s").count == 32
    assert m.gauge("service.queue_depth").value == 0
    assert m.gauge("service.slot_occupancy").value == 0
    # the reference's bar: service results agree with the batch transform
    y_batch = fitted.transform(test_x[:32])
    y_srv = np.stack([r.y for r in by_rid(done)])
    assert np.linalg.norm(y_srv - y_batch, axis=1).max() < 0.1


def test_multi_dataset_cache(digits_split, fitted):
    _, (test_x, _) = digits_split
    x2, _ = jmake_dataset("mnist", n=160)
    service = EmbeddingService(slots=4, max_k=48, device="cpu")
    service.add_model("digits", fitted)
    model = service.fit_dataset("mnist_small", x2[:140], perplexity=8.0, n_iter=80,
                                kl_every=40, random_state=1)
    assert model.device == torch.device("cpu")
    assert service.models() == ("digits", "mnist_small")
    for i in range(6):
        service.submit(TransformRequest(rid=i, dataset="digits", x=test_x[i]))
        service.submit(TransformRequest(rid=100 + i, dataset="mnist_small", x=x2[140 + i]))
    done = service.run()
    assert len(done) == 12
    assert {r.dataset for r in done} == {"digits", "mnist_small"}
    assert all(np.isfinite(r.y).all() for r in done)


def test_submit_unknown_dataset_raises():
    service = EmbeddingService(slots=2, device="cpu")
    with pytest.raises(ValueError, match="unknown dataset"):
        service.submit(TransformRequest(rid=0, dataset="nope", x=np.zeros(4)))


def test_unfitted_model_rejected():
    service = EmbeddingService(slots=2, device="cpu")
    with pytest.raises(ValueError, match="not fitted"):
        service.add_model("raw", TSNE(device="cpu"))


def test_model_on_another_device_rejected(jax_model):
    model = TSNE.load(jax_model[1], device="cpu")
    model.device = torch.device("cuda")          # as a model fitted on the card says
    with pytest.raises(ValueError, match="runs on cuda"):
        EmbeddingService(slots=2, device="cpu").add_model("digits", model)


def test_step_on_empty_pool_is_false():
    service = EmbeddingService(slots=2, device="cpu")
    assert service.step() is False
    assert service.stats() == dict(completed=0, ticks=0, recompiles=service.stats()["recompiles"])


def test_load_model_from_save(digits_split, fitted, tmp_path):
    _, (test_x, _) = digits_split
    path = tmp_path / "m.npz"
    fitted.save(path)
    service = EmbeddingService(slots=2, max_k=48, device="cpu")
    service.load_model("digits", path)
    service.submit(TransformRequest(rid=0, dataset="digits", x=test_x[0]))
    done = service.run()
    assert len(done) == 1 and np.isfinite(done[0].y).all()


def test_submits_from_a_second_thread_while_run_drains(digits_split, fitted):
    # submit() runs on a second thread while the engine thread drains: no
    # request may be lost or completed twice (the queue and the completed
    # list are shared under the service's lock)
    _, (test_x, _) = digits_split
    service = EmbeddingService(slots=4, max_k=48, device="cpu")
    service.add_model("digits", fitted)
    submit_rows(service, TransformRequest, test_x[:4])

    def submit_rest():
        for i in range(4, 40):
            service.submit(TransformRequest(rid=i, dataset="digits", x=test_x[i]))
            time.sleep(0.002)

    submitter = threading.Thread(target=submit_rest)
    done = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        submitter.start()
        deadline = time.monotonic() + 120
        while len(done) < 40 and time.monotonic() < deadline:
            done += service.run()
            time.sleep(0.001)
    finally:
        sys.setswitchinterval(interval)
        submitter.join(timeout=60)
    assert not submitter.is_alive()
    assert sorted(r.rid for r in done) == list(range(40))
    assert service.stats()["completed"] == 40 and not service.queue
    assert all(r.done and np.isfinite(r.y).all() for r in done)


def test_smoke_entry_point_writes_a_trace(tmp_path):
    path = tmp_path / "service_trace.json"
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin:/usr/local/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.embed.service", "--smoke", "--device", "cpu",
         "--trace", str(path)], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "smoke OK on cpu" in out.stdout
    doc = json.loads(path.read_text())
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"fit", "knn", "service.admit", "service.tick"} <= names


# ------------------------------------------------- the traced transform ---

def test_transform_batch_spans_and_one_step_shape(digits_split, fitted):
    _, (test_x, _) = digits_split
    x = np.concatenate([test_x, test_x, test_x])[:200]
    cfg = TransformConfig(n_iter=20, check_every=10, batch_size=128)
    y_ref = torch.as_tensor(np.asarray(fitted.embedding_, np.float32))
    kw = dict(k=fitted.query_k_, perplexity=fitted.perplexity, config=cfg)
    transform_batch(torch.as_tensor(x[:3]), fitted.query_index_, y_ref, **kw)
    count, calls = RETRACE_PROBE.count, RETRACE_PROBE.calls
    tracer = obs.Tracer()
    for m in (3, 128, 200):
        y, _ = transform_batch(torch.as_tensor(x[:m]), fitted.query_index_, y_ref,
                               tracer=tracer, **kw)
        assert y.shape == (m, 2) and np.isfinite(y).all()
    assert RETRACE_PROBE.count == count          # one [128, K] step shape throughout
    assert RETRACE_PROBE.calls > calls
    assert [s.name for s in tracer.spans if s.depth == 0] == ["transform"] * 3
    assert len(tracer.find("transform.prepare")) == len(tracer.find("transform.descend")) \
        == 1 + 1 + 2
    outer = {s.index for s in tracer.find("transform")}
    assert all(s.parent in outer and s.depth == 1 for s in tracer.spans if s.depth)
    assert [s.attrs["rows"] for s in tracer.find("transform.prepare")] == [3, 128, 128, 72]


def test_estimator_transform_appends_to_the_fit_trace(digits_split):
    (train_x, _), (test_x, _) = digits_split
    est = TSNE(perplexity=10.0, n_iter=30, kl_every=30, random_state=0, trace=True,
               device="cpu").fit(train_x[:300])
    est.transform(test_x[:5])
    names = [s.name for s in est.tracer_.spans]
    assert names.index("fit") < names.index("transform")


# ---------------------------------------------------------- the launcher ---

def test_tsne_run_on_digits(tmp_path, capsys):
    out = tmp_path / "emb.npy"
    tsne_run.main(["--dataset", "digits", "--n", "300", "--iters", "60", "--perplexity",
                   "10", "--device", "cpu", "--out", str(out)])
    emb = np.load(out)
    assert emb.shape == (300, 2) and np.isfinite(emb).all()
    assert "KL=" in capsys.readouterr().out


def test_tsne_run_refuses_several_devices():
    with pytest.raises(SystemExit, match="item 5"):
        tsne_run.main(["--devices", "2", "--device", "cpu"])
