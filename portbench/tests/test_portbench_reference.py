"""The benchmark's plain reference and its counts against brute-force NumPy
at tiny N, on the CPU."""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import common  # noqa: E402
from portbench.harness import BENCH_DIR, Run, load_module  # noqa: E402
from portbench.reference import tsne_ref as ref  # noqa: E402


def points(n=60, d=5, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d))


def brute_knn(x, k):
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d2, idx, 1)


def brute_p(d2, perplexity):
    """p_{j|i} by a scalar bisection a row, in float64."""
    out = np.zeros_like(d2)
    for i, row in enumerate(d2):
        lo, hi = 0.0, np.inf
        beta = 1.0
        for _ in range(200):
            p = np.exp(-(row - row.min()) * beta)
            h = np.log(p.sum()) + beta * ((row - row.min()) * p).sum() / p.sum()
            if h > math.log(perplexity):
                lo = beta
                beta = beta * 2 if np.isinf(hi) else (lo + hi) / 2
            else:
                hi = beta
                beta = (lo + hi) / 2
        out[i] = p / p.sum()
    return out


def dense_p(idx, cond):
    n = idx.shape[0]
    p = np.zeros((n, n))
    for i in range(n):
        p[i, idx[i]] = cond[i]
    p = (p + p.T) / (2 * n)
    return p / p.sum()


def test_knn_matches_brute_force():
    x = points()
    idx, d2 = ref.knn(torch.as_tensor(x), 7)
    bi, bd = brute_knn(x, 7)
    assert np.array_equal(idx.numpy(), bi)
    np.testing.assert_allclose(d2.numpy(), bd, rtol=1e-12)
    rows = torch.tensor([3, 17, 40])
    ri, rd = ref.knn(torch.as_tensor(x), 7, rows=rows)
    assert np.array_equal(ri.numpy(), bi[[3, 17, 40]])


def test_conditional_p_and_symmetric_p_match_brute_force():
    x = points()
    bi, bd = brute_knn(x, 12)
    cond = ref.conditional_p(torch.as_tensor(bd), 4.0)
    np.testing.assert_allclose(cond.numpy(), brute_p(bd, 4.0), rtol=1e-9, atol=1e-12)
    h = -(cond * torch.log(cond)).sum(1)
    np.testing.assert_allclose(h.numpy(), math.log(4.0), atol=1e-9)
    keys, vals = ref.symmetrize(torch.as_tensor(bi), cond, x.shape[0])
    p = dense_p(bi, cond.numpy())
    nz = np.flatnonzero(p.reshape(-1))
    assert np.array_equal(keys.numpy(), nz)
    np.testing.assert_allclose(vals.numpy(), p.reshape(-1)[nz], rtol=1e-12)


def test_l1_and_ell_entries():
    n = 5
    cols = torch.tensor([[1, 2, 0], [0, 1, 1], [0, 3, 2], [2, 3, 3], [0, 4, 4]])
    vals = torch.tensor([[.1, .2, 0.], [.1, 0., 0.], [.2, .1, 0.], [.1, 0., 0.], [.2, 0., 0.]])
    lens = torch.tensor([2, 1, 2, 1, 1])
    rows, c, v = ref.ell_entries(cols, vals, lens)
    assert rows.tolist() == [0, 0, 1, 2, 2, 3, 4]
    assert c.tolist() == [1, 2, 0, 0, 3, 2, 0]
    keys = rows * n + c
    dense = np.zeros(n * n)
    dense[keys.numpy()] = v.numpy()
    other = dense.copy()
    other[7] += 0.05
    other[24] = 0.3
    ok = np.flatnonzero(other)
    got = ref.l1(keys, v, torch.as_tensor(ok), torch.as_tensor(other[ok]))
    assert got == pytest.approx(np.abs(dense - other).sum(), rel=1e-12)


def test_exact_forces_z_kl_and_step_match_dense_numpy():
    rng = np.random.default_rng(1)
    n = 50
    y = rng.normal(size=(n, 2)) * 3
    bi, bd = brute_knn(points(n), 8)
    p = dense_p(bi, brute_p(bd, 3.0))
    d2 = ((y[:, None] - y[None]) ** 2).sum(-1)
    w = 1 / (1 + d2)
    np.fill_diagonal(w, 0)
    z = w.sum()
    diff = y[:, None] - y[None]
    f_attr = ((p * w)[:, :, None] * diff).sum(1)
    f_rep = ((w * w)[:, :, None] * diff).sum(1)
    kl = (p[p > 0] * np.log(p[p > 0] / (w[p > 0] / z))).sum()

    yt = torch.as_tensor(y)
    nz = np.flatnonzero(p.reshape(-1))
    keys = torch.as_tensor(nz)
    vals = torch.as_tensor(p.reshape(-1)[nz])
    every = torch.arange(n)
    fa, kla = ref.attraction(yt, n, keys // n, keys % n, vals, every)
    fr = ref.repulsion_rows(yt, every)
    zt = ref.z_all(yt)
    np.testing.assert_allclose(fa.numpy(), f_attr, rtol=1e-10, atol=1e-15)
    np.testing.assert_allclose(fr.numpy(), f_rep, rtol=1e-10, atol=1e-15)
    assert float(zt) == pytest.approx(z, rel=1e-12)
    assert ref.kl(vals, kla, zt) == pytest.approx(kl, rel=1e-10)
    some = torch.tensor([2, 9, 33])
    np.testing.assert_allclose(ref.repulsion_rows(yt, some).numpy(), f_rep[[2, 9, 33]],
                               rtol=1e-10)
    grad = ref.gradient(fa, fr, zt, 12.0)
    np.testing.assert_allclose(grad.numpy(), 4 * (12.0 * f_attr - f_rep / z), rtol=1e-10,
                               atol=1e-15)
    v = torch.as_tensor(rng.normal(size=(n, 2)))
    gains = torch.as_tensor(rng.uniform(0.5, 2, size=(n, 2)))
    new = ref.step_velocity(grad, v, gains, 100.0, 0.8, 0.01)
    g = grad.numpy()
    want_gains = np.where((g > 0) == (v.numpy() > 0), gains.numpy() * 0.8, gains.numpy() + 0.2)
    np.testing.assert_allclose(new.numpy(), 0.8 * v.numpy() - 100.0 * want_gains * g)


def test_recall_counts_found_neighbours():
    exact = torch.tensor([[1, 2, 3], [0, 2, 4]])
    support = torch.tensor([[3, 1, 9, 2], [4, 0, 7, 7]])
    lens = torch.tensor([2, 4])
    # row 0 finds 3 and 1 (2 is past its length), row 1 finds 4 and 0
    assert ref.recall(exact, support, lens) == pytest.approx(4 / 6)


def trace_of(device_ops, host_ops=(), window_s=1.0):
    return common.Trace(device=list(device_ops), host=list(host_ops), window_s=window_s)


def test_trace_union_gaps_and_ops():
    t = trace_of([("k1", 0, 100), ("k2", 50, 150), ("k1", 300, 400), ("copy", 1000, 1100)],
                 [("aten::add", 140, 320), ("numpy", 500, 900), ("aten::mm", 600, 700)])
    assert t.busy_intervals().tolist() == [[0, 150], [300, 400], [1000, 1100]]
    assert t.busy_s() == pytest.approx(350e-9)
    assert t.device_ops() == [["k1", pytest.approx(200e-9)], ["k2", pytest.approx(100e-9)],
                              ["copy", pytest.approx(100e-9)]]
    gaps = dict((k, v) for k, v in t.idle_gaps())
    # the 600 ns gap's middle (700) is inside aten::mm's end, the innermost cover
    assert gaps == {"aten::mm": pytest.approx(600e-9), "aten::add": pytest.approx(150e-9)}
    assert trace_of([]).busy_s() == 0.0


def metric(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py")


class _Cell:
    config = {"perplexity": 30.0}


def test_roofline_counts():
    n, d, nnz = 1000, 784, 50_000
    pair_s, attr_s = 0.004, 2e-6
    t = trace_of([("void pairwise_kernel<true>(...)", 0, int(pair_s * 1e9 / 2)),
                  ("void pairwise_kernel<true>(...)", 10**7, 10**7 + int(pair_s * 1e9 / 2)),
                  ("attractive_kernel(...)", 2 * 10**7, 2 * 10**7 + int(attr_s * 1e9)),
                  ("attractive_kernel(...)", 3 * 10**7, 3 * 10**7 + int(attr_s * 1e9))])
    run = Run(cell=_Cell(), units=[], trace=t, ref={"n": n, "dim": d, "nnz": nnz})
    flops = 2.0 * n * n * d
    assert metric("pairwise_roofline.fit").read(run) == pytest.approx(
        100 * flops / common.PEAK_TF32_FLOPS / pair_s)
    nbytes = 8.0 * nnz + 24.0 * n
    assert metric("attractive_roofline.fit").read(run) == pytest.approx(
        100 * nbytes / common.PEAK_HBM_BYTES / attr_s)
    empty = Run(cell=_Cell(), units=[], trace=trace_of([]), ref={"n": n, "dim": d})
    assert metric("pairwise_roofline.fit").read(empty) is None
    assert metric("attractive_roofline.fit").read(empty) is None
    assert metric("idle_share.fit").read(empty) is None


def test_span_metrics_are_means_over_the_window():
    units = [{"steps": 1000, "timings": {"knn": 0.4, "symmetrize": 3.0,
                                         "gradient_descent": 10.0}},
             {"steps": 500, "timings": {"knn": 0.6, "symmetrize": 4.0,
                                        "gradient_descent": 6.0}}]
    run = Run(cell=_Cell(), units=units, trace=None, ref={})
    assert metric("knn_s").read(run) == pytest.approx(0.5)
    assert metric("symmetrize_s").read(run) == pytest.approx(3.5)
    assert metric("descent_ms.fit").read(run) == pytest.approx(11.0)
    t = trace_of([("k", 0, 250_000_000)], window_s=1.0)
    assert metric("idle_share.fit").read(Run(_Cell(), [], t, {})) == pytest.approx(75.0)
