"""The port's pipeline against the JAX package, stage by stage and end to end.

Inputs are made from a seed with numpy and handed to both packages; the
port runs on the CPU (its plain kernel twins).  Every tolerance is stated
with its reason.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import TSNE as JTSNE  # noqa: E402
from repro.api import make_backend as jmake_backend  # noqa: E402
from repro.core import similarity as jsim  # noqa: E402
from repro.core import tsne as jtsne  # noqa: E402
from repro.core.knn import knn as jknn  # noqa: E402
from repro.data.datasets import make_dataset as jmake_dataset  # noqa: E402
from repro.neighbors import ExactNeighbors as JExactNeighbors  # noqa: E402
from repro.neighbors import recall_at_k as jrecall_at_k  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import (  # noqa: E402
    TSNE, BarnesHutBackend, ExactBackend, FFTBackend, TsneConfig, available_backends,
    make_backend, preprocess, run_tsne,
)
from repro_torch.core import attractive, similarity  # noqa: E402
from repro_torch.core.knn import knn  # noqa: E402
from repro_torch.core.tsne import bh_gradient, init_state, tsne_step  # noqa: E402
from repro_torch.data.datasets import make_dataset  # noqa: E402
from repro_torch.neighbors import (  # noqa: E402
    ExactNeighbors, available_neighbor_backends, make_neighbor_backend, recall_at_k,
)

ROOT = Path(__file__).resolve().parents[1]
T = torch.as_tensor


def make_points(n, seed=0, clusters=4, dim=2, std=0.2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, dim)) * 3.0
    lab = rng.integers(0, clusters, size=n)
    return (centers[lab] + rng.normal(size=(n, dim)) * std).astype(np.float32)


def dense(graph_cols, graph_vals):
    cols = np.asarray(graph_cols)
    vals = np.asarray(graph_vals, np.float64)
    n = cols.shape[0]
    p = np.zeros((n, n))
    np.add.at(p, (np.repeat(np.arange(n), cols.shape[1]), cols.reshape(-1)),
              vals.reshape(-1))
    return p


# ------------------------------------------------------------------ data ---

def test_datasets_identical_to_jax():
    for name, n in (("digits", 300), ("mnist", 50)):
        x, lab = make_dataset(name, n=n, seed=3)
        jx, jlab = jmake_dataset(name, n=n, seed=3)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(lab, jlab)


# ------------------------------------------------------------------- knn ---

@pytest.mark.parametrize("block_q,block_db", [(512, 2048), (64, 96)])
def test_knn_matches_jax(block_q, block_db):
    x = make_points(300, seed=41, dim=20)
    k = 15
    j_idx, j_d2 = jknn(jnp.asarray(x), k)
    idx, d2 = knn(T(x), k, block_q=block_q, block_db=block_db)
    assert idx.dtype == torch.int32 and idx.shape == (300, k)
    assert not (idx.numpy() == np.arange(300)[:, None]).any()
    # fp32 distance tiles in another order; ties may pick other indices,
    # so compare distances and recall, not indices
    np.testing.assert_allclose(d2.numpy(), np.asarray(j_d2), rtol=1e-4, atol=1e-4)
    assert recall_at_k(np.asarray(j_idx), idx.numpy()) >= 0.999
    # the exact neighbor backend of both packages on the same rows
    jb_idx, jb_d2 = JExactNeighbors(block_q=64, block_db=96).neighbors(jnp.asarray(x), k)
    b_idx, b_d2 = ExactNeighbors(block_q=block_q, block_db=block_db).neighbors(T(x), k)
    np.testing.assert_allclose(b_d2.numpy(), np.asarray(jb_d2), rtol=1e-4, atol=1e-4)
    assert recall_at_k(np.asarray(jb_idx), b_idx.numpy()) == \
        jrecall_at_k(np.asarray(jb_idx), b_idx.numpy()) >= 0.999


@pytest.mark.parametrize("layout", ["repeat", "tile"])
@pytest.mark.parametrize("block_q,block_db", [(128, 256), (512, 2048)])
def test_knn_breaks_ties_as_jax(layout, block_q, block_db):
    # every row five times (adjacent, or 100 rows apart across chunks):
    # each row's four copies tie at distance 0, and lax.top_k keeps the
    # lower index among equal distances
    rows = np.random.default_rng(43).normal(size=(100, 20)).astype(np.float32)
    x = np.repeat(rows, 5, axis=0) if layout == "repeat" else np.tile(rows, (5, 1))
    j_idx, j_d2 = jknn(jnp.asarray(x), 6, block_q=block_q, block_db=block_db)
    idx, d2 = knn(T(x), 6, block_q=block_q, block_db=block_db)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    # the tolerance of test_knn_matches_jax
    np.testing.assert_allclose(d2.numpy(), np.asarray(j_d2), rtol=1e-4, atol=1e-4)


def test_neighbor_registry():
    assert "exact" in available_neighbor_backends()
    nb = make_neighbor_backend("exact", {"block_q": 32})
    assert nb.block_q == 32
    x = T(make_points(50, seed=2, dim=5))
    with pytest.raises(ValueError, match="k=50 must be < n=50"):
        nb.neighbors(x, 50)
    with pytest.raises(ValueError, match="unknown neighbor method"):
        make_neighbor_backend("sharded")      # comes with the multi-device port


# -------------------------------------------------------------- symmetrize --

def test_symmetrize_bit_identical_to_jax():
    rng = np.random.default_rng(5)
    n, k = 300, 12
    cols = np.stack([rng.choice(np.delete(np.arange(n), i), k, replace=False)
                     for i in range(n)]).astype(np.int32)
    cond_p = rng.uniform(size=(n, k)).astype(np.float32)
    cond_p /= cond_p.sum(1, keepdims=True)
    ref_c, ref_v = jsim.symmetrize_ell(cols, cond_p)
    c, v = similarity.symmetrize_ell(cols, cond_p)
    np.testing.assert_array_equal(c, ref_c)
    np.testing.assert_array_equal(v, ref_v)
    cc, cv = similarity.symmetrize_ell_chunked(cols, cond_p, 37)
    np.testing.assert_array_equal(cc, ref_c)
    np.testing.assert_array_equal(cv, ref_v)
    np.testing.assert_array_equal(similarity.dense_p_matrix(cols, cond_p),
                                  jsim.dense_p_matrix(cols, cond_p))
    src, dst, w = similarity.edge_list(T(cols), T(cond_p))
    jsrc, jdst, jw = jsim.edge_list(cols, cond_p)
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


# -------------------------------------------------------------- preprocess --

@pytest.mark.parametrize("layout", ["blocked", "edges"])
def test_preprocess_matches_jax(layout):
    x = make_points(250, seed=7, clusters=3, dim=10)
    jcfg = jtsne.TsneConfig(perplexity=10.0, attractive_impl=layout)
    cfg = TsneConfig(perplexity=10.0, attractive_impl=layout)
    jg, jt = jtsne.preprocess(jnp.asarray(x), jcfg)
    g, t = preprocess(T(x), cfg)
    assert {"knn", "bsp", "symmetrize", "n_neighbors", "knn_mean_d2"} <= set(t)
    assert t["n_neighbors"] == jt["n_neighbors"] == 30
    # |q|^2+|c|^2-2qc cancels in fp32 (norms ~90, distances ~1), and the
    # search amplifies a distance's relative error by beta*d2 (~10): P to
    # rtol 1e-3 entry by entry; its sums (p_logp, mean d2) to 1e-5
    np.testing.assert_allclose(float(g.p_logp), float(jg.p_logp), rtol=1e-5)
    np.testing.assert_allclose(t["knn_mean_d2"], jt["knn_mean_d2"], rtol=1e-5)
    if layout == "edges":
        assert g.has_edges and jg.has_edges
        np.testing.assert_array_equal(g.edge_src.numpy(), np.asarray(jg.edge_src))
        np.testing.assert_allclose(g.edge_w.numpy(), np.asarray(jg.edge_w), rtol=1e-3,
                                   atol=1e-7)   # max w ~5e-4
    else:
        np.testing.assert_allclose(dense(g.p_cols, g.p_vals), dense(jg.p_cols, jg.p_vals),
                                   rtol=1e-3, atol=1e-9)


def test_preprocess_chunked_matches_unchunked():
    x = T(make_points(200, seed=8, dim=6))
    g, _ = preprocess(x, TsneConfig(perplexity=8.0))
    gc, tc = preprocess(x, TsneConfig(perplexity=8.0, chunk_size=64))
    assert tc["chunk_size"] == 64
    # row chunking is exact for BSP and bit-identical for symmetrization
    assert torch.equal(g.p_cols, gc.p_cols) and torch.equal(g.p_vals, gc.p_vals)


def test_preprocess_p_len_counts_each_rows_runs():
    x = make_points(260, seed=12, clusters=3, dim=8)
    cfg = TsneConfig(perplexity=6.0)
    g, t = preprocess(T(x), cfg)
    k = t["n_neighbors"]
    idx, _ = knn(T(x), k, block_q=cfg.knn_block_q, block_db=cfg.knn_block_db)
    idx = idx.numpy()
    # a row's runs: its out-neighbours and the in-neighbours not among them
    inn = [set() for _ in range(len(x))]
    for i, row in enumerate(idx):
        for j in row:
            inn[j].add(i)
    runs = [len(set(idx[i]) | inn[i]) for i in range(len(x))]
    assert g.p_len.dtype == torch.int32 and g.p_len.tolist() == runs
    assert int(g.p_len.max()) == g.p_cols.shape[1] > float(g.p_len.float().mean())
    # a graph carried over as numpy gets the same lengths
    gc = convert.graph_from_numpy(g.p_cols.numpy(), g.p_vals.numpy(), float(g.p_logp),
                                  device="cpu")
    assert torch.equal(gc.p_len, g.p_len)
    assert torch.equal(preprocess(T(x), TsneConfig(perplexity=6.0, chunk_size=50))[0].p_len,
                       g.p_len)
    ge, _ = preprocess(T(x), TsneConfig(perplexity=6.0, attractive_impl="edges"))
    assert ge.p_len.shape == (1,)


def test_backends_pass_p_len(monkeypatch):
    x = make_points(200, seed=13, dim=6)
    g, _ = preprocess(T(x), TsneConfig(perplexity=8.0))
    y = T((np.random.default_rng(1).normal(size=(200, 2)) * 3).astype(np.float32))
    seen = []
    real = attractive.attractive_forces_ell

    def spy(y, cols, vals, row_len=None):
        seen.append(row_len)
        return real(y, cols, vals, row_len)

    monkeypatch.setattr(attractive, "attractive_forces_ell", spy)
    bh = BarnesHutBackend().gradient(y, g, 12.0)
    FFTBackend().gradient(y, g, 12.0)
    assert len(seen) == 2 and all(r is g.p_len for r in seen)
    # the padding the lengths skip adds exact zeros: the same gradient
    full = bh_gradient(y, g.p_cols, g.p_vals, None, 0.5, 12.0, 16, g.p_logp)
    assert seen[-1] is None
    assert torch.equal(bh.grad, full.grad) and torch.equal(bh.kl, full.kl)


# ------------------------------------------------------------ descent step --

@pytest.fixture(scope="module")
def jax_fit_inputs():
    """A JAX-built graph (as numpy) and JAX's init state for 300 points.

    Perplexity 30 and the default 250 exaggerated iterations: at perplexity
    10, or with the switch to momentum 0.8 inside the run, the descent from
    a 1e-4-wide start is chaotic enough that the two JAX paths (XLA and
    Pallas) end 4-8% apart; here they end within 0.3%.
    """
    x, _ = jmake_dataset("digits", n=300, seed=1)
    cfg = jtsne.TsneConfig(perplexity=30.0, n_iter=60)
    graph, _ = jtsne.preprocess(jnp.asarray(x), cfg)
    state = jtsne.init_state(300, cfg)
    return x, cfg, graph, state


def test_tsne_step_matches_jax(jax_fit_inputs):
    _, jcfg, jg, jstate = jax_fit_inputs
    rng = np.random.default_rng(0)
    y = rng.normal(size=(300, 2)).astype(np.float32)   # a spread-out embedding
    jstate = jstate._replace(y=jnp.asarray(y))
    g = convert.graph_from_numpy(np.asarray(jg.p_cols), np.asarray(jg.p_vals),
                                 float(jg.p_logp), device="cpu")
    state = convert.state_from_numpy(y, np.asarray(jstate.velocity),
                                     np.asarray(jstate.gains), device="cpu")
    jb = jmake_backend("barnes_hut", jcfg, 300)
    tb = make_backend("barnes_hut", TsneConfig(perplexity=30.0), 300)
    for _ in range(5):
        jstate, jstats = jtsne.tsne_step(jstate, jg, jnp.float32(12.0), jnp.float32(0.5),
                                         backend=jb, lr=100.0, min_gain=0.01)
        state, stats = tsne_step(state, g, 12.0, 0.5, backend=tb, lr=100.0, min_gain=0.01)
    assert state.iteration == 5
    # five steps of fp32 BH gradients in another summation order
    np.testing.assert_allclose(state.y.numpy(), np.asarray(jstate.y), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(stats.kl), float(jstats.kl), rtol=1e-4)


@pytest.mark.parametrize("method,use_pallas", [("barnes_hut", False), ("barnes_hut", True),
                                               ("exact", False), ("fft", False),
                                               ("fft", True)])
def test_run_tsne_kl_matches_jax(jax_fit_inputs, method, use_pallas):
    x, jcfg, _, jstate = jax_fit_inputs
    jcfg = dataclasses.replace(jcfg, method=method, use_pallas=use_pallas)
    jres = jtsne.run_tsne(x, jcfg, kl_every=30)
    cfg = TsneConfig(perplexity=30.0, n_iter=60, method=method, use_pallas=use_pallas)
    res = run_tsne(x, cfg, kl_every=30, device="cpu", y0=np.asarray(jstate.y))
    assert res.n_iter == jres.n_iter == 60
    assert res.y.shape == (300, 2) and np.isfinite(res.y).all()
    # use_pallas picks the JAX package's XLA or Pallas path; the port runs
    # the same code for both, so each case holds it against one JAX path.
    # Same backend, same start: the trajectories drift only through fp32
    # summation order (the two JAX paths differ by ~3e-3 here); 1% on KL
    np.testing.assert_allclose(res.kl, jres.kl, rtol=1e-2)
    np.testing.assert_allclose(res.kl_history[:, 1], jres.kl_history[:, 1], rtol=1e-2)


def test_backend_registry_and_config():
    assert {"exact", "barnes_hut", "fft"} <= set(available_backends())
    bh = make_backend("barnes_hut", TsneConfig(theta=0.3, compress_tree=False,
                                               depth="auto"), 4096)
    assert isinstance(bh, BarnesHutBackend) and bh.theta == 0.3 and not bh.compress_tree
    assert isinstance(make_backend("exact", TsneConfig(), 10), ExactBackend)
    fb = make_backend("fft", TsneConfig(fft_n_boxes=64, attractive_impl="edges"), 100)
    assert isinstance(fb, FFTBackend) and fb.n_boxes == 64 and fb.attractive_impl == "edges"
    with pytest.raises(ValueError, match="unknown t-SNE method"):
        make_backend("umap", TsneConfig(), 100)
    with pytest.raises(ValueError, match="unknown bsp_impl"):
        TsneConfig(bsp_impl="numba")
    with pytest.raises(ValueError, match="unknown attractive_impl"):
        y = torch.zeros((4, 2))
        BarnesHutBackend(attractive_impl="csr").gradient(
            y, convert.graph_from_numpy(np.zeros((4, 1), np.int32),
                                        np.zeros((4, 1), np.float32), 0.0,
                                        device="cpu"), 1.0)


def test_init_state_generator_and_y0():
    cfg = TsneConfig(seed=3)
    a = init_state(20, cfg, device="cpu")
    b = init_state(20, cfg, device="cpu")
    assert torch.equal(a.y, b.y) and float(a.y.std()) < 1e-3
    y0 = np.ones((20, 2), np.float32)
    assert torch.equal(init_state(20, cfg, "cpu", y0).y, T(y0))
    with pytest.raises(ValueError, match="y0 must be"):
        init_state(21, cfg, "cpu", y0)


# --------------------------------------------------------------- estimator --

def test_estimator_fitted_attributes_match_jax(jax_fit_inputs):
    x, _, _, jstate = jax_fit_inputs
    kw = dict(perplexity=30.0, n_iter=40, kl_every=20, random_state=0)
    jest = JTSNE(**kw)
    jemb = jest.fit_transform(x)
    est = TSNE(device="cpu", **kw)
    seen = []
    est.callbacks = (seen.append,)
    emb = est.fit_transform(x, y0=np.asarray(jstate.y))
    assert emb.shape == jemb.shape == (300, 2)
    fitted = {a for a in vars(jest) if a.endswith("_") and not a.startswith("_")}
    ported = {a for a in vars(est) if a.endswith("_") and not a.startswith("_")}
    # the JAX estimator also keeps its tracer/metrics (the obs port waits)
    assert fitted - {"tracer_", "metrics_"} <= ported
    assert est.n_iter_ == jest.n_iter_ == 40
    assert est.n_neighbors_ == jest.n_neighbors_
    assert est.learning_rate_ == jest.learning_rate_
    assert est.n_features_in_ == jest.n_features_in_
    assert est.kl_history_.shape == jest.kl_history_.shape
    assert {"knn", "bsp", "symmetrize", "gradient_descent"} <= set(est.timings_)
    assert [s.iteration for s in seen] == [20, 40]
    # same start as JAX (its init passed as y0): KL within 1%
    np.testing.assert_allclose(est.kl_divergence_, jest.kl_divergence_, rtol=1e-2)
    assert est.get_params()["device"] == torch.device("cpu")
    with pytest.raises(ValueError, match="perplexity"):
        TSNE(device="cpu", perplexity=200.0).fit(x)


def test_estimator_fft_backend_options(monkeypatch):
    x = make_points(120, seed=4, dim=6)
    seen = []
    real = FFTBackend.gradient

    def spy(self, y, graph, exaggeration):
        seen.append(self.n_boxes)
        return real(self, y, graph, exaggeration)

    monkeypatch.setattr(FFTBackend, "gradient", spy)
    est = TSNE(method="fft", perplexity=10.0, n_iter=20, kl_every=10, random_state=0,
               backend_options={"fft_n_boxes": 96}, device="cpu")
    emb = est.fit_transform(x)
    assert seen == [96] * 20
    assert emb.shape == (120, 2) and np.isfinite(emb).all() and np.isfinite(est.kl_divergence_)
    with pytest.raises(ValueError, match="MAX_N_BOXES"):
        TSNE(method="fft", perplexity=10.0, n_iter=2, device="cpu",
             backend_options={"fft_n_boxes": 129}).fit(x)


def test_fft_interp_impl_is_accepted_and_checked():
    # the reference's dispatch flag carries across; it routes nothing here
    x = make_points(80, seed=6, dim=5)
    est = TSNE(method="fft", perplexity=8.0, n_iter=10, kl_every=5, random_state=0,
               backend_options={"fft_interp_impl": "pallas"}, device="cpu")
    emb = est.fit_transform(x)
    assert emb.shape == (80, 2) and np.isfinite(emb).all()
    assert np.isfinite(est.kl_divergence_)
    assert TsneConfig(fft_interp_impl="xla").fft_interp_impl == "xla"
    with pytest.raises(ValueError, match="unknown fft_interp_impl"):
        TSNE(perplexity=8.0, n_iter=2, device="cpu",
             backend_options={"fft_interp_impl": "triton"}).fit(x)


def test_tsne_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSNE()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_tsne(np.zeros((10, 3), np.float32))
    with pytest.raises(ValueError, match="unsupported device"):
        TSNE(device="meta")


def test_convert_round_trip():
    g = convert.graph_from_numpy(np.array([[1], [0]]), np.array([[0.5], [0.5]]), -0.69,
                                 edges=(np.array([0]), np.array([1]), np.array([0.25])),
                                 device="cpu")
    assert g.n == 2 and g.has_edges and g.p_cols.dtype == torch.int32
    assert g.edges[2].dtype == torch.float32
    s = convert.state_from_numpy(np.zeros((2, 2)), iteration=np.int32(7), device="cpu")
    assert s.iteration == 7 and torch.equal(s.gains, torch.ones((2, 2)))


# ----------------------------------------------------------- import hygiene --

def test_port_imports_neither_jax_nor_repro():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = ("import sys\n"
            f"for m in {modules!r}: __import__(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
