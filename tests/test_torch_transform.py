"""The port's out-of-sample transform and persistence against the JAX package.

``TSNE.transform`` places new points into a frozen fit; ``save`` and
``load`` carry a fitted model across processes, and across packages: both
write the reference's npz schema.  Inputs are made from a seed with
numpy; the port runs on the CPU.  Every tolerance is stated with its
reason.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import TSNE as JTSNE  # noqa: E402
from repro.core.attractive import attractive_forces_frozen as jfrozen  # noqa: E402
from repro.data.datasets import make_dataset as jmake_dataset  # noqa: E402
from repro.embed import transform as jtransform  # noqa: E402
from repro.neighbors import ExactNeighbors as JExactNeighbors  # noqa: E402
from repro_torch.api import TSNE, TransformConfig  # noqa: E402
from repro_torch.core.attractive import attractive_forces_frozen  # noqa: E402
from repro_torch.core.tsne import TsneConfig, run_tsne  # noqa: E402
from repro_torch.embed.transform import (  # noqa: E402
    TransformState, prepare_batch, transform_batch, transform_step,
)
from repro_torch.neighbors import ExactNeighbors, RPForestIndex  # noqa: E402


def T(a):
    """A torch tensor of its own copy of ``a`` (JAX's arrays are read-only)."""
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def digits_split():
    """The train/held-out split of the reference's tests/test_transform.py."""
    x, labels = jmake_dataset("digits", n=700)
    return (x[:600], labels[:600]), (x[600:], labels[600:])


@pytest.fixture(scope="module")
def jax_saved(digits_split, tmp_path_factory):
    """A JAX fit of the 600 training rows (the reference's fixture), its
    transform of the 100 held-out rows, and the npz its save() wrote."""
    (train_x, _), (test_x, _) = digits_split
    est = JTSNE(perplexity=12.0, n_iter=250, kl_every=125, random_state=0)
    est.fit(train_x)
    path = tmp_path_factory.mktemp("jax_model") / "digits.npz"
    est.save(path)
    return est, np.asarray(est.transform(test_x)), path


@pytest.fixture(scope="module")
def loaded(jax_saved):
    """The port's estimator, loaded on the CPU from the JAX file."""
    return TSNE.load(jax_saved[2], device="cpu")


def frozen_inputs(seed, m=40, k=12):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(m, 2)).astype(np.float32) * 3.0
    nbr_y = (y[:, None, :] + rng.normal(size=(m, k, 2)) * 2.0).astype(np.float32)
    p = rng.uniform(size=(m, k)).astype(np.float32)
    p[-3:] = 0.0                                          # pad rows
    p /= np.maximum(p.sum(1, keepdims=True), 1e-30)
    return y, nbr_y, p


# ------------------------------------------------------------ the step ---

def test_attractive_forces_frozen_matches_jax():
    y, nbr_y, p = frozen_inputs(0)
    jf, jkl = jfrozen(jnp.asarray(y), jnp.asarray(nbr_y), jnp.asarray(p))
    f, kl = attractive_forces_frozen(T(y), T(nbr_y), T(p))
    assert f.shape == (40, 2) and kl.shape == (40,)
    # fp32 sums over K = 12 in another order: rtol 1e-5 (atol 1e-6 where a
    # pad row's zero force is compared)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(kl.numpy(), np.asarray(jkl), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("per_row_momentum", [False, True])
def test_transform_step_matches_jax(per_row_momentum):
    y, nbr_y, p = frozen_inputs(1)
    active = np.arange(40) % 5 != 0                       # frozen rows keep their y
    mom = np.linspace(0.5, 0.8, 40).astype(np.float32) if per_row_momentum \
        else np.float32(0.5)
    js = jtransform.TransformState(y=jnp.asarray(y), velocity=jnp.zeros((40, 2)),
                                   gains=jnp.ones((40, 2)))
    ts = TransformState(y=T(y), velocity=torch.zeros((40, 2)), gains=torch.ones((40, 2)))
    for _ in range(6):
        js, jgn, jkl = jtransform.transform_step(js, jnp.asarray(p), jnp.asarray(nbr_y),
                                                 jnp.asarray(active), jnp.asarray(mom),
                                                 lr=0.5, min_gain=0.01)
        ts, gn, kl = transform_step(ts, T(p), T(nbr_y), T(active), T(mom), lr=0.5,
                                    min_gain=0.01)
    # six fp32 steps of an elementwise update from forces that agree to
    # ~1e-7: rtol 1e-5 (atol 1e-6 for the pad rows' zeros)
    for a, b in ((ts.y, js.y), (ts.velocity, js.velocity), (ts.gains, js.gains),
                 (gn, jgn), (kl, jkl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ts.y.numpy()[~active], y[~active])


def test_prepare_batch_matches_jax(digits_split):
    # the digits on a grid of quarters: distances exact in fp32 in both
    # packages, so both query the same neighbours and the search gets the
    # same inputs; the two plain bisections then agree to rtol 1e-5 (the
    # Pallas kernel's parity bar)
    (train_x, _), (test_x, _) = digits_split
    ref, new = np.round(train_x * 4) / 4, np.round(test_x[:30] * 4) / 4
    y_ref = np.random.default_rng(2).normal(size=(600, 2)).astype(np.float32) * 10
    jp, jnbr, jy0 = jtransform.prepare_batch(
        jnp.asarray(new), JExactNeighbors().build_index(jnp.asarray(ref)),
        jnp.asarray(y_ref), 36, 12.0)
    p, nbr, y0 = prepare_batch(T(new), ExactNeighbors().build_index(T(ref)), T(y_ref), 36, 12.0)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(y0.numpy(), np.asarray(jy0), rtol=1e-5, atol=1e-5)


# --------------------------------------------------- a JAX model, loaded ---

def test_load_reads_a_jax_save(jax_saved, loaded):
    est, _, _ = jax_saved
    np.testing.assert_array_equal(loaded.embedding_, est.embedding_)
    np.testing.assert_array_equal(loaded._x_fit, est._x_fit)
    assert loaded.kl_divergence_ == est.kl_divergence_
    assert loaded.n_neighbors_ == est.n_neighbors_ == loaded.query_k_ == 36
    assert loaded.perplexity == est.perplexity and loaded.n_iter_ == est.n_iter_
    assert loaded.timings_ is None and loaded.device == torch.device("cpu")
    g, g0 = loaded.neighbor_graph_, est.neighbor_graph_
    np.testing.assert_array_equal(g.p_cols.numpy(), np.asarray(g0.p_cols))
    np.testing.assert_array_equal(g.p_vals.numpy(), np.asarray(g0.p_vals))
    # p_len derived from the columns, as convert.graph_from_numpy derives it
    cols = np.asarray(g0.p_cols)
    lengths = (cols != np.arange(cols.shape[0])[:, None]).sum(1)
    np.testing.assert_array_equal(g.p_len.numpy(), lengths)


def test_transform_of_a_jax_model_matches_jax(digits_split, jax_saved, loaded):
    _, (test_x, _) = digits_split
    _, y_jax, _ = jax_saved
    y, stats = loaded.transform(test_x, return_stats=True)
    assert y.shape == (100, 2) and np.isfinite(y).all() and (stats.n_steps >= 1).all()
    # The same neighbours (the query's fp32 tiles differ in the last bits,
    # which swapped no k-th neighbour here), so only float order separates
    # the two 120-step descents.  Measured: max |dy| 1.9e-6 on an embedding
    # that spans 11.9; bound 1e-5 of the span.
    span = float(np.ptp(loaded.embedding_))
    assert np.abs(y - y_jax).max() <= 1e-5 * span


def test_transform_lands_in_own_cluster(digits_split, loaded):
    # the reference's test_lands_in_own_cluster: embedding-space 5-NN
    # label accuracy >= the input-space baseline - 0.05, and >= 0.8
    (train_x, train_l), (test_x, test_l) = digits_split
    y_new = loaded.transform(test_x)

    def knn_label_acc(space_train, space_test):
        d2 = ((space_test[:, None, :] - space_train[None]) ** 2).sum(-1)
        votes = train_l[np.argsort(d2, axis=1)[:, :5]]
        pred = np.array([np.bincount(v).argmax() for v in votes])
        return (pred == test_l).mean()

    baseline = knn_label_acc(train_x, test_x)
    acc = knn_label_acc(loaded.embedding_, y_new)
    assert acc >= baseline - 0.05 and acc >= 0.8


def test_transform_is_deterministic_and_reuses_the_index(digits_split, loaded):
    _, (test_x, _) = digits_split
    np.testing.assert_array_equal(loaded.transform(test_x[:12]), loaded.transform(test_x[:12]))
    index = loaded.query_index_
    assert loaded.query_index_ is index and index.n_reference == 600


def test_transform_config_overrides(digits_split, loaded):
    _, (test_x, _) = digits_split
    cfg = TransformConfig(n_iter=5, check_every=5, batch_size=16)
    y, stats = loaded.transform(test_x[:8], transform_config=cfg, return_stats=True)
    assert (stats.n_steps <= 5).all() and np.isfinite(y).all()


@pytest.mark.parametrize("m", [3, 8, 11])
def test_transform_batch_pads_to_the_batch(digits_split, loaded, m):
    # m smaller than, equal to, and not divisible by batch_size; a row's
    # result does not depend on the other rows of its batch
    _, (test_x, _) = digits_split
    cfg = TransformConfig(n_iter=30, batch_size=8)
    y, stats = transform_batch(T(test_x[:m]), loaded.query_index_, T(loaded.embedding_),
                               k=loaded.query_k_, perplexity=loaded.perplexity, config=cfg)
    assert y.shape == (m, 2) and np.isfinite(y).all() and stats.n_steps.shape == (m,)
    alone, _ = transform_batch(T(test_x[:1]), loaded.query_index_, T(loaded.embedding_),
                               k=loaded.query_k_, perplexity=loaded.perplexity, config=cfg)
    np.testing.assert_allclose(y[:1], alone, rtol=1e-6, atol=1e-6)


def test_validation(digits_split, loaded, tmp_path):
    _, (test_x, _) = digits_split
    with pytest.raises(ValueError, match="not fitted"):
        TSNE(device="cpu").transform(test_x)
    with pytest.raises(ValueError, match="not fitted"):
        TSNE(device="cpu").save(tmp_path / "nope.npz")
    with pytest.raises(ValueError, match="expected x_new shaped"):
        loaded.transform(test_x[:, :10])
    with pytest.raises(ValueError, match="expected x_new shaped"):
        loaded.transform(test_x[0])


def test_load_accepts_a_traced_model(jax_saved, tmp_path):
    z = dict(np.load(jax_saved[2], allow_pickle=False))
    params = json.loads(str(z["params_json"]))
    params["trace"] = True
    z["params_json"] = np.array(json.dumps(params))
    np.savez_compressed(tmp_path / "traced.npz", **z)
    est = TSNE.load(tmp_path / "traced.npz", device="cpu")
    assert est.trace is True and est.get_params()["trace"] is True
    np.testing.assert_array_equal(est.embedding_, jax_saved[0].embedding_)
    # and the port's save carries trace across to the JAX package
    est.set_params(trace=str(tmp_path / "fit_trace.json"))
    est.save(tmp_path / "port_traced.npz")
    assert JTSNE.load(tmp_path / "port_traced.npz").trace == str(tmp_path / "fit_trace.json")
    z["schema"] = np.int32(2)
    np.savez_compressed(tmp_path / "schema2.npz", **z)
    with pytest.raises(ValueError, match="schema"):
        TSNE.load(tmp_path / "schema2.npz", device="cpu")


# --------------------------------------------------- a port model, saved ---

def test_jax_loads_a_port_save(digits_split, tmp_path):
    (train_x, _), (test_x, _) = digits_split
    est = TSNE(perplexity=12.0, n_iter=60, kl_every=30, random_state=0, device="cpu",
               neighbor_method="rp_forest", neighbor_options={"n_trees": 4})
    est.fit(train_x[:300])
    path = tmp_path / "port.npz"
    est.save(path)
    params = json.loads(str(np.load(path)["params_json"]))
    assert params["trace"] is None and "device" not in params
    jest = JTSNE.load(path)
    np.testing.assert_array_equal(jest.embedding_, est.embedding_)
    assert jest.kl_divergence_ == est.kl_divergence_
    assert jest.n_neighbors_ == est.n_neighbors_ and jest.neighbor_method == "rp_forest"
    assert jest.neighbor_options == {"n_trees": 4}
    np.testing.assert_array_equal(np.asarray(jest.neighbor_graph_.p_cols),
                                  est.neighbor_graph_.p_cols.numpy())
    y_jax = np.asarray(jest.transform(test_x[:20]))
    assert y_jax.shape == (20, 2) and np.isfinite(y_jax).all()
    # and the port reloads its own file: the same rp_forest index (the
    # same draws), so the same transform
    again = TSNE.load(path, device="cpu")
    assert isinstance(again.query_index_, RPForestIndex)
    np.testing.assert_array_equal(again.transform(test_x[:20]), est.transform(test_x[:20]))


# -------------------------------------------------- approximate-graph fit ---

def test_bh_kl_on_approximate_graph():
    # the reference's test_bh_kl_on_approximate_graph: BH t-SNE on an
    # rp_forest graph lands within 0.15 of the exact-graph KL
    x, _ = jmake_dataset("digits", n=800)
    kl = {}
    for method in ("exact", "rp_forest"):
        cfg = TsneConfig(perplexity=12.0, n_iter=150, exaggeration_iters=50,
                         momentum_switch_iter=50, seed=3, neighbor_method=method)
        res = run_tsne(x, cfg, kl_every=150, device="cpu")
        assert res.timings["neighbor_method"] == method
        kl[method] = res.kl
    assert np.isfinite(kl["rp_forest"])
    assert abs(kl["rp_forest"] - kl["exact"]) < 0.15
