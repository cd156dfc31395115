"""Hypothesis property tests on the port's invariants: ``tests/test_property.py``'s
seven, on ``repro_torch``'s functions (the CPU path: the kernels' plain
twins), with the same settings and tolerances.  The Morton round trip is
also held to the JAX package's ``morton_decode_cell``."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from hypothesis.extra import numpy as hnp  # noqa: E402

from repro.core.morton import morton_decode_cell as jax_decode_cell  # noqa: E402
from repro_torch.core import exact  # noqa: E402
from repro_torch.core.attractive import attractive_forces_edges  # noqa: E402
from repro_torch.core.bsp import binary_search_perplexity, perplexity_of  # noqa: E402
from repro_torch.core.morton import morton_decode_cell, morton_encode, span_radius  # noqa: E402
from repro_torch.core.quadtree import build_quadtree, sort_points_by_code  # noqa: E402
from repro_torch.core.repulsive import bh_repulsion_sorted  # noqa: E402
from repro_torch.core.summarize import summarize  # noqa: E402

SETTINGS = dict(max_examples=15, deadline=None)
T = torch.as_tensor


def finite_points(min_n=2, max_n=120):
    return hnp.arrays(
        np.float32,
        st.tuples(st.integers(min_n, max_n), st.just(2)),
        elements=st.floats(-100, 100, width=32, allow_nan=False, allow_infinity=False),
    )


def sorted_tree(y):
    """(y_sorted, tree, summary, perm) of the port's BH pipeline on y."""
    yt = T(y)
    cent, r = span_radius(yt)
    cs, ys, perm = sort_points_by_code(yt, morton_encode(yt, cent, r))
    tree = build_quadtree(cs)
    return ys, tree, summarize(tree, ys, r), perm


@given(y=finite_points())
@settings(**SETTINGS)
def test_morton_roundtrip_cells(y):
    yt = T(y)
    cent, r = span_radius(yt)
    codes = morton_encode(yt, cent, r)
    cx, cy = morton_decode_cell(codes, level=16)
    # decoded integer cells must equal direct quantization
    y_root = cent.numpy() - float(r)
    scale = (2.0**15) / float(r)
    q = np.clip(((y - y_root) * scale), 0, 2**16 - 1).astype(np.uint32)
    assert (cx.numpy() == q[:, 0]).all()
    assert (cy.numpy() == q[:, 1]).all()
    # and every level's prefix decodes as the reference decodes it
    for level in (1, 7, 16):
        jx, jy = jax_decode_cell(jnp.asarray(codes.numpy().astype(np.uint32)), level=level)
        px, py = morton_decode_cell(codes, level=level)
        assert (px.numpy() == np.asarray(jx)).all() and (py.numpy() == np.asarray(jy)).all()


@given(y=finite_points())
@settings(**SETTINGS)
def test_quadtree_laminar_and_partition(y):
    n = y.shape[0]
    _, tree, _, _ = sorted_tree(y)
    nn = int(tree.n_nodes)
    start = tree.start.numpy()[:nn]
    end = tree.end.numpy()[:nn]
    skip = tree.skip.numpy()[:nn]
    assert 1 <= nn <= 2 * n
    assert start[0] == 0 and end[0] == n
    assert (start < end).all()
    # laminar: any two ranges are nested or disjoint
    for k in range(1, min(nn, 40)):
        a = (start[k], end[k])
        b = (start[k - 1], end[k - 1])
        nested = (b[0] <= a[0] and a[1] <= b[1]) or (a[0] <= b[0] and b[1] <= a[1])
        disjoint = a[1] <= b[0] or b[1] <= a[0]
        assert nested or disjoint
    # skip pointers are strictly forward and range-consistent
    ks = np.arange(nn)
    assert (skip > ks).all()
    valid = skip < nn
    assert (start[skip[valid]] >= end[valid]).all()


@given(y=finite_points(min_n=3))
@settings(**SETTINGS)
def test_exact_repulsion_newton_third_law(y):
    f, z = exact.exact_repulsion(T(y))
    assert float(z) >= 0
    np.testing.assert_allclose(f.numpy().sum(0), 0.0, atol=1e-3)


@given(y=finite_points(min_n=4, max_n=80))
@settings(**SETTINGS)
def test_bh_matches_exact_at_theta_zero(y):
    ys, tree, summ, _ = sorted_tree(y)
    rep = bh_repulsion_sorted(ys, tree, summ, 0.0)
    f_ex, z_ex = exact.exact_repulsion(ys)
    np.testing.assert_allclose(float(torch.sum(rep.z_per_point)), float(z_ex),
                               rtol=5e-3, atol=1e-4)
    # float32 prefix-sum noise scales with coordinate magnitude
    atol = 1e-5 * (1.0 + float(np.abs(y).max()))
    np.testing.assert_allclose(rep.force.numpy(), f_ex.numpy(), rtol=2e-2, atol=atol)


@given(
    n=st.integers(8, 64),
    k=st.integers(2, 7),
    seed=st.integers(0, 2**31 - 1),
)
@settings(**SETTINGS)
def test_attractive_edges_antisymmetry(n, k, seed):
    rng = np.random.default_rng(seed)
    y = T(rng.normal(size=(n, 2)).astype(np.float32))
    src = rng.integers(0, n, size=n * k)
    dst = T(((rng.integers(1, n, size=n * k) + src) % n).astype(np.int32))
    w = T(rng.uniform(0, 1, size=n * k).astype(np.float32))
    f, _ = attractive_forces_edges(y, T(src.astype(np.int32)), dst, w)
    np.testing.assert_allclose(f.numpy().sum(0), 0.0, atol=1e-3)


@given(
    n=st.integers(4, 60),
    k=st.integers(3, 16),
    perp=st.floats(2.0, 5.0),
    seed=st.integers(0, 2**31 - 1),
)
@settings(**SETTINGS)
def test_bsp_reaches_target_perplexity(n, k, perp, seed):
    perp = min(perp, k * 0.9)
    rng = np.random.default_rng(seed)
    d2 = T(np.sort(rng.uniform(0.01, 10, size=(n, k)), axis=1).astype(np.float32))
    cond_p, beta = binary_search_perplexity(d2, perp)
    np.testing.assert_allclose(perplexity_of(cond_p).numpy(), perp, rtol=5e-2)
    assert (beta.numpy() > 0).all()


@given(y=finite_points(min_n=10, max_n=100), shift=st.floats(-50, 50))
@settings(**SETTINGS)
def test_bh_translation_invariance(y, shift):
    """BH repulsive forces are invariant to translating the embedding."""
    def forces(yy):
        ys, tree, summ, perm = sorted_tree(yy)
        rep = bh_repulsion_sorted(ys, tree, summ, 0.5)
        out = np.zeros_like(yy)
        out[perm.numpy()] = rep.force.numpy()
        return out

    f0 = forces(y)
    f1 = forces(y + np.float32(shift))
    # degenerate duplicate clusters amplify one-ulp COM noise by the cluster
    # count, so the absolute tolerance scales with N * |y| * eps
    atol = max(5e-4, 2e-7 * (1.0 + float(np.abs(y).max()) + abs(shift)) * y.shape[0])
    np.testing.assert_allclose(f0, f1, rtol=5e-2, atol=atol)
