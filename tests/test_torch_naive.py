"""The port's daal4py-like naive baseline (``core/naive.py``) against the
JAX package's, from the same points made with numpy.

ids and counts must be equal (the reference's uint32 ids as int64);
centres of mass and forces agree to ``allclose(rtol=1e-5, atol=1e-6)``:
the port sums the centres in float64 (the module docstring says why), the
reference in float32.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import naive as jnaive  # noqa: E402
from repro_torch.core import attractive, naive, similarity  # noqa: E402

T = torch.as_tensor
TOL = dict(rtol=1e-5, atol=1e-6)


def points(n, seed, duplicates):
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=(n, 2)) * 10.0).astype(np.float32)
    if duplicates and n > 8:
        y[n // 2:n // 2 + 5] = y[0]            # five copies of one point
        y[-3:] = y[1]
    return y


@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("depth", [4, 16])
@pytest.mark.parametrize("n", [1, 33, 2000])
def test_naive_build_matches_jax(n, depth, duplicates):
    y = points(n, seed=n + depth, duplicates=duplicates)
    j_ids, j_coms, j_counts = jnaive.naive_build_and_summarize(jnp.asarray(y), depth=depth)
    ids, coms, counts = naive.naive_build_and_summarize(T(y), depth=depth)
    assert ids.dtype == torch.int64 and len(coms) == len(counts) == depth
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids).astype(np.int64))
    for level in range(depth):
        np.testing.assert_array_equal(counts[level].numpy(), np.asarray(j_counts[level]))
        assert coms[level].shape == (n, 2) and coms[level].dtype == torch.float32
        np.testing.assert_allclose(coms[level].numpy(), np.asarray(j_coms[level]), **TOL)


def test_naive_build_counts_partition_the_points():
    y = points(500, seed=5, duplicates=True)
    ids, coms, counts = naive.naive_build_and_summarize(T(y))
    for level in range(16):
        cells = int((counts[level] > 0).sum())
        assert float(counts[level].sum()) == 500.0
        assert (counts[level][:cells] > 0).all() and (counts[level][cells:] == 0).all()
    # the finest level's counts are the multiplicities of the sorted ids
    _, mult = torch.unique_consecutive(torch.sort(ids).values, return_counts=True)
    np.testing.assert_array_equal(counts[-1][:mult.shape[0]].numpy(), mult.numpy())
    with pytest.raises(ValueError, match="depth"):
        naive.naive_build_and_summarize(T(y), depth=17)


def test_naive_build_does_not_depend_on_the_order_of_the_adds():
    # cells of ~1e5 points, the sums the card adds atomically in any order:
    # the same points in another order give the same centres of mass
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(4, 2)) * 40.0
    y = (centers[rng.integers(0, 4, 400_000)] + rng.normal(size=(400_000, 2)) * 3.0)
    y = T(y.astype(np.float32))
    perm = T(rng.permutation(400_000))
    _, coms, _ = naive.naive_build_and_summarize(y, depth=3)
    _, coms_p, _ = naive.naive_build_and_summarize(y[perm], depth=3)
    for a, b in zip(coms, coms_p):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def sym_graph(n, k, seed):
    """A symmetrized ELL graph (padding col = row, val 0) and y."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(np.delete(np.arange(n), i), k, replace=False)
                    for i in range(n)]).astype(np.int32)
    cond = rng.uniform(0.1, 1.0, size=(n, k)).astype(np.float32)
    cond /= cond.sum(1, keepdims=True)
    cols, vals = similarity.symmetrize_ell(idx, cond)
    y = rng.normal(size=(n, 2)).astype(np.float32) * 5.0
    return y, cols, (vals / vals.sum()).astype(np.float32)


@pytest.mark.parametrize("n,k", [(1, 0), (40, 5), (1500, 30)])
def test_naive_attractive_matches_jax_and_ell(n, k):
    if n == 1:
        y = np.zeros((1, 2), np.float32)
        cols, vals = np.zeros((1, 1), np.int32), np.zeros((1, 1), np.float32)
    else:
        y, cols, vals = sym_graph(n, k, seed=n)
    f = naive.naive_attractive(T(y), T(cols), T(vals))
    f_jax = jnaive.naive_attractive(jnp.asarray(y), jnp.asarray(cols), jnp.asarray(vals))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_jax), **TOL)
    f_ell, _ = attractive.attractive_forces_ell(T(y), T(cols), T(vals),
                                                T(similarity.ell_row_lengths(cols)))
    np.testing.assert_allclose(f.numpy(), f_ell.numpy(), **TOL)
    # scaled up so that the relative tolerance, not atol, decides
    f_big = naive.naive_attractive(T(y), T(cols), T(vals * 1e6))
    f_ell_big, _ = attractive.attractive_forces_ell(T(y), T(cols), T(vals * 1e6))
    np.testing.assert_allclose(f_big.numpy(), f_ell_big.numpy(), rtol=1e-5,
                               atol=1e-6 * float(np.abs(f_big.numpy()).max() + 1))
