"""The port's approximate neighbours and query indexes against the JAX package.

The reference draws its hyperplanes, offsets and samples from
``jax.random``, which torch cannot repeat.  Each test computes the
reference's own draws with ``jax.random`` (the same ``PRNGKey``,
``fold_in`` and ``split``) and hands them to the port's functions that
take draws, so indices are compared exactly, not statistically.  Inputs
are made from a seed with numpy; the port runs on the CPU.  Every
tolerance is stated with its reason.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.knn import knn_query as jknn_query  # noqa: E402
from repro.data.datasets import make_dataset as jmake_dataset  # noqa: E402
from repro.neighbors import _candidates as jcand  # noqa: E402
from repro.neighbors import nn_descent as jnnd  # noqa: E402
from repro.neighbors import rp_forest as jrpf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.knn import knn_query  # noqa: E402
from repro_torch.core.tsne import TsneConfig  # noqa: E402
from repro_torch.neighbors import (  # noqa: E402
    ExactIndex, ExactNeighbors, NeighborIndex, NNDescentNeighbors, RPForestIndex,
    RPForestNeighbors, available_neighbor_backends, build_query_index, make_neighbor_backend,
    merge_topk, recall_at_k, rp_forest_knn, seed_graph,
)
from repro_torch.neighbors import _candidates  # noqa: E402
from repro_torch.neighbors.nn_descent import nn_descent_round  # noqa: E402
from repro_torch.neighbors.rp_forest import (  # noqa: E402
    build_tree, forest_shape, leaf_topk, rp_forest_knn_with_draws,
)

J = jnp.asarray


def T(a):
    """A torch tensor of its own copy of ``a`` (JAX's arrays are read-only)."""
    return torch.as_tensor(np.array(a))


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def digits():
    x, _ = jmake_dataset("digits")            # 1797 x 64, 10 clusters
    return x


@pytest.fixture(scope="module")
def grid_digits(digits):
    """digits on a grid of quarters: every product and partial sum of a
    squared distance is a multiple of 1/16 below 2^24 / 16, so distances
    are exact in fp32 in both packages whatever the summation order, and
    equal distances tie exactly.  Index parity then tests the algorithms,
    not rounding (on the raw digits, near-tied distances ~1e-3 apart, the
    size of fp32's cancellation at these norms, can swap)."""
    return np.round(digits * 4.0) / 4.0


@pytest.fixture(scope="module")
def digits_oracle(digits):
    k = 15
    idx, d2 = ExactNeighbors().neighbors(T(digits), k)
    return digits, k, idx.numpy(), d2.numpy()


@pytest.fixture(scope="module")
def query_oracle(digits):
    """Reference set + new points + exact query answer (numpy oracle), as
    the reference's tests/test_transform.py builds it."""
    ref, new = digits[:1500], digits[1500:1700]
    d2 = ((new[:, None, :] - ref[None]) ** 2).sum(-1)
    return ref, new, np.argsort(d2, axis=1)[:, :15], d2


def jax_forest_draws(x, k, n_trees, depth, seed):
    """The draws of repro's rp_forest_knn: each tree's hyperplanes from
    fold_in(key, t), the seed graph's offsets from fold_in(key, n_trees)."""
    n, d = x.shape
    key = jax.random.PRNGKey(seed)
    dirs = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, t), (depth, d),
                                                  jnp.float32)) for t in range(n_trees)])
    offsets = 1 + np.asarray(jax.random.choice(
        jax.random.fold_in(key, n_trees), jnp.arange(n - 1, dtype=jnp.int32), (k,),
        replace=False))
    return dirs, offsets


def jax_round_draws(n, k, s, n_reverse, seed, it):
    """The draws of round ``it`` of repro's nn_descent_knn."""
    k1, k2, k3 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), it), 3)
    return tuple(np.asarray(jax.random.randint(kk, (n, s), 0, hi))
                 for kk, hi in ((k1, k), (k2, k), (k3, n_reverse)))


# ------------------------------------------------------------ merge_topk ---

@pytest.mark.parametrize("block_bytes", [None, 8 * 40 * 7])
@pytest.mark.parametrize("exclude_self", [True, False])
def test_merge_topk_bit_identical_to_jax(exclude_self, block_bytes, monkeypatch):
    # rows with duplicates (between best and cand and within cand), indices
    # out of range on both sides, self columns, and many tied distances
    # (multiples of 0.5, zeros among them)
    if block_bytes is not None:          # 7 rows a block: the row-block path
        monkeypatch.setattr(_candidates, "MERGE_BLOCK_BYTES", block_bytes)
    rng = np.random.default_rng(0)
    m, k0, c = 200, 10, 30
    best_i = rng.integers(-3, m + 3, size=(m, k0)).astype(np.int32)
    cand_i = rng.integers(-3, m + 3, size=(m, c)).astype(np.int32)
    cand_i[:, :5] = best_i[:, :5]
    cand_i[:, 20:23] = cand_i[:, 10:13]
    cand_i[::3, 6] = np.arange(0, m, 3)
    best_d = rng.integers(0, 8, size=(m, k0)).astype(np.float32) * 0.5
    cand_d = rng.integers(0, 8, size=(m, c)).astype(np.float32) * 0.5
    for k in (1, 12, 40):
        ji, jd = jcand.merge_topk(J(best_i), J(best_d), J(cand_i), J(cand_d), k, m,
                                  exclude_self)
        ti, td = merge_topk(T(best_i), T(best_d), T(cand_i), T(cand_d), k, m, exclude_self)
        assert ti.dtype == torch.int32 and ti.shape == (m, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(bits(td.numpy()), bits(jd))


def test_merge_topk_keeps_the_copy_from_best():
    # one index in best and in cand at distances one ulp apart: the stable
    # sort by index puts best's first, and that copy's distance is kept
    d = np.float32(2.0)
    d_up = np.nextafter(d, np.float32(3.0))
    best_i, best_d = np.array([[3, 4]], np.int32), np.array([[d_up, 5.0]], np.float32)
    cand_i, cand_d = np.array([[3, 1]], np.int32), np.array([[d, 7.0]], np.float32)
    ji, jd = jcand.merge_topk(J(best_i), J(best_d), J(cand_i), J(cand_d), 3, 8)
    ti, td = merge_topk(T(best_i), T(best_d), T(cand_i), T(cand_d), 3, 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(bits(td.numpy()), bits(jd))
    assert bits(td.numpy())[0, 0] == bits(d_up)


# ------------------------------------------------------------- candidates ---

@pytest.mark.parametrize("with_q", [False, True])
def test_candidate_sq_dists_matches_jax(digits, with_q):
    x = digits
    rng = np.random.default_rng(3)
    q = digits[::7] + 0.25 if with_q else None
    m = x.shape[0] if q is None else q.shape[0]
    cand = rng.integers(-2, x.shape[0] + 2, size=(m, 40)).astype(np.int32)
    ref = jcand.candidate_sq_dists(J(x), J(cand), block_rows=100,
                                   q=None if q is None else J(q))
    got = _candidates.candidate_sq_dists(T(x), T(cand), block_rows=100,
                                         q=None if q is None else T(q))
    rows_x = x if q is None else q
    sq = np.sum(np.asarray(rows_x, np.float64) ** 2, 1)[:, None] + \
        np.sum(np.asarray(x, np.float64) ** 2, 1)[np.clip(cand, 0, x.shape[0] - 1)]
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(ref, np.float64))
    # rtol 1e-5, with a floor at 1e-6 of |a|^2 + |b|^2: |a|^2 + |b|^2 - 2ab
    # cancels, so its fp32 error in another summation order scales with the
    # norms, not with the distance (measured: at most 4.3e-7 of them)
    assert (err <= 1e-5 * np.abs(np.asarray(ref)) + 1e-6 * sq).all()


def test_seed_graph_matches_jax(grid_digits):
    x, k = grid_digits, 15
    key = jax.random.PRNGKey(4)
    ji, jd = jcand.seed_graph(J(x), k, key)
    offsets = 1 + np.asarray(jax.random.choice(
        key, jnp.arange(x.shape[0] - 1, dtype=jnp.int32), (k,), replace=False))
    ti, td = seed_graph(T(x), T(offsets))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(bits(td.numpy()), bits(jd))
    # the port's own draws: k distinct offsets in [1, n)
    offs = _candidates.draw_offsets(torch.Generator().manual_seed(0), 50, 49)
    assert sorted(offs.tolist()) == list(range(1, 50))


# -------------------------------------------------------------- rp_forest ---

# the trees' keys: at depth >= 3 most keys put some point of the 1 797
# within 1e-4 of a split (a segment of ~100 points has close neighbours at
# its median); these are keys whose splits all clear that margin
@pytest.mark.parametrize("depth,tree", [(0, 0), (3, 1), (4, 12), (5, 42)])
def test_build_tree_matches_jax(digits, depth, tree):
    x = digits
    n = x.shape[0]
    _, n_pad = forest_shape(n, depth)
    jl, jdirs, jthr = jrpf._build_tree(J(x), jax.random.fold_in(jax.random.PRNGKey(0), tree),
                                       depth, n_pad)
    jl, dirs = np.asarray(jl), np.asarray(jdirs)
    # a projection within 1e-4 of its split (relative to the projections'
    # scale) could flip sides by rounding and hide or fake a difference:
    # none is, so the leaves must match exactly
    proj = x.astype(np.float64) @ dirs.T.astype(np.float64)
    scale = np.abs(proj).max(axis=0) if depth else None
    for level in range(depth):
        seg_len = n_pad >> level
        # later levels permute only within a segment, so position p of the
        # final order lies in level-l node p // seg_len
        node = np.repeat(np.arange(1 << level), seg_len)
        members = jl.reshape(-1)
        real = members < n
        gap = np.abs(proj[members[real], level] - np.asarray(jthr[level])[node[real]])
        assert gap.min() > 1e-4 * scale[level], (level, gap.min(), scale[level])
    tl, tthr = build_tree(T(x), T(dirs), n_pad)
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert len(tthr) == depth
    for level in range(depth):
        # rtol 1e-6; a split near 0 is a cancelling dot product, whose fp32
        # error scales with the projections (1e-6 of the largest)
        np.testing.assert_allclose(tthr[level].numpy(), np.asarray(jthr[level]), rtol=1e-6,
                                   atol=1e-6 * scale[level])


def test_build_tree_pads_sink_and_split_at_inf():
    # 9 points, depth 3: n_pad 16, seven pads.  The last split is between
    # two pads: its threshold is 0.5 * (max + max), which overflows to inf
    x = np.random.default_rng(5).normal(size=(9, 3)).astype(np.float32)
    _, n_pad = forest_shape(9, 3)
    jl, jdirs, jthr = jrpf._build_tree(J(x), jax.random.PRNGKey(1), 3, n_pad)
    tl, tthr = build_tree(T(x), T(np.asarray(jdirs)), n_pad)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for a, b in zip(tthr, jthr):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b))
    assert np.isinf(tthr[2].numpy()).any()
    assert (tl.numpy().reshape(-1)[-7:] >= 9).all()


@pytest.mark.parametrize("leaf_block_bytes", [None, 8 * 75 * 75 * 3])
@pytest.mark.parametrize("k", [4, 30, 200])
def test_leaf_topk_matches_jax_on_tied_distances(k, leaf_block_bytes, monkeypatch):
    # small integer points: every distance is exact in fp32 in both
    # packages, and many tie, so only the tie order (position in the leaf,
    # as lax.top_k keeps it) decides; k = 200 caps at leaf size - 1.
    # 3 of the 4 leaves a block: the leaf-block path
    from repro_torch.neighbors import rp_forest
    if leaf_block_bytes is not None:
        monkeypatch.setattr(rp_forest, "LEAF_BLOCK_BYTES", leaf_block_bytes)
    x = np.random.default_rng(6).integers(0, 4, size=(300, 6)).astype(np.float32)
    depth = 2
    _, n_pad = forest_shape(300, depth)
    jl, _, _ = jrpf._build_tree(J(x), jax.random.PRNGKey(2), depth, n_pad)
    ji, jd = jrpf._leaf_topk(J(x), jl, k, n_pad)
    ti, td = leaf_topk(T(x), T(np.asarray(jl, np.int64)), k, n_pad)
    assert ti.shape == ji.shape == (n_pad, min(k, n_pad // 4 - 1))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(bits(td.numpy()), bits(jd))


@pytest.mark.parametrize("n_trees,depth,seed", [(8, 4, 0), (3, 6, 7)])
def test_rp_forest_knn_matches_jax_given_its_draws(grid_digits, n_trees, depth, seed):
    x, k = grid_digits, 15
    ji, jd = jrpf.rp_forest_knn(J(x), k, n_trees=n_trees, depth=depth, seed=seed)
    dirs, offsets = jax_forest_draws(x, k, n_trees, depth, seed)
    ti, td = rp_forest_knn_with_draws(T(x), k, T(dirs), T(offsets))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(bits(td.numpy()), bits(jd))


def test_rp_forest_draws_are_the_same_for_the_same_seed(digits):
    x = T(digits[:400])
    a = rp_forest_knn(x, 10, n_trees=2, depth=3, seed=9)
    b = rp_forest_knn(x, 10, n_trees=2, depth=3, seed=9)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    c = rp_forest_knn(x, 10, n_trees=2, depth=3, seed=10)
    assert not torch.equal(a[0], c[0])


# ------------------------------------------------------------- nn_descent ---

@pytest.mark.parametrize("n_reverse", [12, 3])
def test_nn_descent_round_matches_jax_given_its_draws(grid_digits, n_reverse):
    # n_reverse 3: most reverse edges collide; the reference keeps the
    # largest row of each slot's writers
    x, k = grid_digits, 15
    n = x.shape[0]
    init_i, init_d = jrpf.rp_forest_knn(J(x), k, n_trees=2, depth=4, seed=1)
    seed, s = 5, 12
    ri, rd = jnnd.nn_descent_knn(J(x), k, init=(init_i, init_d), n_iters=1, seed=seed,
                                 n_reverse=n_reverse)
    draws = jax_round_draws(n, k, s, n_reverse, seed, 0)
    ti, td = nn_descent_round(T(x), T(np.asarray(init_i)), T(np.asarray(init_d)),
                              *map(T, draws), n_reverse)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(bits(td.numpy()), bits(rd))


def test_nn_descent_from_a_seed_graph_matches_jax(grid_digits):
    # two rounds from the reference's random seed graph
    x, k, seed, iters = grid_digits, 10, 3, 2
    n = x.shape[0]
    ri, rd = jnnd.nn_descent_knn(J(x), k, n_iters=iters, seed=seed)
    key = jax.random.PRNGKey(seed)
    offsets = 1 + np.asarray(jax.random.choice(
        jax.random.fold_in(key, iters), jnp.arange(n - 1, dtype=jnp.int32), (k,),
        replace=False))
    idx, d2 = seed_graph(T(x), T(offsets))
    for it in range(iters):
        idx, d2 = nn_descent_round(T(x), idx, d2, *map(T, jax_round_draws(n, k, k, 12, seed,
                                                                           it)), 12)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(bits(d2.numpy()), bits(rd))


# ------------------------------------------------------------ query side ---

@pytest.mark.parametrize("block_q,block_db", [(128, 256), (512, 2048)])
def test_knn_query_matches_jax_on_duplicated_rows(block_q, block_db):
    # a database of 100 rows five times over: each query that repeats a
    # row ties at distance 0 with its five copies, and lax.top_k keeps
    # the lower index first
    rows = np.random.default_rng(8).normal(size=(100, 20)).astype(np.float32)
    db = np.tile(rows, (5, 1))
    q = np.concatenate([rows[:40], rows[60:] + 0.01])
    ji, jd = jknn_query(J(q), J(db), 7, block_q=block_q, block_db=block_db)
    ti, td = knn_query(T(q), T(db), 7, block_q=block_q, block_db=block_db)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the tolerance of test_knn_matches_jax
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="database size"):
        knn_query(T(q), T(db[:5]), 6)


def test_forest_query_matches_jax_given_its_forest(grid_digits):
    ref, new = grid_digits[:1500], grid_digits[1500:1700]
    n_trees, depth, k = 8, 4, 15
    _, n_pad = forest_shape(ref.shape[0], depth)
    leaves, dirs, thrs = jrpf.build_forest_index(J(ref), n_trees, depth, n_pad, seed=0)
    ji, jd = jrpf.forest_query(J(ref), leaves, dirs, thrs, J(new), k)
    index = convert.forest_index_from_numpy(ref, np.asarray(leaves), np.asarray(dirs),
                                            [np.asarray(t) for t in thrs], device="cpu")
    assert isinstance(index, RPForestIndex) and index.n_reference == 1500
    ti, td = index.query(T(new), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(bits(td.numpy()), bits(jd))


def test_forest_index_routes_as_the_fit_buckets(digits):
    # at one depth the index's trees are the fit's (the same draws), and
    # each fitted point routes down every tree to the leaf that holds it
    from repro_torch.neighbors.rp_forest import route_to_leaves
    x = T(digits[:600])
    nb = RPForestNeighbors(n_trees=3, leaf_size=64)
    index = nb.build_index(x)
    depth = index.dirs.shape[1]
    assert depth == nb.resolve_depth(600, 63) == 3
    dirs = torch.randn((3, depth, x.shape[1]), generator=torch.Generator().manual_seed(0))
    assert torch.equal(index.dirs, dirs)
    cand = route_to_leaves(index.leaves, index.dirs, index.thrs, x)
    assert cand.shape == (600, 3 * index.leaves.shape[2])
    assert ((cand == torch.arange(600)[:, None]).sum(1) == 3).all()


# ------------------------------------------------------------- registry ---

def test_registry_and_options():
    assert {"exact", "rp_forest", "nn_descent"} <= set(available_neighbor_backends())
    be = make_neighbor_backend("rp_forest", {"n_trees": 3, "leaf_size": 32})
    assert be.n_trees == 3 and be.leaf_size == 32
    assert make_neighbor_backend("nn_descent", {"n_iters": 5}).n_iters == 5
    x = torch.zeros((8, 3))
    for name in ("exact", "rp_forest", "nn_descent"):
        with pytest.raises(ValueError, match="must be <"):
            make_neighbor_backend(name).neighbors(x, 8)
    # the config's seed reaches the approximate backends, as in the reference
    cfg = TsneConfig(seed=4, neighbor_method="rp_forest", neighbor_options={"n_trees": 2})
    assert cfg.resolve_neighbor_options() == {"n_trees": 2, "seed": 4}
    assert TsneConfig(seed=4, neighbor_method="nn_descent").resolve_neighbor_options() == \
        {"seed": 4}
    assert dataclasses.replace(cfg, neighbor_method="exact").resolve_neighbor_options()[
        "block_q"] == 512


# ---------------------------------------------------------------- recall ---

def _check_valid(idx, n, k):
    idx = np.asarray(idx)
    assert idx.shape == (n, k)
    assert ((idx >= 0) & (idx < n)).all(), "out-of-range neighbor index"
    assert not (idx == np.arange(n)[:, None]).any(), "self-neighbor"
    srt = np.sort(idx, axis=1)
    assert not (srt[:, 1:] == srt[:, :-1]).any(), "duplicate neighbor"


@pytest.mark.parametrize("backend", [RPForestNeighbors(), NNDescentNeighbors()],
                         ids=["rp_forest", "nn_descent"])
def test_recall_on_digits(digits_oracle, backend):
    # the reference's bar (tests/test_neighbors.py): recall >= 0.90
    x, k, ref_idx, _ = digits_oracle
    idx, d2 = backend.neighbors(T(x), k)
    _check_valid(idx, x.shape[0], k)
    assert recall_at_k(ref_idx, idx.numpy()) >= 0.90
    assert (d2.numpy() >= 0).all()
    # the distances reported for the selected neighbours are the true ones
    ref = ((x[:200, None, :].astype(np.float64) - x[idx.numpy()[:200]]) ** 2).sum(-1)
    np.testing.assert_allclose(d2.numpy()[:200], ref, rtol=1e-3, atol=1e-2)


def test_refine_does_not_lower_forest_recall(digits_oracle):
    x, k, ref_idx, _ = digits_oracle
    raw = RPForestNeighbors(n_trees=2, refine_iters=0).neighbors(T(x), k)[0]
    polished = RPForestNeighbors(n_trees=2, refine_iters=3).neighbors(T(x), k)[0]
    assert recall_at_k(ref_idx, polished.numpy()) >= recall_at_k(ref_idx, raw.numpy())


def test_exact_query_matches_oracle(query_oracle):
    ref, new, ref_idx, d2 = query_oracle
    index = ExactNeighbors().build_index(T(ref))
    assert isinstance(index, (ExactIndex, NeighborIndex))
    idx, qd2 = index.query(T(new), 15)
    assert recall_at_k(ref_idx, idx.numpy()) == 1.0
    np.testing.assert_allclose(qd2.numpy(), np.take_along_axis(d2, idx.numpy(), 1),
                               rtol=1e-3, atol=1e-2)


def test_rp_forest_query_recall(query_oracle):
    # the reference's query bar: recall >= 0.9 against exact
    ref, new, ref_idx, d2 = query_oracle
    index = RPForestNeighbors().build_index(T(ref))
    idx, qd2 = index.query(T(new), 15)
    idx = idx.numpy()
    assert recall_at_k(ref_idx, idx) >= 0.9
    assert ((idx >= 0) & (idx < index.n_reference)).all()
    srt = np.sort(idx, axis=1)
    assert not (srt[:, 1:] == srt[:, :-1]).any()
    np.testing.assert_allclose(qd2.numpy(), np.take_along_axis(d2, idx, 1), rtol=1e-3,
                               atol=1e-2)


def test_query_index_fallbacks_are_exact(query_oracle):
    class Bare:
        name = "bare"

        def neighbors(self, x, k):
            raise NotImplementedError

    ref, new, ref_idx, _ = query_oracle
    for backend in (NNDescentNeighbors(), Bare()):
        index = build_query_index(backend, T(ref))
        assert isinstance(index, ExactIndex)
        idx, _ = index.query(T(new), 15)
        assert recall_at_k(ref_idx, idx.numpy()) == 1.0


def test_query_k_validation(query_oracle):
    ref, new, _, _ = query_oracle
    for index in (ExactNeighbors().build_index(T(ref[:10])),
                  RPForestNeighbors().build_index(T(ref[:10]))):
        with pytest.raises(ValueError, match="must be >= 1"):
            index.query(T(new), 0)
        with pytest.raises(ValueError, match="reference-set size"):
            index.query(T(new), 11)
