"""The port's Barnes-Hut pipeline against the JAX package, from the same y.

Codes, sort order and the linear quadtree must be identical; summaries,
BH repulsion and the full BH gradient must agree to the stated tolerances.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import attractive as jattractive  # noqa: E402
from repro.core import exact as jexact  # noqa: E402
from repro.core import similarity as jsim  # noqa: E402
from repro.core import tsne as jtsne  # noqa: E402
from repro.core.bsp import binary_search_perplexity as jbsp  # noqa: E402
from repro.core.knn import knn as jknn  # noqa: E402
from repro.core.morton import morton_encode as jmorton_encode  # noqa: E402
from repro.core.morton import span_radius as jspan  # noqa: E402
from repro.core.quadtree import build_quadtree as jbuild  # noqa: E402
from repro.core.quadtree import sort_points_by_code as jsort  # noqa: E402
from repro.core.repulsive import bh_repulsion_sorted as jrep  # noqa: E402
from repro.core.summarize import summarize as jsumm  # noqa: E402
from repro_torch.core import attractive, exact, morton, quadtree  # noqa: E402
from repro_torch.core.repulsive import bh_repulsion_sorted, pack_nodes, warp_walk  # noqa: E402,E501
from repro_torch.core.summarize import TreeSummary, summarize  # noqa: E402
from repro_torch.core.tsne import bh_gradient  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

T = torch.as_tensor


def make_points(n, seed=0, clusters=4, dim=2, std=0.2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, dim)) * 3.0
    lab = rng.integers(0, clusters, size=n)
    return (centers[lab] + rng.normal(size=(n, dim)) * std).astype(np.float32)


def both_trees(y, depth, compress):
    """(jax tree pieces, torch tree pieces) from the same points."""
    yj = jnp.asarray(y)
    cent, r = jspan(yj)
    cs, ys, perm = jsort(yj, jmorton_encode(yj, cent, r, depth=depth))
    jt = jbuild(cs, depth=depth, compress=compress)
    yt = T(y)
    cent_t, r_t = morton.span_radius(yt)
    cs_t, ys_t, perm_t = quadtree.sort_points_by_code(
        yt, ops.morton_encode(yt, cent_t, r_t, depth=depth))
    tt = quadtree.build_quadtree(cs_t, depth=depth, compress=compress)
    return (cs, ys, perm, jt, r), (cs_t, ys_t, perm_t, tt, r_t)


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("n,depth,seed", [(300, 16, 1), (257, 8, 2), (64, 16, 3)])
def test_tree_identical_to_jax(n, depth, seed, compress):
    y = make_points(n, seed=seed)
    (cs, ys, perm, jt, _), (cs_t, ys_t, perm_t, tt, _) = both_trees(y, depth, compress)
    np.testing.assert_array_equal(cs_t.numpy(), np.asarray(cs).astype(np.int64))
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm))  # stable sort
    np.testing.assert_array_equal(ys_t.numpy(), np.asarray(ys))
    assert int(tt.n_nodes) == int(jt.n_nodes)
    assert tt.capacity == jt.capacity
    for field in ("start", "end", "level", "skip"):
        np.testing.assert_array_equal(getattr(tt, field).numpy(),
                                      np.asarray(getattr(jt, field)), err_msg=field)
    np.testing.assert_array_equal(tt.is_leaf.numpy(), np.asarray(jt.is_leaf))


def test_tree_with_duplicate_points():
    y = np.repeat(make_points(40, seed=4), 3, axis=0)
    (_, _, _, jt, _), (_, _, _, tt, _) = both_trees(y, 16, True)
    assert int(tt.n_nodes) == int(jt.n_nodes)
    for field in ("start", "end", "level", "skip"):
        np.testing.assert_array_equal(getattr(tt, field).numpy(),
                                      np.asarray(getattr(jt, field)))


def test_summaries_and_repulsion_match_jax():
    y = make_points(400, seed=13)
    (_, ys, _, jt, r), (_, ys_t, _, tt, r_t) = both_trees(y, 16, True)
    js = jsumm(jt, ys, r)
    ts = summarize(tt, ys_t, r_t)
    # fp32 prefix sums, possibly summed in another order.  A node's sum_y
    # is a difference of two prefix sums, so its error scales with the
    # whole set's |sum y| (~2e3 here), not the node's: atol 1e-3 for it,
    # and 1e-4 for com (that error over a count >= 1, at |y| ~ 10)
    for field, atol in (("count", 0), ("sum_y", 1e-3), ("com", 1e-4), ("side", 0)):
        np.testing.assert_allclose(getattr(ts, field).numpy(),
                                   np.asarray(getattr(js, field)),
                                   rtol=1e-5, atol=atol, err_msg=field)
    jr = jrep(ys, jt, js, 0.5)
    f_ref = np.asarray(jr.force)
    scale = np.abs(f_ref).max()
    # the traversal alone, on the reference's own summaries: fp32 rounding
    same = bh_repulsion_sorted(ys_t, tt, TreeSummary(*(T(np.array(a)) for a in js)), 0.5)
    np.testing.assert_allclose(same.force.numpy(), f_ref, rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_array_equal(same.steps.numpy(), np.asarray(jr.steps))
    # on the port's summaries: a COM rounded 1e-5 apart moves a near
    # neighbor's force by ~1e-5 of the largest force
    tr = bh_repulsion_sorted(ys_t, tt, ts, 0.5)
    np.testing.assert_allclose(tr.force.numpy(), f_ref, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(float(tr.z_per_point.sum()), float(jnp.sum(jr.z_per_point)),
                               rtol=1e-5)
    np.testing.assert_array_equal(tr.steps.numpy(), np.asarray(jr.steps))


def test_coincident_points_no_nan():
    y = np.zeros((32, 2), np.float32)
    (_, _, _, _, _), (_, ys_t, perm_t, tt, r_t) = both_trees(y, 16, True)
    rep = bh_repulsion_sorted(ys_t, tt, summarize(tt, ys_t, r_t), 0.5)
    f = rep.force.numpy()
    z = float(rep.z_per_point.sum())
    assert np.isfinite(f).all() and np.isfinite(z)
    np.testing.assert_allclose(f, 0.0, atol=1e-6)
    # z = sum over ordered pairs of (1+0)^-1 = n(n-1)
    np.testing.assert_allclose(z, 32 * 31, rtol=1e-5)


@pytest.fixture(scope="module")
def graph200():
    """A 200-point symmetric graph built by the JAX package, as numpy."""
    n, k, perp = 200, 24, 8.0
    x = make_points(n, seed=47, dim=12)
    idx, d2 = jknn(jnp.asarray(x), k)
    cond_p, _ = jbsp(d2, perp)
    sym_cols, sym_vals = jsim.symmetrize_ell(idx, cond_p)
    p_dense = jsim.dense_p_matrix(idx, cond_p)
    edges = tuple(np.array(a) for a in jsim.edge_list(idx, cond_p))
    return sym_cols, sym_vals.astype(np.float32), p_dense.astype(np.float32), edges


@pytest.mark.parametrize("theta,exag,layout", [(0.5, 12.0, "ell"), (0.2, 1.0, "ell"),
                                               (0.5, 4.0, "edges")])
def test_bh_gradient_matches_jax(graph200, theta, exag, layout):
    cols, vals, _, edges = graph200
    y = make_points(200, seed=53)
    j_edges = tuple(jnp.asarray(a) for a in edges) if layout == "edges" else None
    t_edges = tuple(T(a) for a in edges) if layout == "edges" else None
    jres = jtsne.bh_gradient(jnp.asarray(y), jnp.asarray(cols), jnp.asarray(vals),
                             j_edges, theta=theta, exaggeration=exag, depth=16,
                             p_logp=-3.0)
    tres = bh_gradient(T(y), T(cols), T(vals), t_edges, theta=theta, exaggeration=exag,
                       depth=16, p_logp=T(np.float32(-3.0)))
    # same tree and walk; fp32 sums in another order
    np.testing.assert_allclose(tres.grad.numpy(), np.asarray(jres.grad), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tres.kl), float(jres.kl), rtol=1e-5)
    np.testing.assert_allclose(float(tres.z), float(jres.z), rtol=1e-5)
    assert int(tres.max_traversal) == int(jres.max_traversal)


def test_bh_gradient_theta0_matches_exact(graph200):
    cols, vals, p_dense, _ = graph200
    y = make_points(200, seed=53)
    res = bh_gradient(T(y), T(cols), T(vals), None, theta=0.0, exaggeration=1.0,
                      depth=16, p_logp=0.0)
    g_ex = np.asarray(jexact.exact_gradient(jnp.asarray(y), jnp.asarray(p_dense)))
    # the bound of tests/test_core_tsne.py::test_bh_gradient_matches_exact
    np.testing.assert_allclose(res.grad.numpy(), g_ex, rtol=5e-3, atol=1e-6)
    g_port = exact.exact_gradient(T(y), T(p_dense)).numpy()
    np.testing.assert_allclose(g_port, g_ex, rtol=1e-4, atol=1e-7)


def test_exact_module_matches_jax(graph200):
    _, _, p_dense, _ = graph200
    y = make_points(200, seed=59)
    f, z = exact.exact_repulsion(T(y))
    jf, jz = jexact.exact_repulsion(jnp.asarray(y))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(z), float(jz), rtol=1e-5)
    np.testing.assert_allclose(float(exact.exact_kl(T(y), T(p_dense))),
                               float(jexact.exact_kl(jnp.asarray(y), jnp.asarray(p_dense))),
                               rtol=1e-4)


def test_attractive_edges_matches_jax(graph200):
    _, _, _, edges = graph200
    y = make_points(200, seed=61)
    f, kl = attractive.attractive_forces_edges(T(y), *(T(a) for a in edges))
    jf, jkl = jattractive.attractive_forces_edges(jnp.asarray(y),
                                                   *(jnp.asarray(a) for a in edges))
    # scatter-adds in another order: fp32 rtol 1e-5 of the largest force
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(jf)).max()))
    np.testing.assert_allclose(float(kl), float(jkl), rtol=1e-5)


# ---------------------------------------------------------------- traversal --

def walk_points(case):
    """Embeddings for the traversal checks: duplicate points (each drawn
    point three times) and coincident ones (16 points at one spot beside a
    cluster set)."""
    if case == "duplicates":
        return np.repeat(make_points(100, seed=71), 3, axis=0)
    if case == "coincident":
        return np.concatenate([np.zeros((16, 2), np.float32), make_points(80, seed=73)])
    return make_points(300, seed=79)


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("case", ["clusters", "duplicates", "coincident"])
@pytest.mark.parametrize("theta", [0.5, 0.2])
def test_traversal_matches_jax(case, compress, theta):
    y = walk_points(case)
    (_, ys, _, jt, r), (_, ys_t, _, tt, r_t) = both_trees(y, 16, compress)
    js = jsumm(jt, ys, r)
    jr = jrep(ys, jt, js, theta)
    f_ref = np.asarray(jr.force)
    scale = np.abs(f_ref).max()
    ops.reset_launch_counts()
    # the walk alone, through the kernel's wrapper, on the reference's own
    # summaries: the same nodes in the same order, fp32 rounding only
    same = ops.bh_traverse(ys_t, tt, TreeSummary(*(T(np.array(a)) for a in js)), theta)
    np.testing.assert_array_equal(same.steps.numpy(), np.asarray(jr.steps))
    np.testing.assert_allclose(same.force.numpy(), f_ref, rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(same.z_per_point.numpy(), np.asarray(jr.z_per_point),
                               rtol=1e-5)
    # on the port's summaries (prefix sums in another order, see
    # test_summaries_and_repulsion_match_jax for the tolerance)
    tr = ops.bh_traverse(ys_t, tt, summarize(tt, ys_t, r_t), theta)
    np.testing.assert_allclose(tr.force.numpy(), f_ref, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(float(tr.z_per_point.sum()), float(jnp.sum(jr.z_per_point)),
                               rtol=1e-5)
    assert np.isfinite(tr.force.numpy()).all()
    assert ops.LAUNCHES["bh_traverse"] == 0      # CPU tensors: the plain twin


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("case", ["clusters", "duplicates", "coincident"])
def test_traversal_theta0_matches_exact(case, compress):
    # theta = 0 opens every internal node: only leaves are summed, and a
    # leaf holds one point or points of one code (here coincident ones),
    # so the walk is the exact O(N^2) sum in another order
    y = walk_points(case)
    _, (_, ys_t, _, tt, r_t) = both_trees(y, 16, compress)
    rep = ops.bh_traverse(ys_t, tt, summarize(tt, ys_t, r_t), 0.0)
    f_ex, z_ex = jexact.exact_repulsion(jnp.asarray(ys_t.numpy()))
    f_ex = np.asarray(f_ex)
    np.testing.assert_allclose(rep.force.numpy(), f_ex, rtol=1e-4,
                               atol=1e-5 * np.abs(f_ex).max())
    np.testing.assert_allclose(float(rep.z_per_point.sum()), float(z_ex), rtol=1e-5)
    # every walk visits every node
    assert (rep.steps == tt.n_nodes).all()


def test_bh_traverse_wrapper_on_cpu_is_the_twin():
    y = make_points(257, seed=83)
    _, (_, ys_t, _, tt, r_t) = both_trees(y, 16, True)
    summ = summarize(tt, ys_t, r_t)
    ops.reset_launch_counts()
    got = ops.bh_traverse(ys_t, tt, summ, 0.5)
    ref = bh_repulsion_sorted(ys_t, tt, summ, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert got.steps.dtype == torch.int64
    assert all(v == 0 for v in ops.LAUNCHES.values())
    # inputs the kernel does not take are refused
    with pytest.raises(TypeError, match="int64"):
        ops.bh_traverse(ys_t, tt._replace(skip=tt.skip.int()), summ, 0.5)
    with pytest.raises(TypeError, match="float32"):
        ops.bh_traverse(ys_t.double(), tt, summ, 0.5)
    with pytest.raises(ValueError, match="sum_y"):
        ops.bh_traverse(ys_t, tt, summ._replace(sum_y=summ.sum_y[:-1]), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bh_traverse(ys_t, tt, summ._replace(sum_y=summ.sum_y.T.contiguous().T), 0.5)
    with pytest.raises(ValueError, match="different devices"):
        ops.bh_traverse(ys_t, tt, summ._replace(side=summ.side.to("meta")), 0.5)


# ------------------------------------- the walk kernel's records, on the CPU --

def design_inputs(case, n, compress, depth=16):
    """(y_sorted, tree, summaries) of n points, built by the port alone:
    clusters; each point three times (duplicates); 16 points at one spot
    beside clusters (coincident); alternate points in two clusters 1e4
    apart, so that groups of Morton-consecutive points straddle both (far)."""
    if case == "duplicates":
        y = np.repeat(make_points(-(-n // 3), seed=89), 3, axis=0)[:n]
    elif case == "coincident":
        y = np.concatenate([np.zeros((min(n, 16), 2), np.float32),
                            make_points(max(n - 16, 0), seed=97)])
    else:
        y = make_points(n, seed=101)
        if case == "far":
            y[1::2] += np.float32(1e4)
    yt = T(y)
    cent, r = morton.span_radius(yt)
    cs, ys, _ = quadtree.sort_points_by_code(yt, ops.morton_encode(yt, cent, r, depth=depth))
    tree = quadtree.build_quadtree(cs, depth=depth, compress=compress)
    return ys, tree, summarize(tree, ys, r)


def as_bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("case", ["clusters", "duplicates", "coincident", "far"])
def test_pack_nodes_is_the_walks_node_arithmetic(case, compress):
    ys, tree, summ = design_inputs(case, 1000, compress)
    rec = pack_nodes(tree, summ)
    assert rec.dtype == torch.int32 and rec.shape == (tree.capacity, 8)
    # the int32 fields are the tree's int64 arrays
    for col, arr in zip((4, 5, 6), (tree.start, tree.end, tree.skip)):
        assert torch.equal(rec[:, col].to(torch.int64), arr)
    assert not rec[:, 7].any()
    # com and side^2 are, bit for bit, what the plain walk computes for a
    # node that does not hold the point
    outside = torch.zeros(tree.capacity, dtype=torch.bool)
    cnt_eff = summ.count - outside.to(torch.float32)
    sum_eff = summ.sum_y - torch.where(outside[:, None], summ.sum_y, 0.0)
    com = sum_eff / torch.clamp_min(cnt_eff, 1.0)[:, None]
    side2 = summ.side * summ.side
    for col, want in enumerate((com[:, 0], com[:, 1], cnt_eff, side2)):
        assert torch.equal(rec[:, col], as_bits(want))


@pytest.mark.parametrize("theta", [0.5, 0.2, 0.0])
@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("case", ["clusters", "duplicates", "coincident"])
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_warp_walk_is_the_plain_walk(n, case, compress, theta):
    # the warp-shared schedule: 32 Morton-consecutive points step through
    # the union of their walks, reading packed records (the slots past
    # n_nodes, which the pack kernel never writes, filled with NaN bits
    # here) and sum_y only where the node holds the point; force, z and
    # steps bit-identical
    ys, tree, summ = design_inputs(case, n, compress)
    rec = pack_nodes(tree, summ)
    rec[int(tree.n_nodes):] = -1
    ref = bh_repulsion_sorted(ys, tree, summ, theta)
    got, union = warp_walk(ys, rec, summ.sum_y, tree.n_nodes, theta)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    # a warp's union holds its longest walk and at most every node; at
    # theta 0 every walk is every node
    steps = torch.zeros(union.shape[0] * 32, dtype=torch.int64)
    steps[:n] = ref.steps
    longest = steps.view(-1, 32).amax(dim=1)
    assert (union >= longest).all() and (union <= tree.n_nodes).all()
    if theta == 0.0:
        assert (union == tree.n_nodes).all()


@pytest.mark.parametrize("theta", [0.5, 0.0])
@pytest.mark.parametrize("n", [33, 1000])
def test_warp_walk_straddling_far_clusters(n, theta):
    # warps that hold points of two clusters 1e4 apart walk both clusters'
    # subtrees: the union is longer than any one walk, the result the same
    ys, tree, summ = design_inputs("far", n, True)
    ref = bh_repulsion_sorted(ys, tree, summ, theta)
    got, union = warp_walk(ys, pack_nodes(tree, summ), summ.sum_y, tree.n_nodes, theta)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    if theta:
        assert int(union.max()) > int(ref.steps.max())
