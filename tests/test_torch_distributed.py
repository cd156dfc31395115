"""The port's multi-device path against the JAX package's.

The JAX references run once, in one subprocess with 8 forced host devices
(as ``tests/test_distributed.py`` runs them), and come back as an .npz;
the main pytest process keeps its single-device view of JAX.  The port
runs in-process on ``Mesh((cpu,) * S)``, the counterpart of those host
devices.  Inputs are made from a seed with numpy; every tolerance is
stated with its reason.  Index parity uses digits put on a quarter grid,
where squared distances are exact in fp32 in both packages (the
reference's pairwise does not clamp at 0 and the port's does; on exact
distances neither goes below 0).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.api import TSNE, make_backend  # noqa: E402
from repro_torch.core import attractive, morton, quadtree, repulsive  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core.knn import knn  # noqa: E402
from repro_torch.core.summarize import summarize  # noqa: E402
from repro_torch.core.tsne import (  # noqa: E402
    TsneConfig, bh_gradient, init_state, preprocess, tsne_step,
)
from repro_torch.data.datasets import make_dataset  # noqa: E402
from repro_torch.device import MESH_DEVICES_ENV  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import tsne_run  # noqa: E402
from repro_torch.neighbors import (  # noqa: E402
    ShardedNeighbors, available_neighbor_backends, make_neighbor_backend, recall_at_k,
)
from repro_torch.neighbors import sharded  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
T = torch.as_tensor

# the cases the JAX subprocess computes (and the port repeats)
GRAD_N, GRAD_K = 512, 12
TIE_ROWS, TIE_COPIES, TIE_K = 100, 5, 6
APPROX_CASES = {"s4": dict(shards=4, n=1792, n_valid=None),
                "s8_pad": dict(shards=8, n=1792, n_valid=1790)}
APPROX_K, APPROX_TREES, APPROX_LEAF, APPROX_BLOCK, APPROX_SEED = 10, 4, 24, 96, 3
RECALL_N, RECALL_K = 3000, 15
LAUNCH_N, LAUNCH_S, LAUNCH_STEPS, LAUNCH_PERPLEXITY = 512, 4, 20, 10.0

JAX_REFERENCES = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core import bsp, similarity, tsne
from repro.core.distributed import distributed_bh_gradient, ring_knn, ring_knn_approx
from repro.core.knn import knn
from repro.data.datasets import make_dataset
from repro.launch.tsne_run import _dist_step

GRAD_N, GRAD_K = {GRAD_N}, {GRAD_K}
TIE_ROWS, TIE_COPIES, TIE_K = {TIE_ROWS}, {TIE_COPIES}, {TIE_K}
APPROX_CASES = {APPROX_CASES!r}
APPROX_K, APPROX_TREES, APPROX_LEAF, APPROX_BLOCK, APPROX_SEED = (
    {APPROX_K}, {APPROX_TREES}, {APPROX_LEAF}, {APPROX_BLOCK}, {APPROX_SEED})
RECALL_N, RECALL_K = {RECALL_N}, {RECALL_K}
LAUNCH_N, LAUNCH_S, LAUNCH_STEPS, LAUNCH_PERPLEXITY = (
    {LAUNCH_N}, {LAUNCH_S}, {LAUNCH_STEPS}, {LAUNCH_PERPLEXITY})

assert len(jax.devices()) == 8, jax.devices()
mesh = lambda s: Mesh(np.asarray(jax.devices()[:s]), ("data",))
out = {{}}
grid, _ = make_dataset("digits")
grid = (np.round(grid * 4.0) / 4.0).astype(np.float32)

def draws(s, n_loc, d, k, n_trees, leaf_size, seed):
    # ring_knn_approx's per-rank forest draws (rp_forest._build_tree's)
    depth = max(0, int(np.floor(np.log2(max(1.0, n_loc / max(leaf_size, k + 1))))))
    return np.stack([np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(seed + r * 7919), t), (depth, d), jnp.float32))
        for t in range(n_trees)]) for r in range(s)])

# distributed_bh_gradient: tests/test_distributed.py's case
rng = np.random.default_rng(0)
x = rng.normal(size=(GRAD_N, 10)).astype(np.float32)
idx, d2 = knn(jnp.asarray(x), GRAD_K)
cond_p, _ = bsp.binary_search_perplexity(d2, 4.0)
cols, vals = similarity.symmetrize_ell(idx, cond_p)
y = rng.normal(size=(GRAD_N, 2)).astype(np.float32)
got = distributed_bh_gradient(mesh(8), jnp.asarray(y), jnp.asarray(cols),
                              jnp.asarray(vals, jnp.float32), 0.0, theta=0.5, exaggeration=2.0)
out.update(grad_y=y, grad_cols=np.asarray(cols), grad_vals=np.asarray(vals, np.float32),
           grad_g=np.asarray(got.grad), grad_kl=np.asarray(got.kl))

# ring_knn on random rows: tests/test_distributed.py's case
rng = np.random.default_rng(3)
x = rng.normal(size=(640, 16)).astype(np.float32)
i, d = ring_knn(mesh(8), jnp.asarray(x), 9)
out.update(ring_x=x, ring_idx=np.asarray(i), ring_d2=np.asarray(d))

# ring_knn on duplicated grid rows: the tie order
rows = grid[:TIE_ROWS]
for layout, xs in (("adjacent", np.repeat(rows, TIE_COPIES, 0)),
                   ("apart", np.tile(rows, (TIE_COPIES, 1)))):
    for s in (4, 8):
        xp = np.pad(xs, ((0, (-xs.shape[0]) % s), (0, 0)))
        i, d = ring_knn(mesh(s), jnp.asarray(xp), TIE_K, n_valid=xs.shape[0])
        out[f"ties_{{layout}}_{{s}}_idx"] = np.asarray(i)[:xs.shape[0]]
        out[f"ties_{{layout}}_{{s}}_d2"] = np.asarray(d)[:xs.shape[0]]

# ring_knn_approx on grid digits, with its draws
for name, c in APPROX_CASES.items():
    s, n, n_valid = c["shards"], c["n"], c["n_valid"]
    xs = grid[:n] if n_valid is None else np.pad(grid[:n_valid], ((0, n - n_valid), (0, 0)))
    i, d = ring_knn_approx(mesh(s), jnp.asarray(xs), APPROX_K, n_valid=n_valid,
                           n_trees=APPROX_TREES, leaf_size=APPROX_LEAF,
                           block_rows=APPROX_BLOCK, seed=APPROX_SEED)
    out[f"approx_{{name}}_dirs"] = draws(s, n // s, xs.shape[1], APPROX_K, APPROX_TREES,
                                          APPROX_LEAF, APPROX_SEED)
    out[f"approx_{{name}}_idx"] = np.asarray(i)
    out[f"approx_{{name}}_d2"] = np.asarray(d)

# ring_knn_approx recall: tests/test_distributed.py's case (sharded backend
# options shards=8, n_trees=8, leaf_size=32, block_rows=256, seed 0)
rng = np.random.default_rng(7)
x = rng.normal(size=(RECALL_N, 16)).astype(np.float32)
i, _ = ring_knn_approx(mesh(8), jnp.asarray(x), RECALL_K, n_trees=8, leaf_size=32,
                       block_rows=256, seed=0)
out.update(recall_x=x, recall_idx=np.asarray(i),
           recall_dirs=draws(8, RECALL_N // 8, 16, RECALL_K, 8, 32, 0))

# the launcher's sharded loop (repro/launch/tsne_run.py's main) on grid digits
x = grid[:LAUNCH_N]
cfg = tsne.TsneConfig(perplexity=LAUNCH_PERPLEXITY, n_iter=LAUNCH_STEPS)
m = mesh(LAUNCH_S)
idx, d2 = ring_knn(m, jnp.asarray(x), cfg.resolve_n_neighbors(LAUNCH_N))
cond_p, _ = bsp.binary_search_perplexity(d2, cfg.perplexity)
cols, vals = similarity.symmetrize_ell(np.asarray(idx), np.asarray(cond_p))
state = tsne.init_state(LAUNCH_N, cfg)
out.update(launch_x=x, launch_y0=np.asarray(state.y), launch_idx=np.asarray(idx),
           launch_cols=np.asarray(cols), launch_vals=np.asarray(vals, np.float32))
cols, vals = jnp.asarray(cols), jnp.asarray(vals, jnp.float32)
lr = cfg.resolve_lr(LAUNCH_N)
for it in range(LAUNCH_STEPS):
    exag = cfg.early_exaggeration if it < cfg.exaggeration_iters else 1.0
    mom = cfg.momentum_initial if it < cfg.momentum_switch_iter else cfg.momentum_final
    state, kl = _dist_step(state, cols, vals, mesh=m, theta=cfg.theta, exag=exag, mom=mom,
                           lr=lr, min_gain=cfg.min_gain)
out.update(launch_y=np.asarray(state.y), launch_kl=np.asarray(kl))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every JAX reference of this file, from one subprocess on 8 forced
    host devices."""
    path = tmp_path_factory.mktemp("jax_distributed") / "ref.npz"
    code = textwrap.dedent(JAX_REFERENCES).format(**globals())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, str(path)], capture_output=True,
                         text=True, env=env, timeout=900)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr[-4000:]}"
    with np.load(path) as f:
        return dict(f)


def cpu_mesh(s):
    return dist.Mesh((CPU,) * s)


def grid_digits():
    x, _ = make_dataset("digits")
    return (np.round(x * 4.0) / 4.0).astype(np.float32)


def sharded_call(fn, s, x, *args, **kwargs):
    """``fn(mesh, shards of x, ...)`` on s CPU shards, the result gathered."""
    mesh = cpu_mesh(s)
    idx, d2 = fn(mesh, dist.shard_rows(mesh, T(x)), *args, **kwargs)
    return dist.gather_rows(idx).numpy(), dist.gather_rows(d2).numpy()


def check_graph(idx, n):
    """Every index valid, no self, no duplicate in a row."""
    assert ((idx >= 0) & (idx < n)).all(), "pad or ghost index leaked"
    assert (idx != np.arange(idx.shape[0])[:, None]).all(), "self returned as neighbour"
    srt = np.sort(idx, axis=1)
    assert (srt[:, 1:] != srt[:, :-1]).all(), "duplicate neighbour in a row"


@pytest.fixture
def eight_cpus(monkeypatch):
    """The sharded backend sees 8 CPU devices (the forced host devices)."""
    monkeypatch.setattr(sharded, "visible_devices", lambda device: (CPU,) * 8)


# ------------------------------------------------------- mesh, collectives --

def test_mesh_and_collectives():
    mesh = dist.make_mesh(3, "cpu")
    assert mesh.size == 3 and mesh.devices == (CPU,) * 3
    x = torch.arange(12.0).reshape(6, 2)
    parts = dist.shard_rows(mesh, x)
    assert [p.shape for p in parts] == [(2, 2)] * 3
    assert torch.equal(dist.gather_rows(parts), x)
    assert all(torch.equal(g, x) for g in dist.all_gather(mesh, parts))
    total = dist.psum(mesh, [p.sum() for p in parts])
    assert [float(t) for t in total] == [66.0] * 3
    hop = dist.ring_permute(mesh, parts)       # rank r receives from r - 1
    assert [torch.equal(h, parts[(r - 1) % 3]) for r, h in enumerate(hop)] == [True] * 3
    with pytest.raises(ValueError, match="divisible"):
        dist.shard_rows(mesh, torch.zeros(7, 2))
    with pytest.raises(ValueError, match="at least one"):
        dist.Mesh(())


def test_make_mesh_needs_the_cards(monkeypatch):
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.make_mesh(2)                      # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 cards, but 1"):
        dist.make_mesh(2, "cuda")
    assert dist.make_mesh(1, "cuda").devices == (torch.device("cuda", 0),)


def test_shard_state_splits_a_carried_state():
    y = np.arange(16, dtype=np.float32).reshape(8, 2)
    state = convert.state_from_numpy(y, gains=2.0 * np.ones((8, 2)), iteration=3,
                                     device="cpu")
    parts = convert.shard_state(cpu_mesh(4), state)
    assert len(parts) == 4 and all(p.iteration == 3 for p in parts)
    assert torch.equal(torch.cat([p.y for p in parts]), state.y)
    assert all(torch.equal(p.gains, torch.full((2, 2), 2.0)) for p in parts)


# ------------------------------------------- the kernel changes' plain twins --

def walk_inputs(y):
    cent, r_span = morton.span_radius(y)
    codes_s, y_s, perm = quadtree.sort_points_by_code(y, morton.morton_encode(y, cent, r_span))
    tree = quadtree.build_quadtree(codes_s)
    return y_s, tree, summarize(tree, y_s, r_span), perm


@pytest.mark.parametrize("order", ["ascending", "shuffled", "subset", "one"])
@pytest.mark.parametrize("theta", [0.5, 0.0])
def test_walk_at_positions_gives_the_full_walks_rows(order, theta):
    rng = np.random.default_rng(5)
    y = T(rng.normal(size=(300, 2)).astype(np.float32) * 3.0)
    y_s, tree, summ, _ = walk_inputs(y)
    full = repulsive.bh_repulsion_sorted(y_s, tree, summ, theta)
    pos = {"ascending": np.arange(300), "shuffled": rng.permutation(300),
           "subset": np.sort(rng.choice(300, 75, replace=False)), "one": np.array([299])}[order]
    got = ops.bh_traverse(y_s, tree, summ, theta, pos=T(pos.astype(np.int32)))
    # each walk is the same operations on the same point: bit for bit
    for a, b in zip(got, full):
        assert torch.equal(a, b[T(pos)])


def test_walk_positions_are_checked():
    y_s, tree, summ, _ = walk_inputs(T(np.random.default_rng(1).normal(size=(20, 2)),
                                       dtype=torch.float32))
    with pytest.raises(ValueError, match=r"\[0, 20\)"):
        ops.bh_traverse(y_s, tree, summ, 0.5, pos=T(np.array([0, 20], np.int32)))
    with pytest.raises(TypeError, match="int32"):
        ops.bh_traverse(y_s, tree, summ, 0.5, pos=torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("with_len", [False, True])
def test_attractive_row_offset_gives_a_slice_of_the_full_pass(with_len):
    rng = np.random.default_rng(8)
    n, w = 96, 7
    y = T(rng.normal(size=(n, 2)).astype(np.float32))
    cols = T(rng.integers(0, n, size=(n, w)).astype(np.int32))
    vals = T(rng.uniform(0, 1e-2, size=(n, w)).astype(np.float32))
    lens = T(rng.integers(0, w + 1, size=n).astype(np.int32)) if with_len else None
    f_full, _ = ops.attractive_ell(y, cols, vals, lens)
    kls = []
    for r0, r1 in ((0, 32), (32, 64), (64, 96)):
        f, kl = ops.attractive_ell(y, cols[r0:r1], vals[r0:r1],
                                   None if lens is None else lens[r0:r1], row0=r0)
        # the same operations on the same rows: bit for bit
        assert torch.equal(f, f_full[r0:r1])
        kls.append(kl)
    _, kl_full = attractive.attractive_forces_ell(y, cols, vals, lens)
    # partial sums of the KL in another order
    np.testing.assert_allclose(float(sum(kls)), float(kl_full), rtol=1e-6)
    with pytest.raises(ValueError, match="row0"):
        ops.attractive_ell(y, cols[:32], vals[:32], row0=65)


# -------------------------------------------------- sharded BH gradient --

def test_distributed_gradient_matches_jax(ref):
    mesh = cpu_mesh(8)
    g = dist.distributed_bh_gradient(
        mesh, dist.shard_rows(mesh, T(ref["grad_y"])), dist.shard_rows(mesh, T(ref["grad_cols"])),
        dist.shard_rows(mesh, T(ref["grad_vals"])), 0.0, theta=0.5, exaggeration=2.0)
    # the reference test's bars (tests/test_distributed.py)
    np.testing.assert_allclose(dist.gather_rows(g.grad).numpy(), ref["grad_g"], rtol=2e-3,
                               atol=1e-6)
    np.testing.assert_allclose(float(g.kl), float(ref["grad_kl"]), rtol=1e-3)
    assert int(g.max_traversal) == 0


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_distributed_gradient_rows_match_bh_gradient(ref, shards):
    n = GRAD_N - GRAD_N % shards
    y, cols, vals = (T(ref[k][:n]) for k in ("grad_y", "grad_cols", "grad_vals"))
    # columns past the cut become padding (col = row)
    cols = torch.where(cols < n, cols, torch.arange(n, dtype=torch.int32)[:, None])
    mesh = cpu_mesh(shards)
    lens = T(np.full(n, cols.shape[1], np.int32))
    shards_of = [dist.shard_rows(mesh, t) for t in (cols, vals, lens)]
    parts = [dist.local_bh_gradient(y, r, n // shards, c, v, ln, theta=0.5)
             for r, (c, v, ln) in enumerate(zip(*shards_of))]
    y_s, tree, summ, perm = walk_inputs(y)
    rep = ops.bh_traverse(y_s, tree, summ, 0.5)
    f_rep = torch.empty_like(y)
    f_rep[perm] = rep.force
    # the same tree, the same positions: every row bit for bit
    assert torch.equal(torch.cat([p.f_rep for p in parts]), f_rep)
    g = dist.distributed_bh_gradient(mesh, dist.shard_rows(mesh, y), dist.shard_rows(mesh, cols),
                                     dist.shard_rows(mesh, vals), 0.25, theta=0.5,
                                     exaggeration=2.0, p_len=dist.shard_rows(mesh, lens))
    res = bh_gradient(y, cols, vals, None, 0.5, 2.0, 16, 0.25)
    grad = dist.gather_rows(g.grad)
    # Z and the KL are sums of per-shard partial sums: another order
    scale = float(res.grad.abs().max())
    assert float((grad - res.grad).abs().max()) <= 1e-6 * scale
    np.testing.assert_allclose(float(g.z), float(res.z), rtol=1e-6)
    np.testing.assert_allclose(float(g.kl), float(res.kl), rtol=1e-6)


# ---------------------------------------------------------------- ring KNN --

def test_ring_knn_matches_jax_on_random_rows(ref):
    idx, d2 = sharded_call(dist.ring_knn, 8, ref["ring_x"], 9)
    # the reference test's bars: distances to 1e-4, 99% of row sets the same
    # (fp32 distances in another order can swap near ties)
    np.testing.assert_allclose(d2, ref["ring_d2"], rtol=1e-4, atol=1e-4)
    same = [set(a) == set(b) for a, b in zip(idx, ref["ring_idx"])]
    assert np.mean(same) >= 0.99
    i1, d1 = knn(T(ref["ring_x"]), 9)
    np.testing.assert_allclose(np.sort(d2, 1), np.sort(d1.numpy(), 1), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("layout", ["adjacent", "apart"])
def test_ring_knn_breaks_ties_as_jax(ref, layout, shards):
    rows = grid_digits()[:TIE_ROWS]
    xs = np.repeat(rows, TIE_COPIES, 0) if layout == "adjacent" else np.tile(rows, (TIE_COPIES, 1))
    n = xs.shape[0]
    xp = np.pad(xs, ((0, (-n) % shards), (0, 0)))
    idx, d2 = sharded_call(dist.ring_knn, shards, xp, TIE_K, n_valid=n)
    # exact distances: the indices are the reference's, ties in its slot order
    np.testing.assert_array_equal(idx[:n], ref[f"ties_{layout}_{shards}_idx"])
    np.testing.assert_array_equal(d2[:n], ref[f"ties_{layout}_{shards}_d2"])


# ------------------------------------------------------ approximate ring --

@pytest.mark.parametrize("case", sorted(APPROX_CASES))
def test_ring_knn_approx_matches_jax_given_its_draws(ref, case):
    c = APPROX_CASES[case]
    s, n, n_valid = c["shards"], c["n"], c["n_valid"]
    x = grid_digits()
    xs = x[:n] if n_valid is None else np.pad(x[:n_valid], ((0, n - n_valid), (0, 0)))
    dirs = [T(d) for d in ref[f"approx_{case}_dirs"]]
    idx, d2 = sharded_call(dist.ring_knn_approx_with_draws, s, xs, APPROX_K, dirs,
                           n_valid=n_valid, leaf_size=APPROX_LEAF, block_rows=APPROX_BLOCK)
    np.testing.assert_array_equal(idx, ref[f"approx_{case}_idx"])
    np.testing.assert_array_equal(d2, ref[f"approx_{case}_d2"])
    check_graph(idx[:n_valid or n], n_valid or n)


def test_ring_knn_approx_recall_given_jax_draws(ref):
    x = ref["recall_x"]
    dirs = [T(d) for d in ref["recall_dirs"]]
    idx, _ = sharded_call(dist.ring_knn_approx_with_draws, 8, x, RECALL_K, dirs,
                          leaf_size=32, block_rows=256)
    exact, _ = sharded_call(dist.ring_knn, 8, x, RECALL_K)
    check_graph(idx, RECALL_N)
    # the reference test's bar
    assert recall_at_k(exact, idx) >= 0.90
    # the same draws on random rows: fp32 in another order may swap near ties
    assert recall_at_k(ref["recall_idx"], idx) >= 0.99


def test_ring_knn_approx_draws_per_rank():
    x = T(grid_digits()[:896])
    mesh = cpu_mesh(4)
    parts = dist.shard_rows(mesh, x)
    a = dist.ring_knn_approx(mesh, parts, 8, n_trees=3, leaf_size=20, seed=5)
    depth, _ = dist.approx_forest_shape(224, 8, 20)
    dirs = [torch.randn((3, depth, 64), generator=torch.Generator().manual_seed(5 + r * 7919))
            for r in range(4)]
    b = dist.ring_knn_approx_with_draws(mesh, parts, 8, dirs, leaf_size=20)
    assert all(torch.equal(u, v) for u, v in zip(a[0] + a[1], b[0] + b[1]))
    with pytest.raises(ValueError, match="must exceed k"):
        dist.ring_knn_approx(mesh, parts, 224)


# ------------------------------------------------------- sharded backend --

@pytest.mark.parametrize("n", [RECALL_N, RECALL_N - 1])
@pytest.mark.parametrize("mode", ["approx", "exact"])
def test_sharded_backend_through_the_registry(eight_cpus, mode, n):
    x = np.random.default_rng(7).normal(size=(RECALL_N, 16)).astype(np.float32)[:n]
    nb = make_neighbor_backend("sharded", dict(mode=mode, shards=8, n_trees=8, leaf_size=32,
                                               block_rows=256))
    assert isinstance(nb, ShardedNeighbors) and nb.resolve_shards(n, RECALL_K, CPU) == 8
    idx, d2 = nb.neighbors(T(x), RECALL_K)
    assert idx.shape == (n, RECALL_K) and d2.shape == (n, RECALL_K)
    check_graph(idx.numpy(), n)          # n = 2 999 pads one row: it must never appear
    ref_i, ref_d = knn(T(x), RECALL_K)
    if mode == "exact":
        np.testing.assert_allclose(d2.numpy(), ref_d.numpy(), rtol=1e-4, atol=1e-4)
        assert recall_at_k(ref_i.numpy(), idx.numpy()) >= 0.999
    else:
        assert recall_at_k(ref_i.numpy(), idx.numpy()) >= 0.90


def test_sharded_backend_shards(eight_cpus):
    assert "sharded" in available_neighbor_backends()
    nb = ShardedNeighbors()
    assert nb.resolve_shards(4000, 15, CPU) == 8           # all visible
    assert ShardedNeighbors(shards=8).resolve_shards(40, 5, CPU) == 5    # n // (k + 2)
    assert ShardedNeighbors(shards=3).resolve_shards(40, 5, CPU) == 3
    with pytest.raises(ValueError, match="shards=9 but only 8"):
        ShardedNeighbors(shards=9).neighbors(torch.zeros((100, 3)), 5)
    with pytest.raises(ValueError, match="unknown sharded mode"):
        ShardedNeighbors(mode="ring")


def test_sharded_backend_sees_one_cpu():
    assert sharded.visible_devices(CPU) == (CPU,)
    with pytest.raises(ValueError, match="shards=2 but only 1"):
        ShardedNeighbors(shards=2).neighbors(torch.zeros((100, 3)), 5)
    idx, _ = ShardedNeighbors(leaf_size=16).neighbors(T(grid_digits()[:300]), 10)
    check_graph(idx.numpy(), 300)


def test_knn_shards_reaches_the_backend():
    cfg = TsneConfig(neighbor_method="sharded", knn_shards=2, seed=4)
    assert cfg.resolve_neighbor_options() == {"seed": 4, "shards": 2}
    assert TsneConfig(neighbor_method="sharded").resolve_neighbor_options() == \
        {"seed": 0, "shards": None}
    est = TSNE(neighbor_method="sharded", backend_options={"knn_shards": 2}, device="cpu")
    assert est._build_config().knn_shards == 2


def test_sharded_preprocess(eight_cpus):
    # tests/test_distributed.py's case and its graph invariants
    x = np.random.default_rng(11).normal(size=(2048, 8)).astype(np.float32)
    cfg = TsneConfig(perplexity=10.0, neighbor_method="sharded", knn_shards=8,
                     chunk_size=500)
    graph, timings = preprocess(T(x), cfg)
    assert timings["neighbor_method"] == "sharded"
    assert timings["chunk_size"] == 500
    vals = graph.p_vals.numpy()
    assert np.isfinite(vals).all() and (vals >= 0).all()
    np.testing.assert_allclose(vals.sum(), 1.0, rtol=1e-4)
    cols = graph.p_cols.numpy()
    assert ((cols >= 0) & (cols < 2048)).all()


# ---------------------------------------------------------------- launcher --

def test_run_distributed_matches_jax_loop(ref):
    cfg = TsneConfig(perplexity=LAUNCH_PERPLEXITY, n_iter=LAUNCH_STEPS)
    run = tsne_run.run_distributed(cpu_mesh(LAUNCH_S), ref["launch_x"], cfg, LAUNCH_STEPS,
                                   y0=ref["launch_y0"])
    assert run.n == LAUNCH_N and run.kl_history == []
    # exact grid distances: the same neighbours as the reference's launcher
    idx, _ = sharded_call(dist.ring_knn, LAUNCH_S, ref["launch_x"],
                          cfg.resolve_n_neighbors(LAUNCH_N))
    np.testing.assert_array_equal(idx, ref["launch_idx"])
    # 20 exaggerated steps from a 1e-4-wide start amplify last-bit
    # differences: from JAX's own graph, the port's single-device descent
    # ends 2.0e-3 of the map's span from JAX's sharded loop (the two
    # packages' BH arithmetic; JAX's own 4-shard and 1-shard loops end
    # 2.2e-5 apart, and the port's, test_dist_step_matches_single_device,
    # 1e-5).  Measured here: 1.2e-3.  Bar: 5e-3 of the span.
    span = float(np.abs(ref["launch_y"]).max())
    assert float(np.abs(run.y - ref["launch_y"]).max()) <= 5e-3 * span
    # the full KL (sum p log p added back; the loop leaves it out), fp32
    # sums in another order: measured 2.5e-7
    np.testing.assert_allclose(run.kl + run.p_logp, float(ref["launch_kl"]) + run.p_logp,
                               rtol=1e-5)


def test_dist_step_matches_single_device_descent(ref):
    """The sharded step against the port's own single-device step from JAX's
    graph and start: only the order of the sharded sums (Z, the KL, the
    mean) differs, so the two stay close where the packages do not."""
    g = convert.graph_from_numpy(ref["launch_cols"], ref["launch_vals"], 0.0, device="cpu")
    state = convert.state_from_numpy(ref["launch_y0"], device="cpu")
    mesh = cpu_mesh(LAUNCH_S)
    states = convert.shard_state(mesh, state)
    cols, vals, lens = (dist.shard_rows(mesh, t) for t in (g.p_cols, g.p_vals, g.p_len))
    backend = make_backend("barnes_hut", TsneConfig(), LAUNCH_N)
    for _ in range(LAUNCH_STEPS):
        state, stats = tsne_step(state, g, 12.0, 0.5, backend=backend, lr=50.0, min_gain=0.01)
        states, kl = tsne_run.dist_step(mesh, states, cols, vals, lens, theta=0.5, exag=12.0,
                                        mom=0.5, lr=50.0, min_gain=0.01)
    # measured 1e-5 of the span after 20 steps (2.2e-5 between JAX's own
    # 4-shard and 1-shard loops)
    y = dist.gather_rows([s.y for s in states])
    span = float(state.y.abs().max())
    assert float((y - state.y).abs().max()) <= 1e-4 * span
    assert all(s.iteration == LAUNCH_STEPS for s in states)
    np.testing.assert_allclose(float(kl), float(stats.kl), rtol=1e-6)


def test_run_distributed_reads_kl_every_100_steps():
    x, _ = make_dataset("digits", n=130)
    cfg = TsneConfig(perplexity=5.0)
    run = tsne_run.run_distributed(cpu_mesh(4), x, cfg, 101)
    assert run.n == 128 and run.y.shape == (128, 2) and np.isfinite(run.y).all()
    assert [it for it, _ in run.kl_history] == [100] and np.isfinite(run.kl)
    assert set(run.timings) == {"knn", "bsp", "symmetrize", "descent"}
    state = init_state(128, cfg, "cpu")
    again = tsne_run.run_distributed(cpu_mesh(4), x, cfg, 101, y0=state.y.numpy())
    np.testing.assert_array_equal(again.y, run.y)      # init_state's draw by default


def test_tsne_run_devices_on_cpu(tmp_path, capsys):
    out = tmp_path / "emb.npy"
    tsne_run.main(["--device", "cpu", "--devices", "4", "--n", "258", "--iters", "100",
                   "--perplexity", "10", "--out", str(out)])
    emb = np.load(out)
    assert emb.shape == (256, 2) and np.isfinite(emb).all()
    printed = capsys.readouterr().out
    assert "iter 100 KL" in printed and "4 shards, n=256" in printed


# ------------------------------------------------- the launches on the card --

def test_traverse_launch_passes_the_positions(monkeypatch):
    # the walk at positions: pos's pointer, M walks over N points
    launches = []
    monkeypatch.setattr(ops, "_launch", lambda *a: launches.append(a))
    y_s, tree, summ, _ = walk_inputs(T(np.random.default_rng(2).normal(size=(40, 2)),
                                       dtype=torch.float32))
    pos = T(np.array([3, 17, 30], np.int32))
    res = ops.bh_traverse_cuda(y_s, tree, summ, 0.5, pos=pos)
    (name, source, _, *args), = launches
    assert (name, source) == ("bh_traverse", "traverse")
    assert args[10] == pos.data_ptr() and args[-3:] == [3, 40, tree.capacity]
    assert res.force.shape == (3, 2) and res.steps.shape == (3,)


def test_attractive_launch_passes_the_row_offset(monkeypatch):
    launches = []
    monkeypatch.setattr(ops, "_launch", lambda *a: launches.append(a))
    y = torch.zeros((10, 2))
    cols = torch.zeros((4, 3), dtype=torch.int32)
    f, _ = ops.attractive_ell_cuda(y, cols, torch.zeros((4, 3)), None, 6)
    (name, source, _, *args), = launches
    assert (name, source) == ("attractive_ell", "attractive")
    assert args[3] is None and args[-3:] == [4, 3, 6] and f.shape == (4, 2)


# ---------------------------------------------------- the forced mesh size --

FORCED_N, FORCED_K, FORCED_PERPLEXITY = 600, 10, 3.0

FORCED_REFERENCE = """
import sys
import jax, numpy as np
from repro.core.tsne import TsneConfig, preprocess
from repro.data.datasets import make_dataset
from repro.neighbors import ShardedNeighbors

S = int(sys.argv[2])
assert len(jax.devices()) == S, jax.devices()
grid, _ = make_dataset("digits")
x = (np.round(grid * 4.0) / 4.0).astype(np.float32)[:{FORCED_N}]
idx, d2 = ShardedNeighbors(mode="exact").neighbors(x, {FORCED_K})   # shards=None: all S
cfg = TsneConfig(perplexity={FORCED_PERPLEXITY}, neighbor_method="sharded", knn_shards=S,
                 neighbor_options={{"mode": "exact"}})
graph, _ = preprocess(x, cfg)
np.savez(sys.argv[1], idx=np.asarray(idx), d2=np.asarray(d2),
         cols=np.asarray(graph.p_cols), vals=np.asarray(graph.p_vals))
"""


@pytest.fixture(scope="module")
def forced_ref(tmp_path_factory):
    """JAX's sharded neighbours and preprocess on S = 2 and 4 forced host
    devices, one subprocess each."""
    out = {}
    for s in (2, 4):
        path = tmp_path_factory.mktemp(f"jax_forced_{s}") / "ref.npz"
        env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={s}",
                   PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        run = subprocess.run([sys.executable, "-c", FORCED_REFERENCE.format(**globals()),
                              str(path), str(s)], capture_output=True, text=True, env=env,
                             timeout=600)
        assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr[-4000:]}"
        with np.load(path) as f:
            out[s] = dict(f)
    return out


@pytest.fixture
def forced(monkeypatch):
    """Sets the forced mesh size for one test (unset again afterwards)."""
    def force(s):
        monkeypatch.setenv(MESH_DEVICES_ENV, str(s))
    monkeypatch.delenv(MESH_DEVICES_ENV, raising=False)
    return force


@pytest.mark.parametrize("s", [2, 4])
def test_forced_mesh_size_matches_jax_host_devices(forced_ref, forced, s):
    forced(s)
    assert sharded.visible_devices(CPU) == (CPU,) * s
    assert ShardedNeighbors().resolve_shards(FORCED_N, FORCED_K, CPU) == s
    x = T(grid_digits()[:FORCED_N])
    idx, d2 = ShardedNeighbors(mode="exact").neighbors(x, FORCED_K)
    np.testing.assert_array_equal(idx.numpy(), forced_ref[s]["idx"])
    # exact grid distances: equal in both packages
    np.testing.assert_array_equal(d2.numpy(), forced_ref[s]["d2"])


@pytest.mark.parametrize("s", [2, 4])
def test_knn_shards_preprocess_under_forced_mesh_matches_jax(forced_ref, forced, s):
    forced(s)
    cfg = TsneConfig(perplexity=FORCED_PERPLEXITY, neighbor_method="sharded", knn_shards=s,
                     neighbor_options={"mode": "exact"})
    graph, timings = preprocess(T(grid_digits()[:FORCED_N]), cfg)
    assert timings["neighbor_method"] == "sharded"
    np.testing.assert_array_equal(graph.p_cols.numpy(), forced_ref[s]["cols"])
    # symmetrization is bit-identical; bsp agrees to its rtol=1e-5
    np.testing.assert_allclose(graph.p_vals.numpy(), forced_ref[s]["vals"], rtol=1e-5,
                               atol=1e-9)


def test_knn_shards_default_mode_runs_under_forced_mesh(forced):
    forced(2)
    cfg = TsneConfig(perplexity=10.0, neighbor_method="sharded", knn_shards=2)
    graph, _ = preprocess(T(grid_digits()[:400]), cfg)
    np.testing.assert_allclose(float(graph.p_vals.sum()), 1.0, rtol=1e-4)
    assert ((graph.p_cols >= 0) & (graph.p_cols < 400)).all()


def test_forced_mesh_repeats_one_card(forced, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    forced(4)
    card = torch.device("cuda", 0)
    assert dist.make_mesh(4).devices == (card,) * 4
    assert dist.make_mesh(2, "cuda").devices == (card,) * 2
    assert sharded.visible_devices(card) == (card,) * 4
    with pytest.raises(ValueError, match="needs 5 cards, but 4"):
        dist.make_mesh(5)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dist.make_mesh(4).devices == tuple(torch.device("cuda", i) for i in (0, 1, 0, 1))
    forced(3)
    assert dist.make_mesh(3, "cpu").devices == (CPU,) * 3
    with pytest.raises(ValueError, match="needs 4 CPU devices, but 3"):
        dist.make_mesh(4, "cpu")
    forced(0)
    with pytest.raises(ValueError, match=MESH_DEVICES_ENV):
        dist.make_mesh(1, "cpu")


def test_tsne_run_devices_under_forced_mesh(forced, tmp_path, capsys):
    forced(4)
    out = tmp_path / "emb.npy"
    tsne_run.main(["--device", "cpu", "--devices", "4", "--n", "258", "--iters", "100",
                   "--perplexity", "10", "--out", str(out)])
    assert np.load(out).shape == (256, 2)
    assert "4 shards, n=256" in capsys.readouterr().out
