"""The port's FFT repulsion (FIt-SNE backend) against the JAX package.

Inputs are made from a seed with numpy and handed to both packages; the
port runs on the CPU, where ``ops.fft_spread`` / ``ops.fft_gather`` run
the plain versions of the CUDA kernels.  The JAX side runs its jnp
oracles and its Pallas kernels in interpret mode, as ``tests/test_kernels.py``
runs them.  Every tolerance is stated with its reason.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api.backends import FFTBackend as JFFTBackend  # noqa: E402
from repro.core import fft_repulsion as jfft  # noqa: E402
from repro.core.tsne import NeighborGraph as JNeighborGraph  # noqa: E402
from repro.kernels.interp_kernel import (  # noqa: E402
    gather_from_grid_pallas, spread_to_grid_pallas,
)
from repro_torch import convert  # noqa: E402
from repro_torch.api import FFTBackend  # noqa: E402
from repro_torch.core import fft_repulsion as fft  # noqa: E402
from repro_torch.core.exact import exact_repulsion  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

T = torch.as_tensor


def spread_points(n, scale, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 2)) * scale).astype(np.float32)


def planted(n_boxes=4, n_ch=3, n=40):
    """Points exactly on lattice nodes: one-hot Lagrange weights and
    integer charges, so spread and gather are exact integer sums in any
    order (the case of tests/test_kernels.py)."""
    nodes = n_boxes * (fft.P_ORDER - 1) + 1
    rng = np.random.default_rng(0)
    base = rng.integers(0, n_boxes, size=(n, 2)).astype(np.int32) * 2
    taps = rng.integers(0, fft.P_ORDER, size=(n, 2))
    wx = np.zeros((n, 3), np.float32)
    wy = np.zeros((n, 3), np.float32)
    wx[np.arange(n), taps[:, 0]] = 1.0
    wy[np.arange(n), taps[:, 1]] = 1.0
    charges = rng.integers(1, 5, size=(n, n_ch)).astype(np.float32)
    return nodes, base, wx, wy, charges, taps


# ------------------------------------------------------------ interp_coords --

@pytest.mark.parametrize("n,n_boxes,scale", [(50, 16, 5.0), (700, 48, 20.0),
                                             (1500, 64, 1e-4), (3000, 128, 8.0)])
def test_interp_coords_match_jax(n, n_boxes, scale):
    y = spread_points(n, scale, n)
    jbase, jwx, jwy, jh = jfft.interp_coords(jnp.asarray(y), n_boxes)
    base, wx, wy, h = fft.interp_coords(T(y), n_boxes)
    assert base.dtype == torch.int32 and wx.shape == (n, 3)
    # the same fp32 ops in the same order: boxes identical, weights (in
    # [-0.125, 1]) to 1e-6
    np.testing.assert_array_equal(base.numpy(), np.asarray(jbase))
    np.testing.assert_allclose(wx.numpy(), np.asarray(jwx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(wy.numpy(), np.asarray(jwy), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(h), float(jh), rtol=1e-7)
    # the Lagrange weights of a point sum to 1
    np.testing.assert_allclose(wx.sum(1).numpy(), 1.0, rtol=1e-5)


# ----------------------------------------------------------- spread / gather --

def test_spread_exact_on_planted_grid():
    nodes, base, wx, wy, charges, taps = planted()
    expected = np.zeros((nodes, nodes, 3), np.float32)
    for i in range(base.shape[0]):
        expected[base[i, 0] + taps[i, 0], base[i, 1] + taps[i, 1]] += charges[i]
    out = ops.fft_spread(T(base), T(wx), T(wy), T(charges), nodes).numpy()
    j_args = tuple(jnp.asarray(a) for a in (base, wx, wy, charges))
    np.testing.assert_array_equal(out, expected)
    np.testing.assert_array_equal(out, np.asarray(jfft.spread_to_grid(*j_args, nodes)))
    np.testing.assert_array_equal(out, np.asarray(spread_to_grid_pallas(*j_args, nodes)))


def test_gather_exact_on_planted_grid():
    nodes, base, wx, wy, _charges, taps = planted()
    rng = np.random.default_rng(1)
    pot = rng.integers(-9, 9, size=(nodes, nodes, 4)).astype(np.float32)
    expected = pot[base[:, 0] + taps[:, 0], base[:, 1] + taps[:, 1]]
    out = ops.fft_gather(T(pot), T(base), T(wx), T(wy)).numpy()
    j_args = tuple(jnp.asarray(a) for a in (pot, base, wx, wy))
    np.testing.assert_array_equal(out, expected)
    np.testing.assert_array_equal(out, np.asarray(jfft.gather_from_grid(*j_args)))
    np.testing.assert_array_equal(out, np.asarray(gather_from_grid_pallas(*j_args)))


def _interp_case(n, n_boxes):
    rng = np.random.default_rng(n)
    y = (rng.normal(size=(n, 2)) * 5).astype(np.float32)
    nodes = n_boxes * (fft.P_ORDER - 1) + 1
    base, wx, wy, _ = fft.interp_coords(T(y), n_boxes)
    charges = np.stack([np.ones(n, np.float32), y[:, 0], y[:, 1]], axis=1)
    pot = rng.normal(size=(nodes, nodes, 4)).astype(np.float32)
    return nodes, base.numpy(), wx.numpy(), wy.numpy(), charges, pot


# N = 127, 128, 129: either side of a CTA of the CUDA gather (128 points)
@pytest.mark.parametrize("n,n_boxes", [(50, 16), (700, 48), (1500, 64), (1, 16), (259, 48),
                                       (127, 16), (128, 16), (129, 48)])
def test_interp_matches_jax_oracle_and_pallas(n, n_boxes):
    nodes, base, wx, wy, charges, pot = _interp_case(n, n_boxes)
    g = ops.fft_spread(T(base), T(wx), T(wy), T(charges), nodes).numpy()
    ph = ops.fft_gather(T(pot), T(base), T(wx), T(wy)).numpy()
    jb, jwx, jwy = jnp.asarray(base), jnp.asarray(wx), jnp.asarray(wy)
    # the same products summed in another order (index_add_ vs XLA's
    # scatter vs the MXU's one-hot products): the tolerance of
    # tests/test_kernels.py
    for ref in (jfft.spread_to_grid(jb, jwx, jwy, jnp.asarray(charges), nodes),
                spread_to_grid_pallas(jb, jwx, jwy, jnp.asarray(charges), nodes)):
        np.testing.assert_allclose(g, np.asarray(ref), rtol=1e-4, atol=1e-5)
    for ref in (jfft.gather_from_grid(jnp.asarray(pot), jb, jwx, jwy),
                gather_from_grid_pallas(jnp.asarray(pot), jb, jwx, jwy)):
        np.testing.assert_allclose(ph, np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_interp_at_max_boxes_matches_jax_oracle():
    # 128 boxes: the largest lattice, 65 bands of the CUDA spread kernel
    nodes, base, wx, wy, charges, pot = _interp_case(4000, fft.MAX_N_BOXES)
    assert nodes == 257
    g = ops.fft_spread(T(base), T(wx), T(wy), T(charges), nodes).numpy()
    ph = ops.fft_gather(T(pot), T(base), T(wx), T(wy)).numpy()
    jb, jwx, jwy = jnp.asarray(base), jnp.asarray(wx), jnp.asarray(wy)
    np.testing.assert_allclose(
        g, np.asarray(jfft.spread_to_grid(jb, jwx, jwy, jnp.asarray(charges), nodes)),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        ph, np.asarray(jfft.gather_from_grid(jnp.asarray(pot), jb, jwx, jwy)),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_ch", [3, 4])
def test_interp_skips_off_lattice_taps(n_ch):
    # boxes that hang over either edge of the lattice: the CUDA kernels skip
    # the taps that fall off it, and so must the plain versions
    n_boxes, n = 4, 200
    nodes = fft.lattice_nodes(n_boxes)
    rng = np.random.default_rng(5)
    base = (rng.integers(-1, n_boxes + 1, size=(n, 2)) * 2).astype(np.int32)
    wx = rng.uniform(-0.2, 1, size=(n, 3)).astype(np.float32)
    wy = rng.uniform(-0.2, 1, size=(n, 3)).astype(np.float32)
    charges = rng.normal(size=(n, n_ch)).astype(np.float32)
    pot = rng.normal(size=(nodes, nodes, 4)).astype(np.float32)
    grid = np.zeros((nodes, nodes, n_ch), np.float64)
    phi = np.zeros((n, 4), np.float64)
    for i in range(n):
        for a in range(3):
            for b in range(3):
                gx, gy = base[i, 0] + a, base[i, 1] + b
                if 0 <= gx < nodes and 0 <= gy < nodes:
                    w = float(wx[i, a]) * float(wy[i, b])
                    grid[gx, gy] += w * charges[i]
                    phi[i] += w * pot[gx, gy]
    assert (base < 0).any() and (base > nodes - 3).any()
    out = ops.fft_spread(T(base), T(wx), T(wy), T(charges), nodes).numpy()
    # fp32 sums of a few products against float64: rtol 1e-5 with a floor
    np.testing.assert_allclose(out, grid, rtol=1e-5, atol=1e-5)
    ph = ops.fft_gather(T(pot), T(base), T(wx), T(wy)).numpy()
    np.testing.assert_allclose(ph, phi, rtol=1e-5, atol=1e-5)


def test_gather_cuda_rejects_a_misaligned_potential():
    # the kernel reads a tap as one float4: a potential at no 16-byte
    # boundary is refused before anything is launched
    nodes, base, wx, wy, _charges, pot = _interp_case(50, 16)
    flat = torch.zeros(pot.size + 1)
    shifted = flat[1:].view(pot.shape)
    shifted.copy_(T(pot))
    assert shifted.data_ptr() % 16
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.fft_gather_cuda(shifted, T(base), T(wx), T(wy))
    assert ops.LAUNCHES["fft_gather"] == 0


# -------------------------------------------------------------- fft_repulsion --

@pytest.mark.parametrize("n,n_boxes,scale,impls", [
    (600, 48, 8.0, ("xla", "pallas")),
    (5000, 48, 20.0, ("xla",)),
    (2000, 128, 5.0, ("xla", "pallas")),
    (3000, 48, 1e-4, ("xla",)),
])
def test_fft_repulsion_matches_jax(n, n_boxes, scale, impls):
    y = spread_points(n, scale, n + n_boxes)
    f, z = fft.fft_repulsion(T(y), n_boxes=n_boxes)
    for impl in impls:
        jf, jz = jfft.fft_repulsion(jnp.asarray(y), n_boxes=n_boxes, interp_impl=impl)
        jf = np.asarray(jf)
        # pocketfft vs XLA's FFT and another scatter order: the Pallas-vs-XLA
        # tolerance of tests/test_kernels.py for forces; z to 1e-5 relative
        scale_f = float(np.abs(jf).max())
        np.testing.assert_allclose(f.numpy(), jf, rtol=1e-3, atol=1e-4 * scale_f)
        np.testing.assert_allclose(float(z), float(jz), rtol=1e-5)


@pytest.mark.parametrize("n,boxes,tol", [(500, 48, 0.05), (2000, 96, 0.01)])
def test_fft_repulsion_matches_exact(n, boxes, tol):
    # the accuracy bars of tests/test_fft_repulsion.py, on the port's own
    # exact O(N^2) repulsion
    rng = np.random.default_rng(0)
    y = T(rng.normal(size=(n, 2)).astype(np.float32) * 5)
    f, z = fft.fft_repulsion(y, n_boxes=boxes)
    fe, ze = exact_repulsion(y)
    assert abs(float(z) - float(ze)) / float(ze) < tol
    num = torch.linalg.norm(f - fe, dim=1)
    den = torch.linalg.norm(fe, dim=1) + 1e-9
    assert float(torch.mean(num / den)) < tol


def test_fft_repulsion_clustered_matches_exact():
    rng = np.random.default_rng(1)
    c = rng.normal(size=(4, 2)) * 8
    y = T((c[rng.integers(0, 4, 800)] + rng.normal(size=(800, 2)) * 0.3).astype(np.float32))
    f, z = fft.fft_repulsion(y, n_boxes=96)
    fe, ze = exact_repulsion(y)
    assert abs(float(z) - float(ze)) / float(ze) < 0.02
    np.testing.assert_allclose(f.sum(0).numpy(), fe.sum(0).numpy(), rtol=0.1, atol=1e-2)


def test_fft_repulsion_errors():
    y = T(spread_points(20, 1.0, 0))
    with pytest.raises(ValueError, match="MAX_N_BOXES"):
        fft.fft_repulsion(y, n_boxes=fft.MAX_N_BOXES + 1)
    with pytest.raises(ValueError, match="MAX_N_BOXES"):
        fft.fft_repulsion(y, n_boxes=0)
    assert fft.lattice_nodes(48) == 97 and fft.lattice_nodes(fft.MAX_N_BOXES) == 257


# ---------------------------------------------------------------- backend --

def test_fft_backend_gradient_matches_jax():
    rng = np.random.default_rng(3)
    n, w = 800, 12
    y = (rng.normal(size=(n, 2)) * 6).astype(np.float32)
    cols = rng.integers(0, n, size=(n, w)).astype(np.int32)
    vals = rng.uniform(0, 1, size=(n, w)).astype(np.float32)
    vals /= vals.sum()
    p_logp = float((vals * np.log(vals)).sum())
    jgraph = JNeighborGraph(
        p_cols=jnp.asarray(cols), p_vals=jnp.asarray(vals),
        edge_src=jnp.zeros((1,), jnp.int32), edge_dst=jnp.zeros((1,), jnp.int32),
        edge_w=jnp.zeros((1,), jnp.float32), p_logp=jnp.float32(p_logp), n=n)
    graph = convert.graph_from_numpy(cols, vals, p_logp, device="cpu")
    for exag in (12.0, 1.0):
        jres = JFFTBackend(n_boxes=48).gradient(jnp.asarray(y), jgraph, exag)
        res = FFTBackend(n_boxes=48).gradient(T(y), graph, exag)
        jgrad = np.asarray(jres.grad)
        # repulsion to rtol 1e-3 (see test_fft_repulsion_matches_jax), the
        # attractive part to 1e-5: the gradient to rtol 1e-3 with a floor
        # at 1e-4 of its largest entry; Z and KL to 1e-5
        np.testing.assert_allclose(res.grad.numpy(), jgrad, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(jgrad).max()))
        np.testing.assert_allclose(float(res.z), float(jres.z), rtol=1e-5)
        np.testing.assert_allclose(float(res.kl), float(jres.kl), rtol=1e-5)
        assert int(res.max_traversal) == 0


# ---------------------------------------------------------------- wrappers --

def test_fft_wrappers_on_cpu_count_no_launch():
    ops.reset_launch_counts()
    nodes, base, wx, wy, charges, pot = _interp_case(300, 16)
    ops.fft_spread(T(base), T(wx), T(wy), T(charges), nodes)
    ops.fft_gather(T(pot), T(base), T(wx), T(wy))
    fft.fft_repulsion(T(spread_points(100, 3.0, 0)), n_boxes=16)
    assert ops.LAUNCHES["fft_spread"] == ops.LAUNCHES["fft_gather"] == 0


def test_spread_of_no_points_is_zero():
    # the kernel writes every node, points or none; the plain twin agrees
    grid = ops.fft_spread(torch.zeros((0, 2), dtype=torch.int32), torch.zeros((0, 3)),
                          torch.zeros((0, 3)), torch.zeros((0, 3)), 97)
    assert grid.shape == (97, 97, 3) and not grid.any()


# ------------------------------------------------------------ spread plan --

@pytest.mark.parametrize("n", [1, 500, 70_000])
def test_spread_plan_covers_the_lattice(n):
    for n_boxes in range(1, fft.MAX_N_BOXES + 1):
        nodes = fft.lattice_nodes(n_boxes)
        plan = ops.spread_plan(n, nodes)
        rows = plan.rows_per_band
        bands = -(-nodes // rows)
        # band b owns rows [b R, min((b + 1) R, nodes)): every row once
        owned = [r for b in range(bands) for r in range(b * rows, min((b + 1) * rows, nodes))]
        assert owned == list(range(nodes))
        assert 1 <= plan.slices <= ops.SPREAD_MAX_SLICES       # one portable cluster
        assert 1 <= plan.warps <= ops.SPREAD_WARPS
        assert plan.smem_bytes == ops.spread_smem_bytes(nodes, 3, rows, plan.warps)
        assert plan.smem_bytes <= ops.SMEM_LIMIT == 227 * 1024
        # a slice gives every warp some points; one slice for few points
        assert plan.slices == 1 or n >= (plan.slices - 1) * ops.SPREAD_POINTS_A_WARP * plan.warps


def test_spread_plan_fills_the_h100_at_the_main_path():
    # MNIST size at the default 48 boxes: at least one CTA for each of
    # the H100's 132 SMs, two CTAs an SM by shared memory
    plan = ops.spread_plan(70_000, fft.lattice_nodes(48))
    assert plan.slices * -(-fft.lattice_nodes(48) // plan.rows_per_band) >= 132
    assert plan.smem_bytes <= ops.SMEM_TWO_A_SM
    # the largest lattice keeps two CTAs an SM with fewer warps
    big = ops.spread_plan(70_000, fft.lattice_nodes(fft.MAX_N_BOXES))
    assert big.smem_bytes <= ops.SMEM_TWO_A_SM and big.warps < plan.warps


def test_spread_plan_rejects_what_the_kernel_cannot_run():
    # a band row of 150 channels on the largest lattice is over a block's
    # shared memory with one warp
    with pytest.raises(ValueError, match="shared memory"):
        ops.spread_plan(100, fft.lattice_nodes(fft.MAX_N_BOXES), channels=150)


def test_fft_wrappers_reject_bad_inputs():
    nodes, base, wx, wy, charges, pot = _interp_case(30, 8)
    b, x, yw, ch, p = T(base), T(wx), T(wy), T(charges), T(pot)
    with pytest.raises(TypeError, match="int32"):
        ops.fft_spread(b.long(), x, yw, ch, nodes)
    with pytest.raises(TypeError, match="float32"):
        ops.fft_gather(p.double(), b, x, yw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fft_spread(b, x.T.contiguous().T, yw, ch, nodes)
    with pytest.raises(ValueError, match="nodes="):
        ops.fft_spread(b, x, yw, ch, nodes + 1)
    with pytest.raises(ValueError, match="nodes="):
        ops.fft_spread(b, x, yw, ch, 2 * fft.MAX_N_BOXES + 3)
    with pytest.raises(ValueError, match="wx"):
        ops.fft_spread(b, x[:, :2].contiguous(), yw, ch, nodes)
    with pytest.raises(ValueError, match="base"):
        ops.fft_gather(p, b[:10].contiguous(), x, yw)
    with pytest.raises(ValueError, match="nodes, nodes, 4"):
        ops.fft_gather(p[:, :-1].contiguous(), b, x, yw)
    with pytest.raises(ValueError, match="nodes, nodes, 4"):
        ops.fft_gather(p[..., :3].contiguous(), b, x, yw)
    with pytest.raises(ValueError, match="different devices"):
        ops.fft_gather(p.to("meta"), b, x, yw)


def test_descend_repeats_the_fit():
    # a second descent from the fit's graph and initial embedding, as
    # chip_smoke.py runs it on the card, repeats the fit bit for bit
    from repro_torch.api import TSNE, make_backend
    from repro_torch.core.tsne import descend, init_state
    x = np.random.default_rng(3).normal(size=(150, 8)).astype(np.float32)
    est = TSNE(method="fft", perplexity=10.0, n_iter=40, kl_every=20, random_state=0,
               device="cpu", backend_options=dict(exaggeration_iters=10,
                                                  momentum_switch_iter=10))
    est.fit(x)
    config = est._build_config()
    n = x.shape[0]
    state, kl, kl_hist, n_run = descend(init_state(n, config, "cpu"), est.neighbor_graph_,
                                        config, make_backend("fft", config, n),
                                        config.resolve_lr(n), kl_every=est.kl_every)
    np.testing.assert_array_equal(state.y.numpy(), est.embedding_)
    assert kl == est.kl_divergence_ and n_run == est.n_iter_ == 40
    np.testing.assert_array_equal(np.asarray(kl_hist), est.kl_history_)
