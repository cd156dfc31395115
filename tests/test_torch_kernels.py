"""The port's kernel twins against the JAX Pallas kernels (interpret mode).

Each plain PyTorch version in ``repro_torch.core`` (what a kernel wrapper
runs for a CPU tensor) is held against the Pallas entry point on the same
numpy inputs, over the parametrisations of ``tests/test_kernels.py``.
The CUDA kernels themselves run only on a GPU (``chip_smoke.py``).
"""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bsp as jbsp  # noqa: E402
from repro.core import morton as jmorton  # noqa: E402
from repro.kernels.attractive_kernel import attractive_forces_ell_pallas  # noqa: E402
from repro.kernels.bsp_kernel import binary_search_perplexity_pallas  # noqa: E402
from repro.kernels.morton_kernel import morton_encode_pallas  # noqa: E402
from repro.kernels.pairwise_kernel import pairwise_sq_dists_pallas  # noqa: E402
from repro_torch.core import bsp, morton  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

T = torch.as_tensor
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n", [1, 100, 1024, 2500])
@pytest.mark.parametrize("depth", [8, 16])
def test_morton_matches_pallas_bitwise(n, depth):
    rng = np.random.default_rng(n)
    y = rng.normal(size=(n, 2)).astype(np.float32) * 10
    cent, r = jmorton.span_radius(jnp.asarray(y))
    ref = np.asarray(morton_encode_pallas(jnp.asarray(y), cent, r, depth=depth))
    yt = T(y)
    cent_t, r_t = morton.span_radius(yt)
    # span and codes bit-identical: min/max and the Alg. 1 arithmetic are exact
    np.testing.assert_array_equal(cent_t.numpy(), np.asarray(cent))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r))
    out = ops.morton_encode(yt, cent_t, r_t, depth=depth)
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("nq,nc,d", [(64, 64, 8), (128, 256, 20), (300, 500, 64),
                                     (1000, 777, 784)])
def test_pairwise_matches_pallas(nq, nc, d):
    rng = np.random.default_rng(nq + nc)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    c = rng.normal(size=(nc, d)).astype(np.float32)
    ref = np.asarray(pairwise_sq_dists_pallas(jnp.asarray(q), jnp.asarray(c)))
    out = ops.pairwise_sq_dists(T(q), T(c)).numpy()
    # the tolerance of tests/test_kernels.py: fp32 |q|^2+|c|^2-2qc cancels
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=1e-4)
    assert (out >= 0).all()


@pytest.mark.parametrize("n,w", [(10, 3), (256, 90), (1000, 33)])
def test_attractive_matches_pallas(n, w):
    rng = np.random.default_rng(n + w)
    y = rng.normal(size=(n, 2)).astype(np.float32)
    cols = rng.integers(0, n, size=(n, w)).astype(np.int32)
    vals = rng.uniform(0, 1e-3, size=(n, w)).astype(np.float32)
    f_ref, kl_ref = attractive_forces_ell_pallas(jnp.asarray(y), jnp.asarray(cols),
                                                 jnp.asarray(vals))
    f, kl = ops.attractive_ell(T(y), T(cols), T(vals))
    # fp32 sums in another order: rtol 1e-5, as tests/test_kernels.py
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(kl), float(kl_ref), rtol=1e-5)


@pytest.mark.parametrize("n,k", [(1, 5), (65, 20), (500, 45), (1000, 90)])
@pytest.mark.parametrize("perplexity", [8.0, 30.0])
def test_bsp_matches_pallas(n, k, perplexity):
    k = min(k, int(3 * perplexity))
    rng = np.random.default_rng(n + k)
    d2 = (np.abs(rng.normal(size=(n, k))) * 4).astype(np.float32)
    p_ref, b_ref = binary_search_perplexity_pallas(jnp.asarray(d2), perplexity)
    p, b = ops.bsp_search(T(d2), perplexity)
    # rtol 1e-5: the Pallas-vs-XLA parity target of tests/test_kernels.py
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-5)
    if k > perplexity:
        # the search converged: realised perplexity == target (1%, as the reference)
        np.testing.assert_allclose(bsp.perplexity_of(p).numpy(), perplexity, rtol=1e-2)
        np.testing.assert_allclose(bsp.perplexity_of(p).numpy(),
                                   np.asarray(jbsp.perplexity_of(p_ref)), rtol=1e-5)


def test_bsp_chunked_matches_whole():
    rng = np.random.default_rng(7)
    d2 = T((np.abs(rng.normal(size=(203, 24))) * 3).astype(np.float32))
    p, b = bsp.binary_search_perplexity(d2, 7.0)
    pc, bc = bsp.binary_search_perplexity_chunked(d2, 7.0, chunk_size=50)
    # rows are independent: chunking is exact
    assert torch.equal(p, pc) and torch.equal(b, bc)
    with pytest.raises(ValueError, match="chunk_size"):
        bsp.binary_search_perplexity_chunked(d2, 7.0, chunk_size=0)


# ----------------------------------------------------------------- registry --

def test_registry_lists_the_four_ported_kernels():
    reg = ops.kernel_registry()
    assert set(reg) == {"pairwise_sq_dists", "bsp_search", "morton_encode",
                        "attractive_ell"}
    assert ops.available_kernels() == tuple(sorted(reg))
    for name, entry in reg.items():
        assert {"plain", "cuda", "doc", "tpu", "replaces", "wrapper", "source"} <= set(entry)
        assert callable(entry["plain"]) and callable(entry["cuda"])
        tpu_file, tpu_fn = entry["tpu"].split(":")
        assert tpu_file.startswith("src/repro/kernels/") and tpu_fn.startswith("_")
        # replaces = file:line of that function's definition
        line_file, line = entry["replaces"].split(":")
        assert line_file == tpu_file
        src_line = (ROOT / tpu_file).read_text().splitlines()[int(line) - 1]
        assert src_line.startswith(f"def {tpu_fn}(")
        assert (ROOT / entry["source"]).is_file()
        assert entry["source"].startswith("src/repro_torch/csrc/")
        assert name in ops.LAUNCHES


def test_cpu_tensor_takes_plain_path_and_counts_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    y = T(rng.normal(size=(50, 2)).astype(np.float32))
    cols = T(rng.integers(0, 50, size=(50, 4)).astype(np.int32))
    vals = T(rng.uniform(0, 1, size=(50, 4)).astype(np.float32))
    cent, r = morton.span_radius(y)
    ops.morton_encode(y, cent, r)
    ops.attractive_ell(y, cols, vals)
    ops.pairwise_sq_dists(y, y)
    ops.bsp_search(torch.abs(y), 1.5)
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_wrappers_reject_bad_inputs():
    y = torch.zeros((8, 2))
    cols = torch.zeros((8, 3), dtype=torch.int32)
    vals = torch.zeros((8, 3))
    with pytest.raises(TypeError, match="int32"):
        ops.attractive_ell(y, cols.long(), vals)
    with pytest.raises(TypeError, match="float32"):
        ops.pairwise_sq_dists(y.double(), y.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.attractive_ell(torch.zeros((2, 8)).T, cols, vals)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bsp_search(torch.zeros((3, 8)).T, 2.0)
    with pytest.raises(ValueError, match="shape"):
        ops.pairwise_sq_dists(torch.zeros((4, 3)), torch.zeros((4, 5)))
    with pytest.raises(ValueError, match="depth"):
        ops.morton_encode(y, torch.zeros(2), torch.tensor(1.0), depth=17)
    with pytest.raises(ValueError, match="K="):
        ops.bsp_search(torch.zeros((2, 1025)), 2.0)
