"""The port's kernel twins against the JAX Pallas kernels (interpret mode).

Each plain PyTorch version in ``repro_torch.core`` (what a kernel wrapper
runs for a CPU tensor) is held against the Pallas entry point on the same
numpy inputs, over the parametrisations of ``tests/test_kernels.py``.
The CUDA kernels themselves run only on a GPU (``chip_smoke.py``).
"""
import ctypes
import re
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
from repro.core import similarity as jsim  # noqa: E402
from repro_torch.core import attractive, bsp, morton, similarity  # noqa: E402
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
                                     (1000, 777, 784), (300, 500, 781)])
def test_pairwise_matches_pallas(nq, nc, d):
    rng = np.random.default_rng(nq + nc)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    c = rng.normal(size=(nc, d)).astype(np.float32)
    ref = np.asarray(pairwise_sq_dists_pallas(jnp.asarray(q), jnp.asarray(c)))
    out = ops.pairwise_sq_dists(T(q), T(c)).numpy()
    # the tolerance of tests/test_kernels.py: fp32 |q|^2+|c|^2-2qc cancels
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=1e-4)
    assert (out >= 0).all()


def test_pairwise_misaligned_row_view_matches_pallas():
    # rows of a flat buffer read from an odd element offset: no row starts
    # 16-byte aligned (the CUDA kernel stages such rows 4 bytes at a time)
    rng = np.random.default_rng(11)
    d = 784
    buf = T(rng.normal(size=(1 + 700 * d,)).astype(np.float32))
    q = buf[1:1 + 300 * d].view(300, d)
    c = buf[1 + 300 * d:1 + 700 * d].view(400, d)
    assert q.is_contiguous() and q.data_ptr() % 16 and c.data_ptr() % 16
    ref = np.asarray(pairwise_sq_dists_pallas(jnp.asarray(q.numpy()), jnp.asarray(c.numpy())))
    out = ops.pairwise_sq_dists(q, c).numpy()
    # the tolerance of tests/test_kernels.py: fp32 |q|^2+|c|^2-2qc cancels
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=1e-4)


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


def symmetrized_graph(n, k, seed):
    """A padded ELL graph as preprocessing makes it: the exact KNN of
    clustered points, the perplexity search, symmetrize_ell."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(6, 5))[rng.integers(0, 6, n)]
         + 0.3 * rng.normal(size=(n, 5))).astype(np.float32)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k].astype(np.int32)
    cond_p, _ = bsp.binary_search_perplexity_plain(
        T(np.take_along_axis(d2, idx, 1).astype(np.float32)), k / 3.0)
    cols, vals = jsim.symmetrize_ell(idx, cond_p.numpy())
    return idx, cols, (vals / vals.sum()).astype(np.float32)


@pytest.mark.parametrize("n,k", [(200, 12), (700, 30)])
def test_attractive_row_len_matches_pallas_on_symmetrized_graph(n, k):
    _, cols, vals = symmetrized_graph(n, k, seed=n)
    row_len = similarity.ell_row_lengths(cols)
    assert row_len.min() >= k and row_len.max() == cols.shape[1] > row_len.mean()
    y = (np.random.default_rng(k).normal(size=(n, 2)) * 5).astype(np.float32)
    # the Pallas kernel reads every W entry, padding included
    f_ref, kl_ref = attractive_forces_ell_pallas(jnp.asarray(y), jnp.asarray(cols),
                                                 jnp.asarray(vals))
    f, kl = ops.attractive_ell(T(y), T(cols), T(vals), T(row_len))
    # padding adds exact zeros; fp32 sums in another order: rtol 1e-5
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(kl), float(kl_ref), rtol=1e-5)


def test_attractive_ignores_entries_past_row_len():
    rng = np.random.default_rng(3)
    n, w = 120, 16
    y = T(rng.normal(size=(n, 2)).astype(np.float32))
    cols = rng.integers(0, n, size=(n, w)).astype(np.int32)
    vals = rng.uniform(0, 1e-3, size=(n, w)).astype(np.float32)
    row_len = rng.integers(0, w + 1, size=n).astype(np.int32)
    past = np.arange(w)[None, :] >= row_len[:, None]
    f, kl = ops.attractive_ell(y, T(cols), T(vals), T(row_len))
    # entries past the end: non-zero values, columns even outside [0, N)
    junk_cols = np.where(past, rng.integers(-n, 2 * n, size=(n, w)), cols).astype(np.int32)
    junk_vals = np.where(past, rng.uniform(1, 2, size=(n, w)), vals).astype(np.float32)
    fj, klj = ops.attractive_ell(y, T(junk_cols), T(junk_vals), T(row_len))
    assert torch.equal(f, fj) and torch.equal(kl, klj)
    # the same rows cut to their lengths, in float64
    yy = y.numpy().astype(np.float64)
    f64, kl64 = np.zeros((n, 2)), 0.0
    for i in range(n):
        c, v = cols[i, :row_len[i]], vals[i, :row_len[i]].astype(np.float64)
        diff = yy[i] - yy[c]
        d2 = (diff ** 2).sum(1)
        f64[i] = ((v / (1 + d2))[:, None] * diff).sum(0)
        kl64 += (v * np.log1p(d2)).sum()
    # fp32 against float64: rtol 1e-5 with a floor below the smallest force
    np.testing.assert_allclose(f.numpy(), f64, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(float(kl), kl64, rtol=1e-5)
    # row_len = None reads every entry
    fa, _ = attractive.attractive_forces_ell(y, T(cols), T(vals))
    fw, _ = ops.attractive_ell(y, T(cols), T(vals), T(np.full(n, w, np.int32)))
    assert torch.equal(fa, fw)


def test_ell_row_lengths_count_real_entries():
    idx, cols, _ = symmetrized_graph(300, 10, seed=9)
    n = cols.shape[0]
    row_len = similarity.ell_row_lengths(cols)
    assert row_len.dtype == np.int32
    # the row's runs: its out-neighbours and the in-neighbours not among them
    inn = [set() for _ in range(n)]
    for i, row in enumerate(idx):
        for j in row:
            inn[j].add(i)
    runs = np.array([len(set(idx[i]) | inn[i]) for i in range(n)])
    np.testing.assert_array_equal(row_len, runs)
    # padding (col = row) after the real entries, and only there
    pad = np.arange(cols.shape[1])[None, :] >= row_len[:, None]
    assert ((cols == np.arange(n)[:, None]) == pad).all()
    # any ELL graph: one past the last entry with col != row
    odd = np.array([[0, 1, 0, 0], [1, 1, 1, 1], [0, 2, 2, 2], [0, 3, 1, 3]])
    assert similarity.ell_row_lengths(odd).tolist() == [2, 0, 1, 3]


@pytest.mark.parametrize("n,k", [(1, 5), (65, 20), (500, 45), (1000, 90),
                                 (7, 1), (40, 33), (20, 129)])
@pytest.mark.parametrize("perplexity", [8.0, 30.0, 50.0])
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


def test_bsp_plan_covers_every_k():
    # G lanes a row (a power of two, 32 / G rows a warp) x values a lane
    # just cover K, within the registers the kernel has (32 values)
    for k in range(1, ops.MAX_K + 1):
        lanes, values = ops.bsp_plan(k)
        assert lanes in (1, 2, 4, 8, 16, 32) and 32 % lanes == 0
        assert values in ops.BSP_VALUES and max(ops.BSP_VALUES) == 32
        # the fewest values the kernel is built for that cover K
        smaller = [v for v in ops.BSP_VALUES if v < values]
        assert lanes * values >= k > lanes * max(smaller, default=0)
        # the fewest lanes that keep a lane at BSP_MAX_VALUES values
        assert values <= ops.BSP_MAX_VALUES or lanes == 32
        assert lanes == 1 or -(-k // (lanes // 2)) > ops.BSP_MAX_VALUES
    assert ops.bsp_plan(90) == (4, 24)
    for k in (0, ops.MAX_K + 1):
        with pytest.raises(ValueError, match="K="):
            ops.bsp_plan(k)


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

def test_registry_lists_the_six_ported_kernels():
    # the six Pallas kernels, and the Barnes-Hut traversal, which has none
    reg = ops.kernel_registry()
    assert set(reg) == {"pairwise_sq_dists", "bsp_search", "morton_encode",
                        "attractive_ell", "fft_spread", "fft_gather", "bh_traverse"}
    assert ops.available_kernels() == tuple(sorted(reg))
    for name, entry in reg.items():
        assert {"plain", "cuda", "doc", "tpu", "replaces", "wrapper", "source"} <= set(entry)
        assert callable(entry["plain"]) and callable(entry["cuda"])
        line_file, line = entry["replaces"].split(":")
        src_line = (ROOT / line_file).read_text().splitlines()[int(line) - 1]
        if entry["tpu"] is None:
            # the lax.while_loop body of the reference's traversal
            assert name == "bh_traverse" and line_file == "src/repro/core/repulsive.py"
            assert src_line.strip().startswith("def traverse(")
        else:
            tpu_file, tpu_fn = entry["tpu"].split(":")
            assert tpu_file.startswith("src/repro/kernels/") and tpu_fn.startswith("_")
            # replaces = file:line of that function's definition
            assert line_file == tpu_file
            assert src_line.startswith(f"def {tpu_fn}(")
        assert (ROOT / entry["source"]).is_file()
        assert entry["source"].startswith("src/repro_torch/csrc/")
        assert name in ops.LAUNCHES


def _cu_const(source: str, name: str) -> int:
    """``constexpr int NAME = <int>;`` (or ``const int name = <int>;``) of csrc/<source>.cu."""
    text = (ROOT / "src/repro_torch/csrc" / f"{source}.cu").read_text()
    return int(re.search(rf"\bconst(?:expr)? int {name} = (\d+);", text).group(1))


def _plans(name, *args):
    """(integer arguments, launch plans) of one call of ``name``'s CUDA
    wrapper on meta tensors, recorded in place of the launch."""
    from repro_torch.analysis.launch_contracts import record_launches
    records = []
    with record_launches(records):
        ops.kernel_registry()[name]["cuda"](*args)
    (rec,) = records
    return rec.values, ops.launch_plan(name, *rec.values)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ceil(a, b):
    return -(-a // b)


def _launch_plan_pairwise():
    assert (_cu_const("pairwise", "BM"), _cu_const("pairwise", "BN")) == (ops.PAIRWISE_TILE,) * 2
    warps = (ops.PAIRWISE_TILE // _cu_const("pairwise", "WM")) \
        * (ops.PAIRWISE_TILE // _cu_const("pairwise", "WN"))
    assert 32 * warps == ops.PAIRWISE_THREADS
    assert ops.PAIRWISE_SMEM == 4 * _cu_const("pairwise", "STAGES") * 2 * ops.PAIRWISE_TILE \
        * (_cu_const("pairwise", "BK") + 8)
    for nq, nc, d in [(1, 1, 1), (1, 60_000, 784), (3, 8192, 784), (129, 257, 8),
                      (512, 2048, 1024), (4096, 8192, 784)]:
        ints, (plan,) = _plans("pairwise_sq_dists", _meta(nq, d), _meta(nc, d), _meta(nq),
                               _meta(nc))
        assert ints == (nq, nc, d)
        assert plan[:3] == ((_ceil(nc, 128), _ceil(nq, 128), 1), (256, 1, 1), 122_880)


def _launch_plan_bsp():
    assert _cu_const("bsp", "WARPS") == ops.BSP_WARPS
    ks = sorted({1, 1024} | {k for k in range(2, 1025) if ops.bsp_plan(k) != ops.bsp_plan(k - 1)})
    for k in ks:
        for n in (1, 33, 70_000):
            ints, (plan,) = _plans("bsp_search", _meta(n, k), 30.0)
            lanes, values = ops.bsp_plan(k)
            assert ints == (n, k, 64, lanes, values)
            rows = ops.BSP_WARPS * 32 // lanes
            assert plan[:3] == ((_ceil(n, rows), 1, 1), (128, 1, 1), 0)
            assert plan.covers[0].per_block == rows


def _launch_plan_morton():
    text = (ROOT / "src/repro_torch/csrc/morton.cu").read_text()
    assert f"const int threads = {ops.MORTON_THREADS};" in text
    for n in (1, 255, 256, 257, 70_000, 1_291_337):
        ints, (plan,) = _plans("morton_encode", _meta(n, 2), _meta(2), _meta())
        assert ints == (n, 16)
        assert plan[:3] == ((_ceil(n, 256), 1, 1), (256, 1, 1), 0)


def _launch_plan_attractive():
    assert _cu_const("attractive", "WARPS") == ops.ATTRACTIVE_WARPS
    for n, w in [(1, 1), (9, 90), (70_000, 1024)]:
        ints, (plan,) = _plans("attractive_ell", _meta(n, 2), _meta(n, w, dtype=torch.int32),
                               _meta(n, w))
        assert ints == (n, w, 0)
        assert plan[:3] == ((_ceil(n, 8), 1, 1), (256, 1, 1), 0)


def _launch_plan_spread():
    assert _cu_const("spread", "SCAN") == ops.SPREAD_SCAN
    assert _cu_const("spread", "MAX_SLICES") == ops.SPREAD_MAX_SLICES
    for nodes in (3, 97, 129, 257):
        for n in (0, 1, 5000, 70_000):
            for c in (3, 4):
                base = _meta(n, 2, dtype=torch.int32)
                ints, (plan,) = _plans("fft_spread", base, _meta(n, 3), _meta(n, 3),
                                       _meta(n, c), nodes)
                rows, slices, warps, smem = ops.spread_plan(n, nodes, c)
                assert ints == (n, nodes, c, rows, slices, warps, smem)
                assert smem == ops.spread_smem_bytes(nodes, c, rows, warps)
                assert plan[:3] == ((slices, _ceil(nodes, rows), 1), (32 * warps, 1, 1), smem)


def _launch_plan_gather():
    assert _cu_const("gather", "THREADS") == ops.GATHER_THREADS
    for nodes in (3, 257):
        for n in (1, 128, 129, 70_000):
            ints, (plan,) = _plans("fft_gather", _meta(nodes, nodes, 4),
                                   _meta(n, 2, dtype=torch.int32), _meta(n, 3), _meta(n, 3))
            assert ints == (n, nodes)
            assert plan[:3] == ((_ceil(n, 128), 1, 1), (128, 1, 1), 0)


def _launch_plan_traverse():
    from repro_torch.analysis.launch_contracts import _walk_args
    assert _cu_const("traverse", "THREADS") == ops.TRAVERSE_THREADS
    assert _cu_const("traverse", "PACK_THREADS") == ops.PACK_THREADS
    for n in (1, 33, 70_000):
        for compress in (True, False):
            y, tree, summary, theta = _walk_args(n, compress)
            for pos in (None, _meta(max(1, n // 4), dtype=torch.int32)):
                m = n if pos is None else pos.shape[0]
                ints, plans = _plans("bh_traverse", y, tree, summary, theta, None, pos)
                assert ints == (m, n, tree.capacity)
                assert [p[:3] for p in plans] == [
                    ((_ceil(tree.capacity, 256), 1, 1), (256, 1, 1), 0),
                    ((_ceil(m, 256), 1, 1), (256, 1, 1), 0)]


@pytest.mark.parametrize("name", ["pairwise_sq_dists", "bsp_search", "morton_encode",
                                  "attractive_ell", "fft_spread", "fft_gather",
                                  "bh_traverse"])
def test_launch_plan_agrees_with_the_wrappers(name):
    # ops.launch_plan, from the integer arguments each CUDA wrapper passes
    # its C entry (recorded on meta tensors), against the plan helpers the
    # wrappers use and the .cu sources' launch constants, over a sweep of shapes
    {"pairwise_sq_dists": _launch_plan_pairwise, "bsp_search": _launch_plan_bsp,
     "morton_encode": _launch_plan_morton, "attractive_ell": _launch_plan_attractive,
     "fft_spread": _launch_plan_spread, "fft_gather": _launch_plan_gather,
     "bh_traverse": _launch_plan_traverse}[name]()


def test_launch_plan_mirrors_c_int_arithmetic():
    # a size past int32 reaches the C entry wrapped: morton's (n + 255) / 256
    # then overflows to a negative grid, which dim3 makes a huge unsigned one
    (plan,) = ops.launch_plan("morton_encode", 2**31 - 10, 16)
    assert plan.grid[0] > 2**31 - 1 and plan.covers[0].extent == 2**31 - 10
    # 2^32 + 5 points wrap to 5: one block, which covers 5 of them
    (plan,) = ops.launch_plan("morton_encode", 2**32 + 5, 16)
    assert plan.grid == (1, 1, 1) and plan.covers[0].extent == 2**32 + 5
    assert ops.launch_plan("fft_gather", 0, 257) == ()     # the entry returns first
    with pytest.raises(ValueError, match="no launch plan"):
        ops.launch_plan("nope", 1)


def test_get_kernel_dispatch():
    # tests/test_kernels.py::test_kernel_registry_dispatch, with the port's impls
    assert ops.get_kernel("bsp_search", "plain") is bsp.binary_search_perplexity_plain
    assert ops.get_kernel("bsp_search") is ops.bsp_search_cuda
    assert ops.get_kernel("bh_traverse", "cuda") is ops.bh_traverse_cuda
    for name in ops.available_kernels():
        assert ops.get_kernel(name, "plain") is ops.kernel_registry()[name]["plain"]
    with pytest.raises(ValueError, match="unknown kernel"):
        ops.get_kernel("nope")
    with pytest.raises(ValueError, match="impl must be"):
        ops.get_kernel("bsp_search", "pallas")


def test_each_c_entry_is_bound_once(monkeypatch):
    # the library is loaded and argtypes / restype set at the first launch
    # only; later launches reuse the bound function
    loads = []

    class Lib:
        def __init__(self):
            self.fft_gather = type("Fn", (), {})()

    def load(name):
        loads.append(name)
        return Lib()

    monkeypatch.setattr(ops.build, "load", load)
    monkeypatch.setattr(ops, "_ENTRIES", {})
    fn = ops._entry("gather")
    assert ops._entry("gather") is fn and loads == ["gather"]
    assert fn.argtypes == ops._SIGNATURES["gather"][1] and fn.restype is ctypes.c_int


_C_TYPES = {"const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
            "const int32_t*": ctypes.c_void_p, "int64_t*": ctypes.c_void_p,
            "const int64_t*": ctypes.c_void_p,
            "void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


@pytest.mark.parametrize("source", sorted(ops._SIGNATURES))
def test_signature_matches_the_c_entry(source):
    # the argtypes bound once in ops._SIGNATURES are those of the C entry's
    # declaration in csrc/<source>.cu, in order, ending with the stream
    symbol, argtypes = ops._SIGNATURES[source]
    text = (ROOT / "src/repro_torch/csrc" / f"{source}.cu").read_text()
    decl = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
    assert decl is not None
    params = [" ".join(p.split()) for p in decl.group(1).split(",")]
    assert [_C_TYPES[p.rsplit(" ", 1)[0]] for p in params] == argtypes
    assert params[-1] == "void* stream"


def test_launch_passes_the_current_stream_and_counts_each_launch(monkeypatch):
    calls, errors = [], [0, 7]

    def entry(*args):
        calls.append(args)
        return errors.pop(0)

    monkeypatch.setattr(ops, "_ENTRIES", {"gather": entry})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index,
                        raising=False)
    ops.reset_launch_counts()
    ops._launch("fft_gather", "gather", torch.device("cuda", 0), 1, 2)
    assert calls == [(1, 2, 1000)] and ops.LAUNCHES["fft_gather"] == 1
    # a refused launch raises and is not counted
    with pytest.raises(RuntimeError, match="error 7"):
        ops._launch("fft_gather", "gather", torch.device("cuda", 0), 3)
    assert ops.LAUNCHES["fft_gather"] == 1
    ops.reset_launch_counts()


def test_morton_launch_reads_the_root_cell_on_the_device(monkeypatch):
    # the kernel gets cent and r_span themselves: the wrapper computes no
    # root cell, so it runs no tensor op but the codes' allocation
    launches = []
    monkeypatch.setattr(ops, "_launch", lambda *a: launches.append(a))
    monkeypatch.setattr(ops.morton, "root_params", None)
    y = torch.zeros((5, 2))
    cent, r = torch.zeros(2), torch.tensor(1.0)
    codes = ops.morton_encode_cuda(y, cent, r, depth=12)
    assert codes.shape == (5,) and codes.dtype == torch.int64
    (name, source, _, *args), = launches
    assert (name, source) == ("morton_encode", "morton")
    assert args == [y.data_ptr(), cent.data_ptr(), r.data_ptr(), codes.data_ptr(), 5, 12]


def test_traverse_launch_passes_the_tree_on_the_device(monkeypatch):
    # n_nodes goes to the kernel as a pointer (no host read), with the
    # scratch the kernel packs the node records into; theta^2 is rounded
    # as the plain walk rounds it
    from repro_torch.core import quadtree, repulsive, summarize
    launches = []
    monkeypatch.setattr(ops, "_launch", lambda *a: launches.append(a))
    y = T(np.random.default_rng(3).normal(size=(40, 2)).astype(np.float32))
    cent, r = morton.span_radius(y)
    cs, ys, _ = quadtree.sort_points_by_code(y, morton.morton_encode(y, cent, r))
    tree = quadtree.build_quadtree(cs)
    summ = summarize.summarize(tree, ys, r)
    records = torch.empty((tree.capacity, repulsive.RECORD_WORDS), dtype=torch.int32)
    res = ops.bh_traverse_cuda(ys, tree, summ, 0.3, records=records)
    (name, source, _, *args), = launches
    assert (name, source) == ("bh_traverse", "traverse")
    assert args == [ys.data_ptr(), tree.start.data_ptr(), tree.end.data_ptr(),
                    tree.skip.data_ptr(), tree.n_nodes.data_ptr(), summ.count.data_ptr(),
                    summ.sum_y.data_ptr(), summ.side.data_ptr(),
                    float(torch.tensor(0.3) ** 2), records.data_ptr(), None,
                    res.force.data_ptr(), res.z_per_point.data_ptr(), res.steps.data_ptr(), 40,
                    40, tree.capacity]
    # without a buffer the wrapper allocates one: [cap, 8] int32, one
    # 32-byte record a node
    ops.bh_traverse_cuda(ys, tree, summ, 0.3)
    assert isinstance(launches[1][3 + 9], int) and launches[1][3 + 9] != records.data_ptr()
    with pytest.raises(ValueError, match="records"):
        ops.bh_traverse_cuda(ys, tree, summ, 0.3, records=records[:-1])
    assert repulsive.theta_squared(0.3) == float(np.float32(0.3) * np.float32(0.3))
    assert (res.force.shape, res.z_per_point.shape, res.steps.dtype) == \
        ((40, 2), (40,), torch.int64)


def test_cpu_tensor_takes_plain_path_and_counts_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    y = T(rng.normal(size=(50, 2)).astype(np.float32))
    cols = T(rng.integers(0, 50, size=(50, 4)).astype(np.int32))
    vals = T(rng.uniform(0, 1, size=(50, 4)).astype(np.float32))
    cent, r = morton.span_radius(y)
    ops.morton_encode(y, cent, r)
    ops.attractive_ell(y, cols, vals)
    ops.attractive_ell(y, cols, vals, torch.full((50,), 2, dtype=torch.int32))
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


@pytest.mark.parametrize("row_len,error,match", [
    (torch.full((8,), 2, dtype=torch.int64), TypeError, "int32"),
    (torch.full((9,), 2, dtype=torch.int32), ValueError, "shape"),
    (torch.full((8, 1), 2, dtype=torch.int32), ValueError, "1-D"),
    (torch.tensor([0, 1, 2, 3, 4, 1, 2, 3], dtype=torch.int32), ValueError, r"\[0, 3\]"),
    (torch.tensor([0, 1, 2, -1, 3, 1, 2, 3], dtype=torch.int32), ValueError, r"\[0, 3\]"),
])
def test_attractive_rejects_bad_row_len(row_len, error, match):
    y = torch.zeros((8, 2))
    cols = torch.zeros((8, 3), dtype=torch.int32)
    vals = torch.zeros((8, 3))
    with pytest.raises(error, match=match):
        ops.attractive_ell(y, cols, vals, row_len)
