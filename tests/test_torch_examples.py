"""The port's examples (``repro_torch.examples``) on the CPU at small sizes:
the mouse pipeline's ``main`` with each neighbour path, its resume from a
checkpoint against the straight run, and the quickstart."""
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import tsne as jtsne  # noqa: E402
from repro_torch.data.datasets import make_dataset  # noqa: E402
from repro_torch.device import MESH_DEVICES_ENV  # noqa: E402
from repro_torch.examples import mouse_pipeline, quickstart  # noqa: E402
from repro_torch.neighbors import sharded  # noqa: E402

N, ITERS = 3000, 60


@pytest.fixture
def mesh_env(monkeypatch):
    """``--shards`` sets the forced mesh size in the process: undo it after
    the test."""
    monkeypatch.setenv(MESH_DEVICES_ENV, "1")
    monkeypatch.delenv(MESH_DEVICES_ENV)


def pipeline(tmp_path, method, *extra):
    return mouse_pipeline.main(["--device", "cpu", "--n", str(N), "--shards", "2",
                                "--iters", str(ITERS), "--neighbor_method", method,
                                "--kl_every", "20", "--out", str(tmp_path / "y.npy"),
                                *extra])


@pytest.mark.parametrize("method", ["sharded", "rp_forest", "exact"])
def test_mouse_pipeline_main(tmp_path, mesh_env, method, capsys):
    run = pipeline(tmp_path, method)
    assert run.y.shape == (N, 2) and np.isfinite(run.y).all()
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), run.y)
    assert run.timings["neighbor_method"] == method and run.timings["n_neighbors"] == 90
    assert set(run.timings) >= {"knn", "bsp", "symmetrize", "gradient_descent"}
    assert run.start == 0 and [it for it, _ in run.kl_history] == [20, 40, 60]
    kls = [kl for _, kl in run.kl_history]
    assert np.isfinite(kls).all() and kls[-1] < kls[0]
    printed = capsys.readouterr().out
    assert f"KNN[{method}, k=90]" in printed and "iter    60  KL" in printed
    # --shards 2 forced a mesh of two CPU devices
    assert sharded.visible_devices("cpu") == (torch.device("cpu"),) * 2
    if method == "exact":
        # the graph is the JAX package's preprocess of the same points.
        # As in test_torch_pipeline.py::test_preprocess_matches_jax, the
        # distance tile's |q|^2+|c|^2-2qc cancels in fp32 and the search
        # amplifies that: P to rtol 1e-3 entry by entry, its sum p log p to 1e-5
        x, _ = make_dataset("mouse_1p3m", n=N)
        jg, _ = jtsne.preprocess(jnp.asarray(x), jtsne.TsneConfig(perplexity=30.0))
        np.testing.assert_array_equal(run.graph.p_cols.numpy(), np.asarray(jg.p_cols))
        np.testing.assert_allclose(run.graph.p_vals.numpy(), np.asarray(jg.p_vals),
                                   rtol=1e-3, atol=1e-10)
        np.testing.assert_allclose(float(run.graph.p_logp), float(jg.p_logp), rtol=1e-5)


def test_mouse_pipeline_resume_equals_straight_run(tmp_path, mesh_env, capsys):
    straight = pipeline(tmp_path, "sharded", "--ckpt_dir", str(tmp_path / "a"),
                        "--ckpt_every", "30")
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "step_0000000030", "step_0000000060"]
    # a run killed after step 30: its checkpoint directory holds step 30
    shutil.copytree(tmp_path / "a" / "step_0000000030", tmp_path / "b" / "step_0000000030")
    resumed = pipeline(tmp_path, "sharded", "--ckpt_dir", str(tmp_path / "b"),
                       "--ckpt_every", "30")
    assert "resumed from iteration 30" in capsys.readouterr().out
    assert resumed.start == 30 and [it for it, _ in resumed.kl_history] == [40, 60]
    np.testing.assert_array_equal(resumed.y.view(np.uint32), straight.y.view(np.uint32))
    assert resumed.kl == straight.kl


def test_mouse_pipeline_defaults_follow_the_reference():
    args = mouse_pipeline.parse_args([])
    assert (args.n, args.iters, args.neighbor_method, args.shards, args.chunk_size,
            args.kl_every, args.ckpt_every, args.device) == \
        (50000, 1000, "auto", 0, 0, 50, 200, "cuda")
    assert mouse_pipeline.AUTO_SCALE_N == 200_000 and mouse_pipeline.AUTO_CHUNK == 100_000


def test_quickstart(tmp_path, capsys):
    y = quickstart.main(["--n", "300", "--iters", "60", "--device", "cpu",
                         "--out", str(tmp_path / "emb.npy")])
    assert y.shape == (300, 2) and np.isfinite(y).all()
    np.testing.assert_array_equal(np.load(tmp_path / "emb.npy"), y)
    printed = capsys.readouterr().out
    assert "final KL =" in printed and "cluster separation" in printed
