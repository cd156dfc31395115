"""The port's CheckpointManager (``train/checkpoint.py``) against the JAX
package's: the same files, so each reads the other's ``TsneState`` bit for
bit; and the manager's own contract (keep, atomic rename, no checkpoint)."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.tsne import TsneState as JaxState  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro_torch.core.tsne import TsneState  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402

LEAVES = [".y", ".velocity", ".gains", ".iteration"]


def arrays(n=37, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 2)).astype(np.float32) for _ in range(3)]


def torch_state(n=37, seed=0, iteration=30):
    return TsneState(*(torch.as_tensor(a) for a in arrays(n, seed)), iteration)


def jax_state(n=37, seed=0, iteration=30):
    return JaxState(*(jnp.asarray(a) for a in arrays(n, seed)),
                    jnp.asarray(iteration, jnp.int32))


def files(step_dir):
    return sorted(p.name for p in step_dir.iterdir())


def test_port_reads_a_jax_checkpoint_bit_for_bit(tmp_path):
    JaxManager(tmp_path).save(30, jax_state(), blocking=True)
    template = TsneState(torch.zeros(37, 2), torch.zeros(37, 2), torch.zeros(37, 2), 0)
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 30
    state, step = mgr.restore(template, device="cpu")
    assert step == 30 and state.iteration == 30 and type(state.iteration) is int
    for got, want in zip(state[:3], arrays()):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_jax_reads_a_port_checkpoint_bit_for_bit(tmp_path):
    CheckpointManager(tmp_path).save(40, torch_state(iteration=40), blocking=True)
    template = JaxState(*(jnp.zeros((37, 2)) for _ in range(3)), jnp.asarray(0, jnp.int32))
    state, step = JaxManager(tmp_path).restore(template)
    assert step == 40
    assert np.asarray(state.iteration).dtype == np.int32 and int(state.iteration) == 40
    for got, want in zip(state[:3], arrays()):
        np.testing.assert_array_equal(np.asarray(got).view(np.uint32), want.view(np.uint32))


def test_both_packages_write_the_same_files(tmp_path):
    JaxManager(tmp_path / "jax").save(7, jax_state(iteration=7), blocking=True)
    CheckpointManager(tmp_path / "port").save(7, torch_state(iteration=7), blocking=True)
    a, b = tmp_path / "jax" / "step_0000000007", tmp_path / "port" / "step_0000000007"
    assert files(a) == files(b) == sorted([f"{n}.npy" for n in LEAVES] + ["manifest.json"])
    assert json.loads((a / "manifest.json").read_text()) == \
        json.loads((b / "manifest.json").read_text())
    for name in LEAVES:
        assert (a / f"{name}.npy").read_bytes() == (b / f"{name}.npy").read_bytes()


def test_dict_state_round_trip_and_device(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float64).reshape(3, 2), "step": 5,
             "a": torch.tensor([1, 2], dtype=torch.int32)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state)
    mgr.wait()
    names = {m["name"]: m for m in
             json.loads((tmp_path / "step_0000000001" / "manifest.json").read_text())["leaves"]}
    assert list(names) == ["a", "step", "w"]
    assert names["step"]["dtype"] == "int32" and names["w"]["dtype"] == "float64"
    got, step = mgr.restore({"a": torch.zeros(2), "step": 0, "w": torch.zeros(1)})
    assert step == 1 and got["step"] == 5
    assert torch.equal(got["w"], state["w"]) and torch.equal(got["a"], state["a"])
    with pytest.raises(TypeError, match="a tensor, an array or an int"):
        mgr.save(2, {"w": "not an array"})


def test_keep_collects_old_steps(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (10, 20, 30, 40):
        mgr.save(step, torch_state(iteration=step))
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000030",
                                                          "step_0000000040"]
    state, step = mgr.restore(torch_state(), step=30)
    assert step == 30 and state.iteration == 30


def test_unfinished_tmp_directory_is_never_restored(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(10, torch_state(iteration=10), blocking=True)
    # a crash mid-write leaves step_N.tmp (and a step dir without manifest)
    (tmp_path / "step_0000000020.tmp").mkdir()
    np.save(tmp_path / "step_0000000020.tmp" / ".y.npy", np.zeros((37, 2), np.float32))
    (tmp_path / "step_0000000030").mkdir()
    assert mgr.latest_step() == 10
    assert mgr.restore(torch_state(iteration=0))[1] == 10
    # a later save of the same step replaces the stale .tmp
    mgr.save(20, torch_state(iteration=20), blocking=True)
    assert mgr.latest_step() == 20 and not (tmp_path / "step_0000000020.tmp").exists()


def test_no_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path / "new")
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        mgr.restore(torch_state())


def test_save_copies_before_returning(tmp_path):
    state = torch_state(iteration=3)
    want = state.y.clone()
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, state)
    state.y.add_(1.0)                  # the caller moves on before the write ends
    mgr.wait()
    assert torch.equal(mgr.restore(torch_state())[0].y, want)


def test_a_failed_write_raises_on_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, torch_state(iteration=1), blocking=True)
    (tmp_path / "step_0000000002.tmp").write_text("a file where the directory goes")
    mgr.save(2, torch_state(iteration=2))
    with pytest.raises(RuntimeError, match="checkpoint write"):
        mgr.wait()
    mgr.wait()                         # the error is reported once
