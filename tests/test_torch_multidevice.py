"""The port's multi-device training against the JAX package's.

The JAX references run once, in one subprocess with 8 forced host devices,
on meshes built as ``Mesh(np.array(jax.devices()[:n]).reshape(...),
names)``: ``jax.make_mesh`` makes ``Explicit`` axes on jax 0.9.0, under
which the reference's ``logical`` constraints raise.  They come back as an
.npz.  The port runs in-process on meshes of CPU shards
(``launch.mesh.make_local_mesh(..., device="cpu")``), the counterpart of
those host devices.  Inputs are made from a seed with numpy; tolerances:

* ``compressed_psum``: bit for bit (``torch.round`` rounds half to even,
  as ``jnp.round`` does), and within 8 x scale of the exact sum (the
  reference's own test);
* ``pipelined``: ``rtol=1e-5, atol=1e-6`` (the same stage function on the
  same microbatches);
* the expert-parallel MoE block: ``rtol=2e-4, atol=2e-5``, the reference's
  own EP-against-local tolerance; ``expert_load`` exactly (a count over
  the same routing); gradients to ``1e-5`` of their leaf's scale;
* the train step (float32 compute): the loss to ``1e-5``, the updated
  parameters to ``1e-5`` of each leaf's scale, with AdamW ``eps=1e-3`` as
  in ``tests/test_torch_train.py`` (the first step is ``g / (|g| + eps)``:
  at 1e-8 float32 noise flips tiny gradients' steps).  The sharded steps
  sum in another order than the single-device step, so the port's sharded
  step is held to its single-device step at the same tolerances, with the
  MoE block's capacity made ample and its aux loss off (the EP branch
  changes results by design: capacity per data shard, data shard 0's aux).
"""
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.device import MESH_DEVICES_ENV  # noqa: E402
from repro_torch.distributed import collectives, sharding  # noqa: E402
from repro_torch.distributed.collectives import Mesh  # noqa: E402
from repro_torch.distributed.compression import compressed_psum  # noqa: E402
from repro_torch.distributed.fault import run_with_restarts  # noqa: E402
from repro_torch.distributed.pipeline import pipeline_bubble, pipelined  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    DeviceMesh, LogicalMesh, make_local_mesh, mesh_dp_size, mesh_tp_size,
)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.moe import moe_block  # noqa: E402
from repro_torch.train.optimizer import init_adamw  # noqa: E402
from repro_torch.train.step import make_train_step, opt_config_for  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ARCHS = ("deepseek_7b", "deepseek_v2_lite_16b", "rwkv6_3b", "zamba2_2p7b", "whisper_tiny",
         "llava_next_34b", "phi4_mini_3p8b")
JAX_STEP_ARCHS = ("deepseek_7b", "deepseek_v2_lite_16b", "rwkv6_3b")
STEP_BATCH, STEP_SEQ = 4, 20

JAX_REFERENCES = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_reduced_config
from repro.distributed.compression import compressed_psum
from repro.distributed.pipeline import pipelined
from repro.distributed.sharding import DEFAULT_RULES, use_mesh_rules
from repro.models.model import build_model
from repro.models.moe import init_moe, moe_block
from repro.train import optimizer
from repro.train.step import make_train_step

def mesh(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)

def flat(tree, prefix):
    return {{prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32) for p, v in jax.tree_util.tree_leaves_with_path(tree)}}

out = {{}}
rng = np.random.default_rng(0)
x = rng.normal(size=(8, 128)).astype(np.float32)
x[3, 5] = 40.0
out["cpsum_x"] = x
out["cpsum"] = np.asarray(shard_map(lambda v: compressed_psum(v[0], "data"),
                                    mesh=mesh((8,), ("data",)), in_specs=P("data"),
                                    out_specs=P(None), check_vma=False)(jnp.asarray(x)))
w = rng.normal(size=(4, 16, 16)).astype(np.float32) * 0.5
b = rng.normal(size=(4, 16)).astype(np.float32)
xb = rng.normal(size=(12, 16)).astype(np.float32)
fn = pipelined(lambda p, v: jnp.tanh(v @ p["w"] + p["b"]), mesh((4,), ("pipe",)), n_micro=3)
out.update(pipe_w=w, pipe_b=b, pipe_x=xb,
           pipe_y=np.asarray(jax.jit(fn)({{"w": jnp.asarray(w), "b": jnp.asarray(b)}},
                                         jnp.asarray(xb))))

cfg0 = get_reduced_config("deepseek_v2_lite_16b")
params = init_moe(jax.random.PRNGKey(0), cfg0, jnp.float32)
out.update(flat(params, "moe_p/"))
xm = rng.normal(size=(4, 8, cfg0.d_model)).astype(np.float32)
rm = rng.normal(size=xm.shape).astype(np.float32)
out.update(moe_x=xm, moe_r=rm)
for cf in (1.25, 64.0):
    cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(cfg0.moe, capacity_factor=cf))
    def f(p, v, r):
        y, aux = moe_block(p, v, cfg)
        return jnp.sum(y * r) + 10.0 * aux["aux_loss"], (y, aux)
    with use_mesh_rules(mesh((2, 4), ("data", "model")), DEFAULT_RULES):
        (_, (y, aux)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            params, jnp.asarray(xm), jnp.asarray(rm))
    tag = f"moe{{int(cf * 100)}}"
    out[f"{{tag}}_y"] = np.asarray(y)
    out[f"{{tag}}_aux"] = np.asarray(aux["aux_loss"])
    out[f"{{tag}}_load"] = np.asarray(aux["expert_load"])
    out.update(flat(g, f"{{tag}}_g/"))

for arch in {JAX_STEP_ARCHS!r}:
    cfg = dataclasses.replace(get_reduced_config(arch), compute_dtype="float32", attn_chunk=8)
    model = build_model(cfg)
    opt = dataclasses.replace(optimizer.AdamWConfig(), warmup_steps=1, eps=1e-3)
    p0 = model.init(jax.random.PRNGKey(2))
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, ({STEP_BATCH}, {STEP_SEQ} + 1)).astype(np.int32)
    with use_mesh_rules(mesh((2, 2), ("data", "model")), DEFAULT_RULES):
        new, _, met = jax.jit(make_train_step(model, opt))(
            p0, optimizer.init_adamw(p0, opt), {{"tokens": jnp.asarray(toks)}})
    out.update(flat(p0, f"{{arch}}_p0/"))
    out.update(flat(new, f"{{arch}}_new/"))
    out[f"{{arch}}_tokens"] = toks
    out.update({{f"{{arch}}_m/{{k}}": np.asarray(v) for k, v in met.items()}})
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every JAX reference of this file, from one subprocess on 8 forced
    host devices."""
    path = tmp_path_factory.mktemp("jax_multidevice") / "ref.npz"
    code = JAX_REFERENCES.format(**globals())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, str(path)], capture_output=True,
                         text=True, env=env, timeout=900)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr[-4000:]}"
    with np.load(path) as f:
        return dict(f)


def unflatten(ref: dict, prefix: str) -> dict:
    """The nested tree of the ``prefix``-keyed leaves of the .npz."""
    tree: dict = {}
    for key, value in ref.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = value
    return tree


def flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in flatten(sub, f"{prefix}{name}/").items()}
    return {prefix[:-1]: np.asarray(tree.detach().float() if torch.is_tensor(tree) else tree)}


def assert_close_by_scale(got: dict, want: dict, rel: float, what: str) -> None:
    """Leaf by leaf (the same keys): |got - want| <= rel x max|want|."""
    assert sorted(got) == sorted(want), what
    for k in sorted(want):
        g, w = np.asarray(got[k], np.float32), np.asarray(want[k], np.float32)
        assert g.shape == w.shape, (what, k)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, (what, k, err, scale)


def cpu_mesh(data: int, model: int) -> DeviceMesh:
    return make_local_mesh(data, model, device="cpu")


# ------------------------------------------------------------ the mesh -----
def test_local_mesh_layout_and_sizes():
    mesh = cpu_mesh(2, 4)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert mesh.index(data=1, model=2) == 6 and mesh.index(model=3) == 3
    assert mesh.group("model", data=1) == Mesh((CPU,) * 4)
    assert mesh.group("data").size == 2
    assert (mesh_dp_size(mesh), mesh_tp_size(mesh)) == (2, 4)
    logical = LogicalMesh((2, 16, 16), ("pod", "data", "model"))
    assert (mesh_dp_size(logical), mesh_tp_size(logical)) == (32, 16)
    with pytest.raises(ValueError, match="outside"):
        mesh.index(data=2)


def test_make_local_mesh_raises_when_too_few_devices(monkeypatch):
    monkeypatch.setenv(MESH_DEVICES_ENV, "2")
    with pytest.raises(ValueError, match=f"needs 4 CPU devices, but 2 .*{MESH_DEVICES_ENV}=4"):
        make_local_mesh(2, 2, device="cpu")
    monkeypatch.setenv(MESH_DEVICES_ENV, "4")
    assert make_local_mesh(2, 2, device="cpu").devices == (CPU,) * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_local_mesh(2, 2)


def test_runtime_rules_are_no_ops_without_a_mesh():
    assert sharding.active_rules() is None and sharding.batch_axes() == ()
    assert sharding.shard_group("heads", 4) is None
    mesh = cpu_mesh(2, 2)
    with sharding.use_mesh_rules(mesh, sharding.DEFAULT_RULES) as rules:
        assert sharding.active_rules() is rules and sharding.batch_axes() == ("data",)
        assert sharding.shard_group("heads", 4).size == 2
        assert sharding.shard_group("heads", 3) is None          # 2 does not divide 3
        assert sharding.shard_group("batch", 4) is None          # not a model-axis block
        with sharding.use_shard(sharding.ShardScope(data=1)) as scope:
            assert sharding.batch_coords(1) == {"data": 1}
            # autograd runs a CUDA backward (and a remat recompute) on a
            # thread of its own: the rules and the shard are seen there
            seen = []
            worker = threading.Thread(target=lambda: seen.append(
                (sharding.active_rules(), sharding.current_shard())))
            worker.start()
            worker.join()
            assert seen == [(rules, scope)]
    assert sharding.active_rules() is None and sharding.current_shard() is None


# ------------------------------------------------------ building blocks -----
def test_compressed_psum_bit_for_bit(ref):
    x = ref["cpsum_x"]
    got = compressed_psum(Mesh((CPU,) * 8), [torch.tensor(r) for r in x])
    assert all(torch.equal(g, got[0]) for g in got)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), ref["cpsum"].view(np.uint32))
    scale = np.abs(x).max() / 127.0
    assert np.max(np.abs(got[0].numpy() - x.sum(0))) <= 8 * scale


def test_pipelined_matches_jax_and_the_sequential_apply(ref):
    w, b, x = (torch.tensor(ref[k]) for k in ("pipe_w", "pipe_b", "pipe_x"))
    mesh = DeviceMesh((4,), ("pipe",), (CPU,) * 4)
    got = pipelined(lambda p, v: torch.tanh(v @ p["w"] + p["b"]), mesh, n_micro=3)(
        {"w": w, "b": b}, x)
    np.testing.assert_allclose(got.numpy(), ref["pipe_y"], rtol=1e-5, atol=1e-6)
    want = x
    for s in range(4):
        want = torch.tanh(want @ w[s] + b[s])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    assert pipeline_bubble(3, 4) == 0.5


@pytest.mark.parametrize("cf", [1.25, 64.0])
def test_moe_expert_parallel_block_matches_jax(ref, cf):
    """deepseek_v2_lite_16b's reduced MoE block on a 2 x 4 mesh (8
    experts, two a model shard): the output, data shard 0's aux loss and
    expert load, and the gradients of ``sum(y * r) + 10 aux`` (the aux
    loss's is the mean over the data shards, as the reference's transpose
    gives it)."""
    cfg0 = get_reduced_config("deepseek_v2_lite_16b")
    cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(cfg0.moe, capacity_factor=cf))
    params = {k: {n: torch.tensor(a, requires_grad=True) for n, a in v.items()}
              for k, v in unflatten(ref, "moe_p/").items()}
    x, r = torch.tensor(ref["moe_x"]), torch.tensor(ref["moe_r"])
    with sharding.use_mesh_rules(cpu_mesh(2, 4)):
        y, aux = moe_block(params, x, cfg)
        loss = torch.sum(y * r) + 10.0 * aux["aux_loss"]
    leaves = {f"{k}/{n}": t for k, v in params.items() for n, t in v.items()}
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                                 materialize_grads=True)))
    tag = f"moe{int(cf * 100)}"
    np.testing.assert_allclose(y.detach().numpy(), ref[f"{tag}_y"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(aux["aux_loss"].item(), ref[f"{tag}_aux"], rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(aux["expert_load"].numpy(), ref[f"{tag}_load"])
    # data shard 0's statistics: the local block on x[:2] alone
    _, aux0 = moe_block(params, x[:2], cfg)
    assert aux["aux_loss"].item() == aux0["aux_loss"].item()
    assert torch.equal(aux["expert_load"], aux0["expert_load"])
    assert_close_by_scale({k: g.numpy() for k, g in grads.items()},
                          flatten(unflatten(ref, f"{tag}_g/")), 1e-5, "grads")
    if cf == 64.0:      # no token dropped: EP is the local block
        y_local, _ = moe_block(params, x, cfg)
        np.testing.assert_allclose(y.detach().numpy(), y_local.detach().numpy(),
                                   rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------- train step -----
def step_config(arch: str):
    return dataclasses.replace(get_reduced_config(arch), compute_dtype="float32", attn_chunk=8)


def step_opt(cfg):
    return dataclasses.replace(opt_config_for(cfg), warmup_steps=1, eps=1e-3)


@pytest.mark.parametrize("arch", JAX_STEP_ARCHS)
def test_sharded_step_matches_jax(ref, arch):
    """One step on a 2 x 2 mesh from the reference's parameters: the
    reference under ``use_mesh_rules`` (GSPMD), the port's sharded step
    (data shards one after the other, TP and EP blocks on the model axis's
    shards)."""
    cfg = step_config(arch)
    model = build_model(cfg, device="cpu")
    mesh = cpu_mesh(2, 2)
    params = lm_params_from_numpy(cfg, unflatten(ref, f"{arch}_p0/"), device=mesh.devices[0])
    opt = step_opt(cfg)
    with sharding.use_mesh_rules(mesh):
        new, state, metrics = make_train_step(model, opt, mesh)(
            params, init_adamw(params, opt), {"tokens": ref[f"{arch}_tokens"]})
    assert new is params and state.step == 1
    want = {k.split("/", 1)[1]: v for k, v in ref.items() if k.startswith(f"{arch}_m/")}
    assert set(metrics) == set(want)
    for k in ("loss_mean", "loss", "lm_loss", "grad_norm") + (
            ("aux_loss",) if cfg.family == "moe" else ()):
        np.testing.assert_allclose(float(metrics[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert_close_by_scale(flatten(lm_params_to_numpy(new)),
                          flatten(unflatten(ref, f"{arch}_new/")), 1e-5, "params")


def step_batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (STEP_BATCH, STEP_SEQ + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(STEP_BATCH, cfg.vlm.n_patches,
                                            cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(STEP_BATCH, cfg.enc_dec.n_frames,
                                           cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch,shape", [(a, (2, 2)) for a in ARCHS] + [
    ("phi4_mini_3p8b", (1, 4)),     # 2 KV heads over 4 model shards: K, V replicated
    ("deepseek_7b", (4, 1)),        # data parallel alone
])
def test_sharded_step_matches_single_device(arch, shape):
    """Every family: the sharded step against the port's own single-device
    step from the same parameters and batch, and the copies between shards
    counted."""
    cfg = step_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=64.0, aux_loss_weight=0.0))
    model, opt, batch = build_model(cfg, device="cpu"), step_opt(cfg), step_batch(cfg)
    out = {}
    for mesh in (None, cpu_mesh(*shape)):
        params = model.init(torch.Generator().manual_seed(0))
        collectives.COPIED_BYTES["bytes"] = 0
        with sharding.use_mesh_rules(mesh):            # None: no rules
            new, _, metrics = make_train_step(model, opt, mesh)(
                params, init_adamw(params, opt), batch)
        out[mesh is None] = (new, metrics, collectives.COPIED_BYTES["bytes"])
    (new, metrics, copied), (want, want_metrics, none) = out[False], out[True]
    np.testing.assert_allclose(float(metrics["loss_mean"]), float(want_metrics["loss_mean"]),
                               rtol=1e-5)
    assert_close_by_scale(flatten(lm_params_to_numpy(new)),
                          flatten(lm_params_to_numpy(want)), 1e-5, "params")
    assert none == 0 and copied > 0


def test_moe_without_expert_parallelism_routes_the_whole_batch():
    """On a 2 x 1 mesh the MoE block takes the local branch, which in the
    reference routes over the global batch (capacity and each expert's
    selection couple the rows): the step keeps the batch on data shard 0
    and gives the single-device step's result at the published capacity
    factor and aux loss."""
    cfg = step_config("deepseek_v2_lite_16b")
    model, opt, batch = build_model(cfg, device="cpu"), step_opt(cfg), step_batch(cfg)
    out = []
    for mesh in (None, cpu_mesh(2, 1)):
        params = model.init(torch.Generator().manual_seed(0))
        with sharding.use_mesh_rules(mesh):
            new, _, metrics = make_train_step(model, opt, mesh)(
                params, init_adamw(params, opt), batch)
        out.append((flatten(lm_params_to_numpy(new)), float(metrics["loss_mean"])))
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-5)
    assert_close_by_scale(out[1][0], out[0][0], 1e-5, "params")


def test_resume_on_the_mesh_is_bit_exact(tmp_path):
    """The restart drill on a 2 x 2 mesh (bf16 factored moments, two
    microbatches): a failure at step 3, resumed from step 2, ends with the
    parameters and optimizer state of an uninterrupted run bit for bit."""
    cfg = dataclasses.replace(get_reduced_config("deepseek_7b"), optimizer_dtype="bfloat16",
                              optimizer_factored=True, grad_accum=2)
    mesh = cpu_mesh(2, 2)

    def make(path, fail_at=None):
        return Trainer(build_model(cfg, device="cpu"),
                       TokenPipeline(cfg.vocab_size, 4, 12, seed=7),
                       TrainerConfig(n_steps=4, ckpt_every=2, log_every=100, ckpt_dir=str(path),
                                     fail_at_step=fail_at))

    with sharding.use_mesh_rules(mesh):
        trainer = make(tmp_path / "clean")
        assert trainer.mesh == mesh
        clean, clean_state, steps = trainer.run(seed=3)
        calls = {"n": 0}

        def supervisor():
            calls["n"] += 1
            return make(tmp_path / "fault", fail_at=3 if calls["n"] == 1 else None)

        params, state, steps, failures = run_with_restarts(supervisor, seed=3)
    assert failures == 1 and steps == 4 and calls["n"] == 2
    for a, b in zip(clean.parameters(), params.parameters()):
        assert torch.equal(a, b)
    assert state.step == clean_state.step == 4
    for a, b in zip(tree_leaves(clean_state), tree_leaves(state)):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


def test_remat_on_the_mesh_recomputes_each_block_once_from_its_output(monkeypatch):
    """With remat on a 2 x 2 mesh each block is recomputed once, from the
    backward of its last op (``transformer._RecomputeHere``), so that one
    thread recomputes a block whose saved tensors lie on several cards;
    the step's result is remat off's bit for bit, and its one replica (the
    shards share the CPU) is the state it returned."""
    from repro_torch.models import transformer
    cfg = dataclasses.replace(step_config("deepseek_7b"), remat=True)
    model, opt, batch = build_model(cfg, device="cpu"), step_opt(cfg), step_batch(cfg)
    calls, inside = [], [False]
    block_forward, backward = transformer.block_forward, transformer._RecomputeHere.backward

    def logged_block(*a, **kw):
        calls.append(inside[0])
        return block_forward(*a, **kw)

    def logged_backward(ctx, g):
        inside[0] = True
        try:
            return backward(ctx, g)
        finally:
            inside[0] = False

    monkeypatch.setattr(transformer, "block_forward", logged_block)
    monkeypatch.setattr(transformer._RecomputeHere, "backward", staticmethod(logged_backward))
    mesh = cpu_mesh(2, 2)
    out = {}
    for remat in (True, False):
        m = build_model(dataclasses.replace(cfg, remat=remat), device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        calls.clear()
        with sharding.use_mesh_rules(mesh):
            step = make_train_step(m, opt, mesh)
            new, state, _ = step(params, init_adamw(params, opt), batch)
        # each data shard's forward of every block, then with remat the
        # backward's one recompute of each, all from _RecomputeHere's backward
        depth = [False] * cfg.n_layers
        assert calls == (depth + [True] * cfg.n_layers if remat else depth) * mesh.shape["data"]
        assert step.replicas() == [(new, state)]
        out[remat] = [t.clone() for t in new.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(out[True], out[False]))
