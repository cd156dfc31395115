"""The port's LM training path (``models.layers.chunked_attention``'s
backward, ``model.loss_fn``, ``train.{optimizer,step,trainer,checkpoint,
moe_bias}``, ``distributed.{fault,compression}``, ``launch.train`` and
``examples.train_lm``) against the JAX package on the CPU.

Every comparison carries JAX's parameters (and optimizer state) across
with ``convert``: the port cannot reproduce JAX's draws.  Tolerances,
relative to the scale (largest magnitude) of the compared quantity:

* float32 compute: the loss to ``1e-5``, every gradient to ``1e-5`` of its
  leaf's scale (measured: below 1e-6; the two frameworks sum in other
  orders);
* bfloat16 compute: the loss to one bf16 epsilon (2^-7) of its value and
  gradients to four (a few ulps: both cast at the same places, but a
  rounding that lands one ulp apart in the forward moves the gradients by
  up to ~2 epsilons; measured 2.2);
* the attention backward alone: ``1e-5`` in float32, two bf16 epsilons in
  bfloat16 (each output is rounded to bf16 once, and a float32 value that
  straddles a rounding boundary lands one ulp apart);
* optimizer and train steps: parameters to ``1e-5`` and float32 moments to
  ``1e-5`` of their scale; bf16 moments to one bf16 epsilon of their scale
  (a moment whose float32 value straddles a rounding lands one ulp apart).
  Where the gradients come from the two models (the train step, the
  trainer), AdamW's ``eps`` is ``1e-3``: an element's first step is
  ``g / (|g| + eps)``, which at the default 1e-8 turns the float32
  gradients' noise (~1e-7) into a step of either sign wherever a gradient
  is that small; at 1e-3 the step is Lipschitz in the gradient.

The restart drill, the checkpoints read across packages and the gradient
compression are held bit for bit.
"""
import dataclasses
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxPipeline  # noqa: E402
from repro.distributed import compression as jcompression  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.train import optimizer as joptimizer  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.train.moe_bias import update_router_bias as jupdate_router_bias  # noqa: E402
from repro.train.step import make_train_step as jmake_train_step  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    adamw_state_from_numpy, lm_params_from_numpy, lm_params_to_numpy,
)
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed.fault import HeartbeatMonitor, run_with_restarts  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.moe_bias import update_router_bias  # noqa: E402
from repro_torch.train.step import make_train_step, opt_config_for  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import (  # noqa: E402
    Stacked, tree_leaves, tree_leaves_with_path, tree_map, tree_unflatten_like,
)

BF16_EPS = 2.0**-7
B, S = 2, 20          # 20 positions over chunks of 8: three chunks, the last ragged
CHUNK = 8


def is_stacked(x):
    return isinstance(x, Stacked)


def host_tree(tree) -> dict:
    """A port tree as the reference's numpy tree: Stacked leaves stacked."""
    def one(x):
        ts = list(x) if is_stacked(x) else [x]
        a = np.stack([t.detach().float().numpy() for t in ts])
        return a if is_stacked(x) else a[0]
    return tree_map(one, tree, is_leaf=is_stacked)


def assert_trees_close(got, want, rel: float, what: str) -> None:
    """Leaf by leaf (same paths), |got - want| <= rel x max|want| of the leaf."""
    g = tree_leaves_with_path(got)
    w = [(tuple(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in p), x)
         for p, x in jax.tree_util.tree_leaves_with_path(want)]
    assert [p[-1] for p, _ in g] == [p[-1] for p, _ in w] and len(g) == len(w), what
    for (path, a), (_, b) in zip(g, w):
        b = np.asarray(b, np.float32)
        a = np.asarray(a, np.float32)
        assert a.shape == b.shape, (what, path)
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, (what, "/".join(path), err, scale)


def reduced(arch: str, **kw):
    """(JAX cfg, port cfg) of the reduced arch with attn_chunk CHUNK and ``kw``."""
    kw = dict(attn_chunk=CHUNK, **kw)
    return (dataclasses.replace(jconfigs.get_reduced_config(arch), **kw),
            dataclasses.replace(configs.get_reduced_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def jax_params(arch: str, seed: int = 0, **kw):
    jcfg, _ = reduced(arch, **kw)
    return jbuild_model(jcfg).init(jax.random.PRNGKey(seed))


def port_params(cfg, jp):
    return lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def tokens(vocab: int, batch: int = B, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (batch, S + 1)).astype(np.int32)


def port_grads(model, params, batch):
    params.requires_grad_(True)
    loss, metrics = model.loss_fn(params, batch)
    tree = params.reference_tree()
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    return loss.detach(), metrics, tree_unflatten_like(tree, list(grads))


# ------------------------------------------------------------ loss_fn -----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["deepseek_7b", "phi4_mini_3p8b"])
def test_loss_and_gradients_match_jax(arch, dtype):
    """phi4_mini_3p8b: GQA and tied embeddings (the gather's and the
    head's gradients add on one parameter); deepseek_7b: MHA, untied."""
    jcfg, cfg = reduced(arch, compute_dtype=dtype)
    jp = jax_params(arch, compute_dtype=dtype)
    toks = tokens(cfg.vocab_size)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jbuild_model(jcfg).loss_fn, has_aux=True))(jp, {"tokens": jnp.asarray(toks)})
    model = build_model(cfg, device="cpu")
    loss, metrics, grads = port_grads(model, port_params(cfg, jp), {"tokens": toks})
    assert set(metrics) == set(jmetrics) == {"lm_loss", "loss"}
    assert loss.dtype == torch.float32 and metrics["lm_loss"] is metrics["loss"]
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5 if f32 else BF16_EPS)
    assert_trees_close(host_tree(grads), jgrads, 1e-5 if f32 else 4 * BF16_EPS, "grads")
    assert ("unembed" in grads) == (not cfg.tie_embeddings)


def test_remat_changes_no_bit_and_serving_stays_frozen():
    """cfg.remat recomputes each block in the backward: the same loss and
    gradients bit for bit.  prefill and decode_step run under no_grad, the
    same logits whether or not the parameters are trainable."""
    _, cfg = reduced("phi4_mini_3p8b", compute_dtype="float32")
    jp = jax_params("phi4_mini_3p8b", compute_dtype="float32")
    batch = {"tokens": tokens(cfg.vocab_size)}
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _, grads = port_grads(build_model(c, device="cpu"), port_params(c, jp), batch)
        out[remat] = (loss, tree_leaves(grads))
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))

    model = build_model(cfg, device="cpu")
    frozen, trainable = port_params(cfg, jp), port_params(cfg, jp).requires_grad_(True)
    want = model.prefill(frozen, batch)
    got = model.prefill(trainable, batch)
    assert not got.requires_grad and torch.equal(got, want)
    cache = model.init_cache(B, 4)
    logits, _ = model.decode_step(trainable, cache, batch["tokens"][:, 0], np.zeros(B, np.int32))
    assert not logits.requires_grad


def test_mtp_loss_waits_for_the_moe_family():
    """The reference adds the MTP term for the MoE family only: a dense
    config with ``mtp=True`` inits no MTP parameters and gives the
    reference's plain loss (bf16 compute: one bf16 epsilon)."""
    jcfg, cfg = reduced("deepseek_7b", mtp=True)
    jp = jax_params("deepseek_7b")          # the flag changes no dense parameter
    assert "mtp" not in jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    assert model.init(torch.Generator().manual_seed(0)).mtp is None
    toks = tokens(cfg.vocab_size)
    jloss, jmetrics = jax.jit(jbuild_model(jcfg).loss_fn)(jp, {"tokens": jnp.asarray(toks)})
    loss, metrics = model.loss_fn(port_params(cfg, jp), {"tokens": toks})
    assert set(metrics) == set(jmetrics) == {"lm_loss", "loss"}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_EPS)


# -------------------------------------------------- attention backward -----
@pytest.mark.parametrize("causal,hkv,s,dtype", [
    (True, 4, 20, "float32"), (False, 4, 20, "float32"), (True, 2, 20, "float32"),
    (False, 2, 16, "float32"), (True, 1, 16, "float32"),
    (True, 2, 20, "bfloat16"), (False, 4, 20, "bfloat16"),
])
def test_chunked_attention_backward_matches_jax(causal, hkv, s, dtype):
    """dq, dk, dv against jax.vjp through the reference's custom VJP: H = 4
    query heads over hkv KV heads (GQA at 2 and 1), S = 20 ragged over
    chunks of 8 or S = 16 whole."""
    rng = np.random.default_rng(11)
    shapes = [(2, s, 4, 8), (2, s, hkv, 8), (2, s, hkv, 8)]
    q, k, v = (rng.normal(size=sh).astype(np.float32) for sh in shapes)
    dout = rng.normal(size=shapes[0]).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jdout = (jnp.asarray(a, jdt) for a in (q, k, v, dout))
    _, vjp = jax.vjp(lambda a, b, c: jlayers.chunked_attention(a, b, c, causal=causal,
                                                                chunk=CHUNK), jq, jk, jv)
    want = vjp(jdout)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    out = layers.chunked_attention(tq, tk, tv, causal=causal, chunk=CHUNK)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(dout).to(tdt))
    rel = 1e-5 if dtype == "float32" else 2 * BF16_EPS
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and g.shape == w.shape, name
        w = np.asarray(w, np.float32)
        assert float(np.abs(g.float().numpy() - w).max()) <= rel * float(np.abs(w).max()), name


def test_chunked_attention_backward_matches_plain_autograd():
    """Independent of JAX: autograd through the plain core (the whole score
    matrix) gives the custom backward's gradients, GQA and ragged."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 19, 6, 8, generator=gen, requires_grad=True)
    k, v = (torch.randn(2, 19, 2, 8, generator=gen, requires_grad=True) for _ in range(2))
    dout = torch.randn(2, 19, 6, 8, generator=gen)
    got = torch.autograd.grad(layers.chunked_attention(q, k, v, causal=True, chunk=CHUNK),
                              (q, k, v), dout)
    want = torch.autograd.grad(layers.attention(q, k, v, causal=True), (q, k, v), dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))


# ----------------------------------------------------------- optimizer -----
OPT_CASES = {
    "plain": dict(opt={}, scan_layers=True),
    "bf16": dict(opt=dict(moment_dtype="bfloat16"), scan_layers=True),
    "factored": dict(opt=dict(factored=True), scan_layers=True),
    "factored_bf16_listed": dict(opt=dict(factored=True, moment_dtype="bfloat16"),
                                 scan_layers=False),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_update_matches_jax(case):
    """Three steps from the same gradients (norms above the clip, warmup
    reached).  Factored with two stacked layers: each [L, d] norm scale is
    one leaf factored across layers (row [L], col [d]), as the reference
    factors it; listed layers leave each [d] scale unfactored."""
    spec = OPT_CASES[case]
    jcfg, cfg = reduced("phi4_mini_3p8b", scan_layers=spec["scan_layers"])
    ocfg = dict(warmup_steps=2, **spec["opt"])
    jopt, opt = joptimizer.AdamWConfig(**ocfg), optimizer.AdamWConfig(**ocfg)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(1))
    params = port_params(cfg, jp)
    jstate, state = joptimizer.init_adamw(jp, jopt), optimizer.init_adamw(params, opt)
    rng = np.random.default_rng(5)
    jupd = jax.jit(functools.partial(joptimizer.adamw_update, cfg=jopt))
    for _ in range(3):
        g_np = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.3, jp)
        jp, jstate, jmetrics = jupd(g_np, jstate, jp)
        grads = port_params(cfg, g_np).reference_tree()
        params, state, metrics = optimizer.adamw_update(grads, state, params, opt)
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                                   rtol=1e-6)
        assert metrics["lr"] == float(jmetrics["lr"])
    assert state.step == int(jstate.step) == 3
    assert_trees_close(lm_params_to_numpy(params, stacked=spec["scan_layers"]),
                       jp, 1e-5, "params")
    m_rel = BF16_EPS if "bf16" in case else 1e-5
    assert_trees_close(tree_map(lambda t: t.float().numpy(), state.m), jstate.m, m_rel, "m")
    assert_trees_close(tree_map(lambda t: t.float().numpy(), state.v), jstate.v, m_rel, "v")
    ln1 = state.v["layers"]["ln1"] if spec["scan_layers"] else state.v["layers"][1]["ln1"]
    if case.startswith("factored") and spec["scan_layers"]:
        assert set(ln1) == {"row", "col"} and ln1["row"].shape == (cfg.n_layers,)
    else:
        assert isinstance(ln1, torch.Tensor)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum, dtype):
    """One step of make_train_step, accumulating ``accum`` microbatches in
    cfg.optimizer_dtype (bf16 moments: a bf16 accumulator), factored with
    bf16."""
    kw = dict(compute_dtype="float32", grad_accum=accum, optimizer_dtype=dtype,
              optimizer_factored=dtype == "bfloat16")
    jcfg, cfg = reduced("deepseek_7b", **kw)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(2))
    jmodel, model = jbuild_model(jcfg), build_model(cfg, device="cpu")
    jopt, opt = (dataclasses.replace(c, warmup_steps=1, eps=1e-3)
                 for c in (joptimizer.AdamWConfig(moment_dtype=dtype,
                                                  factored=dtype == "bfloat16"),
                           opt_config_for(cfg)))
    batch = tokens(cfg.vocab_size, batch=4, seed=3)
    jnew, jstate, jmetrics = jax.jit(jmake_train_step(jmodel, jopt))(
        jp, joptimizer.init_adamw(jp, jopt), {"tokens": jnp.asarray(batch)})
    params = port_params(cfg, jp)
    new, state, metrics = make_train_step(model, opt)(
        params, optimizer.init_adamw(params, opt), {"tokens": batch})
    assert new is params and set(metrics) == set(jmetrics)
    for k in ("loss_mean", "loss", "lm_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)
    assert_trees_close(lm_params_to_numpy(new), jnew, 1e-5, "params")
    m_rel = BF16_EPS if dtype == "bfloat16" else 1e-5
    assert_trees_close(tree_map(lambda t: t.float().numpy(), state.m), jstate.m, m_rel, "m")


# ------------------------------------------------------------- trainer -----
def trainer_cfg(path, n_steps=4, fail_at=None, log_every=1):
    return dict(n_steps=n_steps, ckpt_every=2, log_every=log_every, ckpt_dir=str(path),
                fail_at_step=fail_at)


def test_trainer_run_tracks_jax(tmp_path):
    """Four steps of Trainer.run from JAX's initial parameters (the port's
    trainer is handed them through init_state): the loss each step and the
    final parameters."""
    jcfg, cfg = reduced("phi4_mini_3p8b", compute_dtype="float32")
    ocfg = dict(warmup_steps=2, eps=1e-3)
    jtr = JaxTrainer(jbuild_model(jcfg), JaxPipeline(cfg.vocab_size, 2, S, seed=1),
                     JaxTrainerConfig(**trainer_cfg(tmp_path / "jax")),
                     joptimizer.AdamWConfig(**ocfg), donate=False)
    jparams, _, steps = jtr.run(seed=4)
    assert steps == 4
    tr = Trainer(build_model(cfg, device="cpu"), TokenPipeline(cfg.vocab_size, 2, S, seed=1),
                 TrainerConfig(**trainer_cfg(tmp_path / "port")), optimizer.AdamWConfig(**ocfg))
    jp0 = jbuild_model(jcfg).init(jax.random.PRNGKey(4))
    tr.init_state = lambda seed: (port_params(cfg, jp0),
                                  tr.opt_init(port_params(cfg, jp0)), 0)
    params, state, steps = tr.run(seed=4)
    assert steps == 4 and state.step == 4
    got = [m["loss_mean"] for m in tr.metrics_log]
    want = [m["loss_mean"] for m in jtr.metrics_log]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert [m["step"] for m in tr.metrics_log] == [1, 2, 3, 4]
    assert_trees_close(lm_params_to_numpy(params), jparams, 1e-5, "params")


def test_restart_is_bit_exact(tmp_path):
    """The port's drill: 8 steps, checkpoints every 2, a failure injected
    at step 5 and resumed from step 4 by run_with_restarts; the final
    parameters and optimizer state equal an uninterrupted run's bit for
    bit (bf16 factored moments, two microbatches)."""
    _, cfg = reduced("deepseek_7b", optimizer_dtype="bfloat16", optimizer_factored=True,
                     grad_accum=2)

    def make(path, fail_at=None):
        return Trainer(build_model(cfg, device="cpu"),
                       TokenPipeline(cfg.vocab_size, 4, 12, seed=7),
                       TrainerConfig(**trainer_cfg(path, 8, fail_at, log_every=100)),
                       donate=False)

    clean, clean_state, steps = make(tmp_path / "clean").run(seed=3)
    assert steps == 8
    calls = {"n": 0}

    def supervisor():
        calls["n"] += 1
        return make(tmp_path / "fault", fail_at=5 if calls["n"] == 1 else None)

    params, state, steps, failures = run_with_restarts(supervisor, seed=3)
    assert failures == 1 and steps == 8 and calls["n"] == 2
    for a, b in zip(clean.parameters(), params.parameters()):
        assert torch.equal(a, b)
    assert state.step == clean_state.step == 8
    for a, b in zip(tree_leaves(clean_state), tree_leaves(state)):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


def test_heartbeat_monitor():
    mon = HeartbeatMonitor(3, timeout_s=0.0)
    mon.last_beat[1] -= 10.0
    assert 1 in mon.dead_ranks()
    mon.timeout_s = 5.0
    mon.beat(1)
    assert mon.dead_ranks() == []


# --------------------------------------------------------- checkpoints -----
def one_jax_step(jcfg, seed):
    """(params, AdamWState) after one JAX step: every moment non-zero."""
    jm = jbuild_model(jcfg)
    jopt = joptimizer.AdamWConfig(moment_dtype=jcfg.optimizer_dtype,
                                  factored=jcfg.optimizer_factored)
    jp = jm.init(jax.random.PRNGKey(seed))
    batch = {"tokens": jnp.asarray(tokens(jcfg.vocab_size, seed=seed))}
    jp, jstate, _ = jax.jit(jmake_train_step(jm, jopt))(jp, joptimizer.init_adamw(jp, jopt),
                                                          batch)
    return jp, jstate


def assert_bits(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype.itemsize == want.dtype.itemsize
    np.testing.assert_array_equal(got.view(f"u{got.dtype.itemsize}"),
                                  want.view(f"u{want.dtype.itemsize}"))


def port_state_bits(params, state):
    """(params, step, m, v) of the port as numpy leaves in the reference's
    order, bf16 by its bits."""
    def bits(t):
        t = t.detach()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return [*tree_leaves(tree_map(lambda x: np.stack([bits(t) for t in x]) if is_stacked(x)
                                  else bits(x), params.reference_tree(), is_leaf=is_stacked)),
            np.asarray(state.step, np.int32), *map(bits, tree_leaves((state.m, state.v)))]


@pytest.mark.parametrize("scan_layers", [True, False])
def test_checkpoints_cross_packages_both_ways(tmp_path, scan_layers):
    """(params, AdamWState) with bf16 factored moments: the port restores
    the reference's checkpoint and the reference restores the port's, leaf
    for leaf and bit for bit; both write the same file names and treedef."""
    jcfg, cfg = reduced("phi4_mini_3p8b", optimizer_dtype="bfloat16", optimizer_factored=True,
                        scan_layers=scan_layers)
    jp, jstate = one_jax_step(jcfg, seed=5)
    JaxManager(tmp_path / "jax").save(1, (jp, jstate), blocking=True)

    model, opt = build_model(cfg, device="cpu"), opt_config_for(cfg)
    fresh = model.init(torch.Generator().manual_seed(0))
    template = (fresh, optimizer.init_adamw(fresh, opt))
    (params, state), step = CheckpointManager(tmp_path / "jax").restore(template)
    assert step == 1 and state.step == 1 and type(params) is type(fresh)
    want = [np.asarray(x) for x in jax.tree.leaves((jp, jstate))]
    want = [w.view(np.int16) if w.dtype.name == "bfloat16" else w for w in want]
    got = port_state_bits(params, state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_bits(g, w)

    # the port's own state after one more step, read by the reference
    batch = {"tokens": tokens(cfg.vocab_size, seed=6)}
    params, state, _ = make_train_step(model, opt)(params, state, batch)
    CheckpointManager(tmp_path / "port").save(2, (params, state), blocking=True)
    jrestored, jstep = JaxManager(tmp_path / "port").restore((jp, jstate))
    assert jstep == 2 and int(jrestored[1].step) == 2
    want = port_state_bits(params, state)
    got = [np.asarray(x) for x in jax.tree.leaves(jrestored)]
    got = [g.view(np.int16) if g.dtype.name == "bfloat16" else g for g in got]
    for g, w in zip(got, want):
        assert_bits(g, w)

    a, b = tmp_path / "jax" / "step_0000000001", tmp_path / "port" / "step_0000000002"
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma["treedef"] == mb["treedef"] and ma["leaves"] == mb["leaves"]
    if scan_layers:
        assert {"name": "1__.v__layers__ln1__row", "shape": [cfg.n_layers],
                "dtype": "float32"} in mb["leaves"]
        assert {"name": "1__.m__layers__attn__wq", "shape": [cfg.n_layers, 64, 64],
                "dtype": "bfloat16"} in mb["leaves"]


def test_adamw_state_from_numpy_layouts():
    jcfg, cfg = reduced("phi4_mini_3p8b", optimizer_dtype="bfloat16", optimizer_factored=True)
    _, jstate = one_jax_step(jcfg, seed=8)
    state = adamw_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    assert state.step == 1 and state.m["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert_bits(state.m["embed"]["embedding"].view(torch.int16).numpy(),
                np.asarray(jstate.m["embed"]["embedding"]).view(np.int16))
    with pytest.raises(ValueError, match="scan_layers"):
        adamw_state_from_numpy(dataclasses.replace(cfg, scan_layers=False),
                               jax.tree.map(np.asarray, jstate), device="cpu")


# --------------------------------------------------- compression, bias -----
def test_compress_grads_bit_for_bit():
    rng = np.random.default_rng(9)
    shapes = {"a": (33, 7), "b": {"c": (5,), "d": (4, 3)}}
    jgrads = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    jgrads["b"]["c"] = jgrads["b"]["c"].astype(jnp.bfloat16)
    jef = jcompression.init_error_feedback(jgrads)
    ef = compression.init_error_feedback(tree_map(lambda a: torch.tensor(np.asarray(
        a, np.float32)), jgrads))
    for step in range(3):
        g_np = jax.tree.map(lambda a: np.asarray(a) * (1 + step), jgrads)
        jout, jef = jcompression.compress_grads(g_np, jef)
        grads = tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)).to(
            torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32), g_np)
        out, ef = compression.compress_grads(grads, ef)
        for got, want in zip(tree_leaves(out), jax.tree.leaves(jout)):
            assert_bits(got.float().numpy(), np.asarray(want, np.float32))
        for got, want in zip(tree_leaves(ef.residual), jax.tree.leaves(jef.residual)):
            assert_bits(got.numpy(), np.asarray(want))
    q, scale = compression._quantize(torch.tensor([1.0, 3.0, 5.0, -254.0]))
    assert q.tolist() == [0, 2, 2, -127] and float(scale) == 2.0     # half to even


def test_update_router_bias_on_the_reference_tree():
    tree = {"layers": {"mlp": {"router": {"bias": np.zeros((4,), np.float32),
                                          "w": np.zeros((8, 4), np.float32)}}}}
    load = np.asarray([2.0, 1.0, 0.5, 0.5], np.float32)
    want = jupdate_router_bias(jax.tree.map(jnp.asarray, tree), jnp.asarray(load), rate=0.1)
    got = update_router_bias(tree_map(torch.tensor, tree), torch.tensor(load), rate=0.1)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert_bits(g.numpy(), np.asarray(w))
    bias = got["layers"]["mlp"]["router"]["bias"]
    assert bias[0] < 0 and bias[2] > 0 and bias[1] == 0


# ------------------------------------------------------- entry points -----
def test_launch_train_on_cpu(tmp_path, capsys, monkeypatch):
    log = launch_train.main(["--arch", "phi4_mini_3p8b", "--reduced", "--steps", "4",
                             "--batch", "2", "--seq", "16", "--device", "cpu",
                             "--ckpt_dir", str(tmp_path)])
    assert [m["step"] for m in log] == [4] and np.isfinite(log[0]["loss_mean"])
    assert "step 4 loss" in capsys.readouterr().out
    assert (tmp_path / "step_0000000004" / "manifest.json").exists()
    # on a 2 x 2 mesh of CPU shards: the single-device run's losses (the
    # sharded step sums in another order: bf16 compute, one bf16 epsilon)
    monkeypatch.setenv("REPRO_TORCH_MESH_DEVICES", "4")
    argv = ["--arch", "deepseek_7b", "--reduced", "--steps", "2", "--batch", "4", "--seq", "16",
            "--device", "cpu"]
    one = launch_train.main(argv + ["--ckpt_dir", str(tmp_path / "one")])
    mesh = launch_train.main(argv + ["--data_parallel", "2", "--model_parallel", "2",
                                     "--ckpt_dir", str(tmp_path / "mesh")])
    assert [m["step"] for m in mesh] == [m["step"] for m in one] == [2]
    np.testing.assert_allclose([m["loss_mean"] for m in mesh], [m["loss_mean"] for m in one],
                               rtol=BF16_EPS)
    # the vlm family trains through FrontendPipeline's patches
    log = launch_train.main(["--arch", "llava_next_34b", "--reduced", "--steps", "2",
                             "--batch", "2", "--seq", "16", "--device", "cpu",
                             "--ckpt_dir", str(tmp_path / "vlm")])
    assert [m["step"] for m in log] == [2] and np.isfinite(log[0]["loss_mean"])


def test_examples_train_lm_on_cpu(tmp_path, capsys):
    argv = ["--steps", "10", "--d_model", "128", "--n_layers", "2", "--vocab", "256",
            "--batch", "2", "--seq", "16", "--device", "cpu", "--ckpt_dir", str(tmp_path)]
    log = train_lm.main(argv)
    assert [m["step"] for m in log] == [10] and np.isfinite(log[0]["loss_mean"])
    assert "model: " in capsys.readouterr().out
    # a rerun resumes from the final checkpoint: no step left to take
    assert train_lm.main(argv) == [] and CheckpointManager(tmp_path).latest_step() == 10
