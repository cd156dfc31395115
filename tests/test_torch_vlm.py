"""The port's vlm family (LLaVA-NeXT's patch-prefixed decoder: the dense
stack over ``[patches ; text]``, the loss masked over the patches,
prefill with the patches in front, decode as the dense family's,
training, serving and the entry points) against the JAX package on the
CPU, on the reduced llava_next_34b (2 layers, d_model 64, 4 query heads
over 2 KV heads, 8 patches); and ``build_model`` for every config.

JAX's parameters (``init(PRNGKey(0))``) cross into the port through
``convert.lm_params_from_numpy``; patches and tokens come from a numpy
seed.  Tolerances, relative to the scale (largest magnitude) of the
compared quantity: float32 losses, logits, gradients, post-step
parameters and moments to ``1e-5`` (AdamW ``eps`` 1e-3, as in
``test_torch_train.py``); bf16 logits to two bf16 epsilons (2 x 2^-7) and
the bf16 loss to one, the tolerances of ``test_torch_lm.py`` and
``test_torch_train.py``.

The patch prefix moves the text to positions ``n_patches ..`` in
``loss_fn`` and ``prefill``; the engine decodes text alone from position
0, as the reference's does.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.train import optimizer as joptimizer  # noqa: E402
from repro.train.step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import param_count  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.model import DecoderLM, build_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.tree import Stacked, tree_leaves_with_path, tree_map  # noqa: E402

ARCH = "llava_next_34b"
BF16_EPS = 2.0**-7
B, S = 2, 12


def reduced(**kw):
    """(JAX cfg, port cfg) of the reduced llava_next_34b with ``kw``."""
    return (dataclasses.replace(jconfigs.get_reduced_config(ARCH), **kw),
            dataclasses.replace(configs.get_reduced_config(ARCH), **kw))


@functools.lru_cache(maxsize=None)
def numpy_params() -> dict:
    jcfg, _ = reduced()
    return jax.tree.map(np.asarray, jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def models(dtype: str = "float32"):
    """(JAX model, JAX params, port model, port params) in compute dtype
    ``dtype``; JAX's functions jitted once."""
    jcfg, cfg = reduced(compute_dtype=dtype)
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(jnp.asarray, numpy_params())
    jm.loss_fn, jm.prefill, jm.decode_step = (jax.jit(f) for f in
                                              (jm.loss_fn, jm.prefill, jm.decode_step))
    return jm, jp, build_model(cfg, device="cpu"), port_params(cfg, jp)


def port_params(cfg, jp):
    return lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def batch_of(cfg, batch: int = B, seq: int = S + 1, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
            "patches": rng.normal(size=(batch, cfg.vlm.n_patches, cfg.d_model)).astype(
                np.float32)}


def close(got, want, rel: float = 1e-5, what: str = "") -> None:
    """|got - want| <= rel x max|want|, elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float32) - want).max())
    assert err <= rel * scale, (what, err, scale)


# ------------------------------------------------------------- configs -----
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_build_model_builds_every_config(arch):
    """No family is left out: every config's reduced model builds, and
    its cache and one prefill run (the frontend stubs given)."""
    cfg = dataclasses.replace(configs.get_reduced_config(arch), compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 3), dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros((1, cfg.vlm.n_patches, cfg.d_model))
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((1, cfg.enc_dec.n_frames, cfg.d_model))
    assert model.prefill(params, batch).shape == (1, cfg.vocab_size)
    assert model.init_cache(1, 4) is not None


def test_init_matches_reference_tree_and_counts():
    """The port's own init: the reference's dense tree (paths, shapes,
    dtypes), seeded; and at full size the reference's 34 388 917 248
    parameters (param_count plus the 2L + 1 norm scales): 68.78 GB in
    bf16 storage."""
    jm, _, model, _ = models()
    ours = model.init(torch.Generator().manual_seed(0))
    assert isinstance(ours, DecoderLM)
    got = {"/".join(p): tuple(x.shape) for p, x in tree_leaves_with_path(lm_params_to_numpy(ours))}
    want = {"/".join(str(getattr(k, "key", k)) for k in p): tuple(x.shape)
            for p, x in jax.tree_util.tree_leaves_with_path(
                jax.eval_shape(jm.init, jax.random.PRNGKey(0)))}
    assert got == want and "unembed" in got
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(ours.parameters(), again.parameters()))
    full = configs.get_config(ARCH)
    jfull = jax.eval_shape(jbuild_model(jconfigs.get_config(ARCH)).init, jax.random.PRNGKey(0))
    n = sum(x.size for x in jax.tree.leaves(jfull))
    assert n == 34_388_917_248 == param_count(full)[0] + (2 * full.n_layers + 1) * full.d_model
    assert 2 * n == 68_777_834_496


# -------------------------------------------------------------- model -----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_loss_matches_jax(dtype, monkeypatch):
    """loss_fn over [patches ; text]: the P patch positions carry label 0
    and mask 0, so the mean is over the S text positions; against JAX's
    loss, and against the text positions' next-token cross-entropy of the
    same forward's logits, computed apart."""
    jm, jp, model, params = models(dtype)
    cfg = model.cfg
    batch = batch_of(cfg)
    seen = {}
    cross_entropy = model_mod._cross_entropy

    def spy(logits, labels, mask=None):
        seen.update(logits=logits.detach(), labels=labels, mask=mask)
        return cross_entropy(logits, labels, mask)

    monkeypatch.setattr(model_mod, "_cross_entropy", spy)
    loss, metrics = model.loss_fn(params, batch)
    jloss, jmetrics = jm.loss_fn(jp, jax.tree.map(jnp.asarray, batch))
    assert set(metrics) == set(jmetrics) == {"lm_loss", "loss"} and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=1e-5 if dtype == "float32" else BF16_EPS)
    n = cfg.vlm.n_patches
    labels = torch.tensor(batch["tokens"][:, 1:]).long()
    assert seen["logits"].shape == (B, n + S, cfg.vocab_size)
    assert torch.equal(seen["labels"], torch.cat([torch.zeros((B, n)).long(), labels], 1))
    assert torch.equal(seen["mask"], torch.cat([torch.zeros((B, n)), torch.ones((B, S))], 1))
    nll = torch.nn.functional.cross_entropy(
        seen["logits"][:, n:].float().reshape(-1, cfg.vocab_size), labels.reshape(-1))
    np.testing.assert_allclose(float(loss), float(nll), rtol=1e-5)
    # the patches reach the text's loss
    other = dict(batch, patches=batch["patches"][::-1].copy())
    assert abs(float(model.loss_fn(params, other)[0]) - float(loss)) > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """prefill over [patches ; tokens] against JAX's; it differs from the
    text alone (the same weights as a dense model: the family's prefill
    needs its patches, as the reference's does).  Decode is the dense
    family's, text only from position 0: each step's logits against JAX's,
    and in float32 the last against the text-alone prefill."""
    jm, jp, model, params = models(dtype)
    cfg = model.cfg
    tol = 1e-5 if dtype == "float32" else 2 * BF16_EPS
    batch = batch_of(cfg, seq=S)
    got = model.prefill(params, batch)
    assert got.shape == (B, cfg.vocab_size) and got.dtype == cfg.cdtype()
    close(got, jm.prefill(jp, jax.tree.map(jnp.asarray, batch)), tol, "prefill")
    with pytest.raises(KeyError, match="patches"):
        model.prefill(params, {"tokens": batch["tokens"]})
    dense = build_model(dataclasses.replace(cfg, family="dense"), device="cpu")
    alone = dense.prefill(params, {"tokens": batch["tokens"]})
    assert float((alone - got).abs().max()) > 1e-2 * float(got.abs().max())
    cache, jcache = model.init_cache(B, S), jm.init_cache(B, S)
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        logits, cache = model.decode_step(params, cache, batch["tokens"][:, t], pos)
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(batch["tokens"][:, t]),
                                         jnp.asarray(pos))
        close(logits, jlogits, tol, f"decode {t}")
    if dtype == "float32":
        np.testing.assert_allclose(logits.numpy(), alone.numpy(), rtol=1e-3, atol=1e-4)
        assert torch.equal(logits.argmax(-1), alone.argmax(-1))


def test_train_step_matches_jax(monkeypatch):
    """One make_train_step (float32 compute, 2 microbatches, the patches
    reshaped with the tokens): the gradients handed to AdamW against JAX's,
    the metrics, and the parameters and AdamW state after the step."""
    jcfg, cfg = reduced(compute_dtype="float32", grad_accum=2)
    jm, jp = jbuild_model(jcfg), jax.tree.map(jnp.asarray, numpy_params())
    opt = dataclasses.replace(step_mod.opt_config_for(cfg), warmup_steps=1, eps=1e-3)
    jopt = joptimizer.AdamWConfig(**dataclasses.asdict(opt))
    batch = batch_of(cfg, batch=4, seed=3)
    jnew, jstate, jmetrics = jax.jit(jmake_train_step(jm, jopt))(
        jp, joptimizer.init_adamw(jp, jopt), jax.tree.map(jnp.asarray, batch))
    model = build_model(cfg, device="cpu")
    seen = {}
    update = step_mod.adamw_update

    def spy(grads, *a, **kw):
        seen["grads"] = tree_map(lambda t: t.float().clone(), grads)
        return update(grads, *a, **kw)

    monkeypatch.setattr(step_mod, "adamw_update", spy)
    params = port_params(cfg, jp)
    new, state, metrics = step_mod.make_train_step(model, opt)(
        params, optimizer.init_adamw(params, opt), batch)
    for k in ("loss_mean", "loss", "lm_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)
    clip = min(1.0, opt.grad_clip / float(jmetrics["grad_norm"]))
    jgrads = {tuple(str(k.key) for k in p): np.asarray(m, np.float32) / ((1 - opt.beta1) * clip)
              for p, m in jax.tree_util.tree_leaves_with_path(jstate.m)}
    grads = dict(tree_leaves_with_path(tree_map(
        lambda x: np.stack([t.numpy() for t in x]) if isinstance(x, Stacked) else x.numpy(),
        seen["grads"], is_leaf=lambda x: isinstance(x, Stacked))))
    assert set(grads) == set(jgrads)
    for path, g in jgrads.items():
        close(grads[path], g, 1e-5, "grad " + "/".join(path))
        assert grads[path].any(), path
    for (p, g), w in zip(tree_leaves_with_path(lm_params_to_numpy(new)), jax.tree.leaves(jnew)):
        close(g, w, 1e-5, "/".join(p))
    for ours, theirs in ((state.m, jstate.m), (state.v, jstate.v)):
        for (p, g), w in zip(tree_leaves_with_path(tree_map(lambda t: t.float(), ours)),
                             jax.tree.leaves(theirs)):
            close(g, w, 1e-5, "/".join(p))


# ------------------------------------------------------------ serving -----
def test_engine_generates_jax_tokens():
    """float32, 2 slots, 5 requests, text only (a Request carries no
    patches, in the reference as in the port): the tokens and serve.*
    counters equal the JAX engine's."""
    jm, jp, model, params = models()
    prompts = [[1 + r, 2, 3, 5 + r][: 2 + r % 3] for r in range(5)]

    def serve(engine_cls, request_cls, m, p):
        eng = engine_cls(m, batch_slots=B, max_seq=S)
        for r, prompt in enumerate(prompts):
            eng.submit(request_cls(rid=r, prompt=prompt, max_new_tokens=5))
        return {req.rid: req.generated for req in eng.run(p)}, eng

    want, jeng = serve(JServeEngine, JRequest, jm, jp)
    got, eng = serve(ServeEngine, Request, model, params)
    assert got == want and len(got) == 5 and all(len(g) == 5 for g in got.values())
    assert eng.stats() == jeng.stats()


def test_entry_points_on_cpu(tmp_path, capsys):
    """launch.train through FrontendPipeline's patches; launch.serve
    token-only, as the reference's launchers run llava."""
    log = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
                             "--seq", "16", "--device", "cpu", "--ckpt_dir", str(tmp_path)])
    assert [m["step"] for m in log] == [2] and np.isfinite(log[0]["loss_mean"])
    done = launch_serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                              "--max_new", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    out = capsys.readouterr().out
    assert "step 2 loss" in out and "served 3 requests (12 tokens)" in out
