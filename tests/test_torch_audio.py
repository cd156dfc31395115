"""The port's audio family (whisper's encoder-decoder: ``model._sinusoid``,
``_encoder``, ``_cross_kv``, the ``decoder_cross`` block, the cross branch
of ``attention_block``, the ``{"self", "cross"}`` cache, training,
checkpoints, serving and the entry points) against the JAX package on the
CPU, on the reduced whisper_tiny (2 + 2 layers, d_model 64, 16 frames).

JAX's parameters (``init(PRNGKey(0))``) cross into the port through
``convert.lm_params_from_numpy``; the frames and tokens come from a numpy
seed.  Tolerances, relative to the scale (largest magnitude) of the
compared quantity:

* float32: outputs, logits, losses and gradients to ``1e-5`` (the two
  frameworks sum in other orders); post-step parameters and moments to
  ``1e-5`` (AdamW ``eps`` 1e-3, as in ``test_torch_train.py``), bf16
  moments to one bf16 epsilon;
* bfloat16 logits: two bf16 epsilons (2 x 2^-7), the tolerance of
  ``test_torch_lm.py``;
* ``_sinusoid``: two float32 ulps of the largest angle, ``2 x 2^-23 x
  max(position)`` absolute (XLA's and PyTorch's float32 ``exp`` round 3
  of the 32 reduced frequencies one ulp apart, and their ``sin`` and
  ``cos`` differ in the last ulp; an angle's ulp grows with the position:
  measured 9.4e-7 at position 15, 3.8e-6 at 40, 3.1e-5 at 447 and 1.2e-4
  at whisper's 1 499, 0.8-0.95 of one such ulp).

The reference has two faults here that the port does not carry over
(``ROADMAP.md`` §3): with ``scan_layers=False`` its decoder ignores the
frames (``test_scan_layers_false_ignores_the_frames_in_the_reference``),
and nothing of it fills the decode cache's cross pair, so its engine
decodes against zeros (``test_decode_matches_prefill_with_the_encoders_cross_cache``
records the gap; the port's engine keeps the zero pair, as the
reference's does).
"""
import dataclasses
import functools
import json
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.train import optimizer as joptimizer  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.train.step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import param_count  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    kv_cache_from_numpy, lm_params_from_numpy, lm_params_to_numpy,
)
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention, layers, transformer  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.model import DecoderLM, build_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.tree import Stacked, tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402

ARCH = "whisper_tiny"
BF16_EPS = 2.0**-7
B, S = 2, 12


def reduced(**kw):
    """(JAX cfg, port cfg) of the reduced whisper_tiny with ``kw``."""
    return (dataclasses.replace(jconfigs.get_reduced_config(ARCH), **kw),
            dataclasses.replace(configs.get_reduced_config(ARCH), **kw))


@functools.lru_cache(maxsize=None)
def numpy_params() -> dict:
    """JAX's init of the reduced config (PRNGKey(0)) as a numpy tree."""
    jcfg, _ = reduced()
    return jax.tree.map(np.asarray, jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(0)))


def listed(tree: dict) -> dict:
    """A stacked tree in the list layout (``scan_layers=False``)."""
    out = dict(tree)
    for name in ("encoder", "layers"):
        depth = jax.tree.leaves(tree[name])[0].shape[0]
        out[name] = [jax.tree.map(lambda a, i=i: a[i], tree[name]) for i in range(depth)]
    return out


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


def rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def batch_of(cfg, batch: int = B, seq: int = S + 1, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
            "frames": rand(rng, batch, cfg.enc_dec.n_frames, cfg.d_model)}


def close(got, want, rel: float = 1e-5, what: str = "") -> None:
    """|got - want| <= rel x max|want|, elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float32) - want).max())
    assert err <= rel * scale, (what, err, scale)


def logits_tol(dtype: str) -> float:
    return 1e-5 if dtype == "float32" else 2 * BF16_EPS


def jax_cross_kv(jcfg, jp, enc_out):
    """The reference's ``_cross_kv`` on its stacked layers (its body: the
    function itself is local to ``build_model``)."""
    b, f, _ = enc_out.shape
    shape = (b, f, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    return jax.vmap(lambda lp: ((enc_out @ lp["cross"]["wk"]).reshape(shape),
                                (enc_out @ lp["cross"]["wv"]).reshape(shape)))(jp["layers"])


@functools.partial(jax.jit, static_argnums=0)
def jax_encoder(jcfg, jp, frames):
    """The reference's ``_encoder`` in float32, from its module functions."""
    f = frames.shape[1]
    x = frames + jmodel._sinusoid(jnp.arange(f), jcfg.d_model, jnp.float32)[None]
    return jtransformer.stack_forward(jp["encoder"], x, jnp.arange(f), jcfg, kind="dense",
                                      n_layers=jcfg.enc_dec.n_encoder_layers, causal=False,
                                      use_rope=False)[0]


# ----------------------------------------------------- layers, blocks -----
@pytest.mark.parametrize("case", ["reduced", "whisper_frames", "decode"])
def test_sinusoid_matches_jax(case):
    pos, d = {"reduced": (np.arange(16), 64), "whisper_frames": (np.arange(1500), 384),
              "decode": (np.array([[3], [40]]), 64)}[case]
    tol = 2 * 2.0**-23 * pos.max()
    for dtype in ("float32", "bfloat16"):
        got = model_mod._sinusoid(torch.tensor(pos), d, getattr(torch, dtype))
        want = jmodel._sinusoid(jnp.asarray(pos, jnp.int32), d, getattr(jnp, dtype))
        assert got.shape == (*pos.shape, d) and got.dtype == getattr(torch, dtype)
        atol = tol if dtype == "float32" else 2 * BF16_EPS
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                                   atol=atol)
    # sines of the first half, cosines of the second
    got = model_mod._sinusoid(torch.tensor(pos), d, torch.float32)
    assert torch.allclose(got[..., : d // 2] ** 2 + got[..., d // 2:] ** 2,
                          torch.ones(()), atol=1e-6)


@pytest.mark.parametrize("hkv", [2, 1])
def test_cross_attention_block_matches_jax(hkv):
    """q from x, the plain non-causal attention over the encoder's K/V,
    then wo; the positions (no RoPE) and the cache (passed back untouched)
    play no part."""
    jcfg, cfg = reduced(compute_dtype="float32", n_kv_heads=hkv)
    jp = jattention.init_attention(jax.random.PRNGKey(1), jcfg, jnp.float32)
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(1)
    x = rand(rng, B, 5, cfg.d_model)
    k, v = (rand(rng, B, 16, hkv, cfg.resolved_head_dim) for _ in range(2))
    out, cache = attention.attention_block(p, torch.tensor(x), torch.arange(5), cfg,
                                           cross_kv=(torch.tensor(k), torch.tensor(v)))
    jout, _ = jattention.attention_block(jp, jnp.asarray(x), jnp.arange(5), jcfg,
                                         cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    assert cache is None
    close(out, jout, what="cross attention")
    kept = {"k": torch.zeros(1)}
    out2, cache = attention.attention_block(p, torch.tensor(x), torch.arange(5) + 7, cfg,
                                            cache=kept, cross_kv=(torch.tensor(k),
                                                                  torch.tensor(v)))
    assert cache is kept and torch.equal(out2, out)


@pytest.mark.parametrize("shape", ["whisper_frames", "ragged_gqa"])
def test_chunked_attention_non_causal_padded_matches_jax(shape):
    """The encoder's attention: non-causal over keys that are no multiple
    of the chunk (whisper's 1 500 frames in chunks of 512: 36 padded keys
    masked; 20 keys in chunks of 8, 4 query heads over 2 KV heads):
    outputs and the custom backward's dq, dk, dv against JAX's custom VJP."""
    b, s, h, hkv, dh, chunk = {"whisper_frames": (1, 1500, 6, 6, 64, 512),
                               "ragged_gqa": (2, 20, 4, 2, 8, 8)}[shape]
    rng = np.random.default_rng(2)
    q, k, v = rand(rng, b, s, h, dh), rand(rng, b, s, hkv, dh), rand(rng, b, s, hkv, dh)
    ct = rand(rng, b, s, h, dh)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = layers.chunked_attention(tq, tk, tv, causal=False, chunk=chunk)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(ct))
    jout, vjp = jax.vjp(lambda a, b_, c: jlayers.chunked_attention(a, b_, c, causal=False,
                                                                   chunk=chunk),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    close(out, jout, what="out")
    for name, g, w in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(ct))):
        close(g, w, what=name)
    # the padding is masked: the same as the plain core over the real keys
    close(out, layers.attention(*(torch.tensor(a) for a in (q, k, v)), causal=False),
          what="plain")


def test_encoder_and_cross_kv_match_jax():
    """_encoder (frames + sinusoid, dense blocks, non-causal, no RoPE) and
    _cross_kv (each decoder layer's K/V, stacked [L, B, F, Hkv, dh])."""
    jm, jp, model, params = models()
    cfg = model.cfg
    frames = batch_of(cfg)["frames"]
    p = params.tree()
    enc = model_mod._encoder(cfg, p, torch.tensor(frames))
    jenc = jax_encoder(jm.cfg, jp, jnp.asarray(frames))
    close(enc, jenc, what="encoder")
    kv = model_mod._cross_kv(cfg, p, enc)
    jkv = jax_cross_kv(jm.cfg, jp, jenc)
    assert kv[0].shape == (cfg.n_layers, B, cfg.enc_dec.n_frames, cfg.n_kv_heads,
                           cfg.resolved_head_dim)
    for got, want in zip(kv, jkv):
        close(got, want, what="cross kv")
    # the encoder attends both ways: the last frame moves the first's output
    moved = frames.copy()
    moved[:, -1] += 1.0
    enc2 = model_mod._encoder(cfg, p, torch.tensor(moved))
    assert not torch.allclose(enc2[:, 0], enc[:, 0])


def test_decoder_cross_block_needs_the_encoder():
    """The reference's decoder_cross block without cross_kv falls through
    to causal self-attention with the cross weights; the port's raises."""
    _, _, model, params = models()
    x = torch.zeros(1, 3, model.cfg.d_model)
    with pytest.raises(ValueError, match="cross_kv"):
        transformer.block_forward(params.tree()["layers"][0], x, torch.arange(3), model.cfg,
                                kind="decoder_cross")


# -------------------------------------------------------------- model -----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_prefill_and_decode_match_jax(dtype):
    """loss_fn's metrics, prefill's last logits and S decode steps against
    the zero cross cache (the reference's serving state: init_cache's
    pair, which nothing fills), each step's logits and the self cache; the
    cross pair stays zero."""
    jm, jp, model, params = models(dtype)
    cfg, tol = model.cfg, logits_tol(dtype)
    batch = batch_of(cfg)
    loss, metrics = model.loss_fn(params, batch)
    jloss, jmetrics = jm.loss_fn(jp, jax.tree.map(jnp.asarray, batch))
    assert set(metrics) == set(jmetrics) == {"lm_loss", "loss"} and loss is metrics["loss"]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5 if dtype == "float32"
                               else BF16_EPS)
    pb = {"tokens": batch["tokens"][:, :S], "frames": batch["frames"]}
    got = model.prefill(params, pb)
    assert got.shape == (B, cfg.vocab_size) and got.dtype == cfg.cdtype()
    close(got, jm.prefill(jp, jax.tree.map(jnp.asarray, pb)), tol, "prefill")

    cache, jcache = model.init_cache(B, S), jm.init_cache(B, S)
    assert set(cache) == {"self", "cross"} and isinstance(cache["cross"], tuple)
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        logits, cache = model.decode_step(params, cache, pb["tokens"][:, t], pos)
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(pb["tokens"][:, t]),
                                         jnp.asarray(pos))
        close(logits, jlogits, tol, f"decode {t}")
    jc = kv_cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    for k in ("k", "v"):
        assert cache["self"][k].dtype == jc["self"][k].dtype == cfg.cdtype()
        close(cache["self"][k], jc["self"][k].float().numpy(), tol, k)
    assert all(not c.any() and c.dtype == cfg.cdtype() for c in cache["cross"])


def test_decode_matches_prefill_with_the_encoders_cross_cache():
    """float32: with the cache's cross pair filled by
    _cross_kv(_encoder(frames)), S decode steps give prefill's last logits
    (the reference's test tolerance, rtol 1e-3 / atol 1e-4, and the same
    argmax) and JAX's decode with its own encoder's pair to 1e-5.  Against
    the zero pair (fault 2: what both engines serve) decode misses prefill
    by far more."""
    jm, jp, model, params = models()
    cfg = model.cfg
    batch = batch_of(cfg, seed=4)
    toks, frames = batch["tokens"][:, :S], batch["frames"]
    want = model.prefill(params, {"tokens": toks, "frames": frames})
    p = params.tree()
    filled, zero = model.init_cache(B, S), model.init_cache(B, S)
    filled["cross"] = model_mod._cross_kv(cfg, p, model_mod._encoder(cfg, p,
                                                                     torch.tensor(frames)))
    jcache = jm.init_cache(B, S)
    jcache["cross"] = jax_cross_kv(jm.cfg, jp, jax_encoder(jm.cfg, jp, jnp.asarray(frames)))
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        logits, filled = model.decode_step(params, filled, toks[:, t], pos)
        blind, zero = model.decode_step(params, zero, toks[:, t], pos)
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t]), jnp.asarray(pos))
        close(logits, jlogits, what=f"filled decode {t}")
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-3, atol=1e-4)
    assert torch.equal(logits.argmax(-1), want.argmax(-1))
    gap = float((blind - want).abs().max())
    assert gap > 100 * float((logits - want).abs().max()) and gap > 1e-2 * float(
        want.abs().max()), gap


def test_scan_layers_false_ignores_the_frames_in_the_reference():
    """Fault 1 of the reference, recorded: at scan_layers=False its
    _cross_kv is None and each decoder_cross block attends to the text
    with the cross weights, so its prefill does not depend on the frames
    at all.  The port computes the cross attention in every layout: its
    list-layout prefill equals its stacked one bit for bit and moves with
    the frames."""
    jcfg, cfg = reduced(compute_dtype="float32", scan_layers=False)
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(jnp.asarray, listed(numpy_params()))
    a, b = batch_of(cfg, seed=5), batch_of(cfg, seed=6)
    a["tokens"] = b["tokens"] = a["tokens"][:, :S]
    jprefill = jax.jit(jm.prefill)
    ja, jb = (np.asarray(jprefill(jp, jax.tree.map(jnp.asarray, x))) for x in (a, b))
    np.testing.assert_array_equal(ja, jb)                   # the frames play no part
    model = build_model(cfg, device="cpu")
    params = lm_params_from_numpy(cfg, listed(numpy_params()), device="cpu")
    _, _, stacked_model, stacked_params = models()
    got = model.prefill(params, a)
    assert torch.equal(got, stacked_model.prefill(stacked_params, a))
    assert float((got - model.prefill(params, b)).abs().max()) > 1e-2 * float(got.abs().max())


# ------------------------------------------------------- init, convert -----
def test_init_matches_reference_tree_and_counts():
    """The port's own init: the reference's leaves (paths, shapes, dtypes),
    zero norms, seeded; param_count plus the norm scales, and at full
    size the reference's 41 157 888 parameters."""
    jm, _, model, _ = models()
    ours = model.init(torch.Generator().manual_seed(0))
    assert isinstance(ours, DecoderLM)
    got = {"/".join(p): (tuple(x.shape), str((x[0] if isinstance(x, Stacked) else x).dtype)[6:])
           for p, x in tree_leaves_with_path(ours.reference_tree(),
                                             lambda x: isinstance(x, Stacked))}
    want = {"/".join(str(getattr(k, "key", k)) for k in p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(
                jax.eval_shape(jm.init, jax.random.PRNGKey(0)))}
    assert got == want and "unembed" not in got              # tied
    assert got["encoder/attn/wq"][0][0] == model.cfg.enc_dec.n_encoder_layers
    assert got["layers/cross/wk"][0][0] == model.cfg.n_layers
    norms = [n for n, _ in ours.named_parameters() if n.rsplit(".", 1)[-1].startswith("ln")
             or n == "final_ln"]
    assert all(not ours.get_parameter(n).any() for n in norms)
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(ours.parameters(), again.parameters()))
    full = configs.get_config(ARCH)
    jfull = jax.eval_shape(jbuild_model(jconfigs.get_config(ARCH)).init, jax.random.PRNGKey(0))
    assert sum(x.size for x in jax.tree.leaves(jfull)) == 41_157_888
    ours = build_model(full, device="cpu").init(torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in ours.parameters()) == 41_157_888
    # param_count leaves out the norm scales (2 an encoder layer, 3 a decoder layer, 1 final)
    n_norms = (2 * full.enc_dec.n_encoder_layers + 3 * full.n_layers + 1) * full.d_model
    assert param_count(full)[0] + n_norms == 41_157_888


@pytest.mark.parametrize("scan_layers", [True, False])
def test_convert_round_trip_and_cache(scan_layers):
    """Both layer layouts of the encoder and decoder_cross stacks read,
    bit for bit; lm_params_to_numpy gives the reference's tree back; the
    audio cache crosses with its cross tuple."""
    jcfg, cfg = reduced(scan_layers=scan_layers, param_dtype="bfloat16")
    tree = numpy_params() if scan_layers else listed(numpy_params())
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jtree), device="cpu")
    assert params.encoder[1].attn["wq"].dtype == torch.bfloat16
    back = lm_params_to_numpy(params, stacked=scan_layers)
    assert jax.tree.structure(back) == jax.tree.structure(jtree)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    with pytest.raises(ValueError, match="encoder"):
        lm_params_from_numpy(cfg, dict(tree, encoder=[]), device="cpu")
    jcache = jax.tree.map(np.asarray, jbuild_model(jcfg).init_cache(B, 4))
    got, want = kv_cache_from_numpy(jcache, device="cpu"), build_model(
        cfg, device="cpu").init_cache(B, 4)
    assert isinstance(got["cross"], tuple) and len(got["cross"]) == 2
    for g, w, j in zip(tree_leaves(got), tree_leaves(want), jax.tree.leaves(jcache)):
        assert g.shape == w.shape == j.shape and g.dtype == w.dtype == torch.bfloat16


# ---------------------------------------------------- training, serving -----
TRAIN_CASES = {
    # the published options (float32 moments), and bf16 factored moments
    # over 2 microbatches (the encoder's stacked leaves factored too)
    "published": {},
    "factored": dict(optimizer_dtype="bfloat16", optimizer_factored=True, grad_accum=2),
}


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's train step for each case, run once and shared: (port cfg,
    params before, batch, params after, AdamW state, metrics, AdamW
    config).  The cases compile on two threads."""
    def one(case):
        jcfg, cfg = reduced(compute_dtype="float32", **TRAIN_CASES[case])
        jm, jp = jbuild_model(jcfg), jax.tree.map(jnp.asarray, numpy_params())
        opt = dataclasses.replace(step_mod.opt_config_for(cfg), warmup_steps=1, eps=1e-3)
        jopt = joptimizer.AdamWConfig(**dataclasses.asdict(opt))
        batch = batch_of(cfg, batch=4, seed=3)
        new, state, metrics = jax.jit(jmake_train_step(jm, jopt))(
            jp, joptimizer.init_adamw(jp, jopt), jax.tree.map(jnp.asarray, batch))
        return cfg, jp, batch, new, state, metrics, opt

    numpy_params()
    with ThreadPoolExecutor(len(TRAIN_CASES)) as pool:
        futures = {case: pool.submit(one, case) for case in TRAIN_CASES}
        return {case: f.result() for case, f in futures.items()}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_jax(case, jax_steps, monkeypatch):
    """One make_train_step from the same parameters and batch (frames
    through the encoder): the gradients handed to AdamW against JAX's (its
    first moment holds (1 - beta1) x clip x g), the tied embedding's (the
    gather's and the head's added) and the encoder's among them; the
    metrics; the parameters and AdamW state after the step."""
    cfg, jp, batch, jnew, jstate, jmetrics, opt = jax_steps[case]
    bf16 = cfg.optimizer_dtype == "bfloat16"
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
    assert set(metrics) == set(jmetrics)
    for k in ("loss_mean", "loss", "lm_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)
    clip = min(1.0, opt.grad_clip / float(jmetrics["grad_norm"]))
    jgrads = {tuple(str(k.key) for k in p): np.asarray(m, np.float32) / ((1 - opt.beta1) * clip)
              for p, m in jax.tree_util.tree_leaves_with_path(jstate.m)}
    grads = dict(tree_leaves_with_path(tree_map(
        lambda x: np.stack([t.numpy() for t in x]) if isinstance(x, Stacked) else x.numpy(),
        seen["grads"], is_leaf=lambda x: isinstance(x, Stacked))))
    assert set(grads) == set(jgrads)
    assert ("encoder", "attn", "wq") in grads and ("layers", "cross", "wk") in grads
    for path, g in jgrads.items():
        close(grads[path], g, 4 * BF16_EPS if bf16 else 1e-5, "/".join(path))
        assert grads[path].any(), path
    for (p, g), w in zip(tree_leaves_with_path(lm_params_to_numpy(new)), jax.tree.leaves(jnew)):
        close(g, w, 1e-5, "/".join(p))
    for ours, theirs in ((state.m, jstate.m), (state.v, jstate.v)):
        for (p, g), w in zip(tree_leaves_with_path(tree_map(lambda t: t.float(), ours)),
                             jax.tree.leaves(theirs)):
            close(g, w, BF16_EPS if bf16 else 1e-5, "/".join(p))
    if cfg.optimizer_factored:
        v = state.v["encoder"]["mlp"]["w1"]
        assert (v["row"].shape, v["col"].shape) == ((cfg.enc_dec.n_encoder_layers, cfg.d_model),
                                                   (cfg.enc_dec.n_encoder_layers, cfg.d_ff))


def bits(x) -> np.ndarray:
    """A leaf as a numpy array, bf16 by its bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def port_bits(params, state) -> list:
    """(params, step, m, v) of the port in the reference's leaf order."""
    ref = tree_map(lambda x: torch.stack(list(x)) if isinstance(x, Stacked) else x,
                   params.reference_tree(), is_leaf=lambda x: isinstance(x, Stacked))
    return [bits(x) for x in tree_leaves(ref)] + [np.asarray(state.step, np.int32)] + \
        [bits(x) for x in tree_leaves((state.m, state.v))]


def test_checkpoints_cross_packages_both_ways(tmp_path, jax_steps):
    """After JAX's step with bf16 factored moments: its checkpoint (the
    encoder's stack among the leaves) restores in the port bit for bit;
    after one more step on the port, the port's restores in JAX bit for
    bit, with the same file names and treedef."""
    cfg, _, batch, jp, jstate, _, opt = jax_steps["factored"]
    JaxManager(tmp_path / "jax").save(1, (jp, jstate), blocking=True)
    model = build_model(cfg, device="cpu")
    fresh = model.init(torch.Generator().manual_seed(0))
    (params, state), step = CheckpointManager(tmp_path / "jax").restore(
        (fresh, optimizer.init_adamw(fresh, opt)))
    assert step == 1
    want = [bits(x) for x in jax.tree.leaves((jp, jstate))]
    got = port_bits(params, state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    params, state, _ = step_mod.make_train_step(model, opt)(params, state, batch)
    CheckpointManager(tmp_path / "port").save(2, (params, state), blocking=True)
    (jr, jrs), jstep = JaxManager(tmp_path / "port").restore((jp, jstate))
    assert jstep == 2 and int(jrs.step) == 2
    for g, w in zip([bits(x) for x in jax.tree.leaves((jr, jrs))], port_bits(params, state)):
        np.testing.assert_array_equal(g, w)
    a, b = tmp_path / "jax" / "step_0000000001", tmp_path / "port" / "step_0000000002"
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma["treedef"] == mb["treedef"] and ma["leaves"] == mb["leaves"]
    assert {"name": "0__encoder__attn__wq", "shape": [cfg.enc_dec.n_encoder_layers,
            cfg.d_model, cfg.d_model], "dtype": "float32"} in mb["leaves"]


def test_engine_generates_jax_tokens():
    """float32, 2 slots, 5 requests: the tokens equal the JAX engine's (both
    decode against the zero cross pair, which a refill zeroes again) and
    so do the serve.* counters."""
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
    assert all(not c.any() for c in eng.cache["cross"])


def test_entry_points_on_cpu(tmp_path, capsys):
    """launch.train through FrontendPipeline's frames, launch.serve
    token-only, as the reference's launchers run whisper."""
    log = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
                             "--seq", "16", "--device", "cpu", "--ckpt_dir", str(tmp_path)])
    assert [m["step"] for m in log] == [2] and np.isfinite(log[0]["loss_mean"])
    assert (tmp_path / "step_0000000002" / "manifest.json").exists()
    done = launch_serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                              "--max_new", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    out = capsys.readouterr().out
    assert "step 2 loss" in out and "served 3 requests (12 tokens)" in out
