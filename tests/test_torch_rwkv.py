"""The port's ssm family (``repro_torch.models.rwkv``, the ``ssm`` family of
``build_model``, its conversions, serving and entry points) against the JAX
package on the CPU, on the reduced rwkv6_3b (2 layers, d_model 64, 4 heads
of 16).

The parameters are drawn once by the port's own init, then the leaves the
init leaves constant (the mixes, the decay base ``w0``, the bonus ``u``,
``ln_x``) are redrawn, so that every term of the block is exercised: ``w0``
from [-3, 1] puts the decay ``w = exp(-exp(w0 + ...))`` in ~[0.07, 0.95].
They cross as the reference's numpy tree: into JAX as arrays in the dtypes
of its own init (``w0`` and ``u`` float32), into the port through
``convert.lm_params_from_numpy``.  Inputs are numpy draws from a seed.
Tolerances, relative to the scale (largest magnitude) of the compared
quantity: float32 to ``1e-5`` (the two frameworks sum in other orders);
bf16 to two bf16 epsilons (2 x 2^-7), the tolerance of
``test_torch_lm.py``.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import param_count  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    kv_cache_from_numpy, lm_params_from_numpy, lm_params_to_numpy,
)
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.models.model import DecoderLM, build_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.tree import Stacked, tree_leaves, tree_leaves_with_path  # noqa: E402
from repro_torch.tree import tree_unflatten_like  # noqa: E402

ARCH = "rwkv6_3b"
BF16_EPS = 2.0**-7
B, S = 2, 16
J_SCAN = jax.jit(jrwkv._wkv_scan)
J_CHUNKED = jax.jit(jrwkv._wkv_chunked_parallel)
J_BLOCK = jax.jit(jrwkv.rwkv_block, static_argnums=2)


def reduced(**kw):
    """(JAX cfg, port cfg) of the reduced arch with ``kw`` replaced."""
    return tuple(dataclasses.replace(c.get_reduced_config(ARCH), **kw)
                 for c in (jconfigs, configs))


@functools.lru_cache(maxsize=None)
def numpy_params() -> dict:
    """The reduced arch's parameters as the reference's numpy tree: the
    port's init (seed 0) with the constant leaves redrawn (module
    docstring)."""
    cfg = configs.get_reduced_config(ARCH)
    tree = lm_params_to_numpy(build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    t = tree["layers"]["time"]
    t["w0"] = rng.uniform(-3.0, 1.0, t["w0"].shape).astype(np.float32)
    t["u"] = rng.normal(0.0, 0.5, t["u"].shape).astype(np.float32)
    t["mix"] = rng.uniform(0.0, 1.0, t["mix"].shape).astype(np.float32)
    t["ln_x"] = rng.normal(0.0, 0.1, t["ln_x"].shape).astype(np.float32)
    c = tree["layers"]["channel"]
    c["mix"] = rng.uniform(0.0, 1.0, c["mix"].shape).astype(np.float32)
    return tree


def jax_params(jcfg):
    """``numpy_params`` as JAX arrays in the dtypes of the reference's own
    init for ``jcfg``."""
    want = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a, w: jnp.asarray(a, w.dtype), numpy_params(), want)


@functools.lru_cache(maxsize=None)
def models(dtype: str = "float32", **kw):
    """(JAX model, JAX params, port model, port params) in compute dtype
    ``dtype``."""
    jcfg, cfg = reduced(compute_dtype=dtype, **kw)
    jp = jax_params(jcfg)
    return jbuild_model(jcfg), jp, build_model(cfg, device="cpu"), \
        lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def close(got, want, rel: float = 1e-5, what: str = "") -> None:
    """|got - want| <= rel x max|want|, elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float32) - want).max())
    assert err <= rel * scale, (what, err, scale)


def rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def wkv_inputs(seed: int, t: int = 77, h: int = 3, p: int = 16, b: int = 2) -> dict:
    """r, k, v, the reference test's decay range uniform(0.05, 0.999), u and
    a carried state."""
    rng = np.random.default_rng(seed)
    return dict(r=rand(rng, b, t, h, p), k=rand(rng, b, t, h, p), v=rand(rng, b, t, h, p),
                w=rng.uniform(0.05, 0.999, (b, t, h, p)).astype(np.float32),
                u=rand(rng, h, p), state=rand(rng, b, h, p, p))


def layer0(jp):
    """Layer 0 of the JAX stack (JAX arrays) and the port's copy (tensors)."""
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    return jl, jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jl)


# ------------------------------------------------------- init, convert -----
def test_init_matches_reference_tree():
    """The port's init under a bf16 param_dtype: the reference's leaves
    (paths, [L, ...] shapes, dtypes: w0 and u float32), the reference's
    constants, seeded; and the full config's sizes."""
    jcfg, cfg = reduced(param_dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    ours = model.init(torch.Generator().manual_seed(0))
    assert isinstance(ours, DecoderLM)
    jp = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    got = {"/".join(p): (tuple(x.shape), str(x[0].dtype if isinstance(x, Stacked) else x.dtype)[6:])
           for p, x in tree_leaves_with_path(ours.reference_tree(),
                                             lambda x: isinstance(x, Stacked))}
    want = {"/".join(str(k.key) for k in p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(jp)}
    assert got == want
    assert got["layers/time/w0"][1] == got["layers/time/u"][1] == "float32"
    assert got["layers/time/wr"][1] == "bfloat16"
    t = ours.layers[0].time
    assert torch.equal(t["w0"], torch.full_like(t["w0"], -6.0)) and not t["u"].any()
    assert torch.equal(t["mix"].float(), torch.full((5, cfg.d_model), 0.5))
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(ours.parameters(), again.parameters()))
    assert param_count(configs.get_config(ARCH))[0] == 3_344_957_440   # the reference's estimate
    shapes = jax.eval_shape(jbuild_model(jconfigs.get_config(ARCH)).init, jax.random.PRNGKey(0))
    assert sum(x.size for x in jax.tree.leaves(shapes)) == 3_075_770_880


def test_convert_round_trip_keeps_dtypes():
    """A bf16 param_dtype: w0 and u cross in float32 (not rounded to bf16),
    the rest bit for bit; lm_params_to_numpy gives the reference's stacked
    tree back whatever ``stacked`` says (the family has no list layout);
    the recurrent cache crosses in its dtypes."""
    jcfg, cfg = reduced(param_dtype="bfloat16")
    jp = jax_params(jcfg)
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    t = params.layers[1].time
    assert t["w0"].dtype == t["u"].dtype == torch.float32 and t["wr"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["u"].numpy(), numpy_params()["layers"]["time"]["u"][1])
    for stacked in (True, False):
        back = lm_params_to_numpy(params, stacked=stacked)
        assert jax.tree.structure(back) == jax.tree.structure(jp)
        for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    with pytest.raises(ValueError, match="layers"):
        lm_params_from_numpy(cfg, dict(jax.tree.map(np.asarray, jp), layers=[]), device="cpu")

    jm, _, model, _ = models("bfloat16")
    jcache = jax.tree.map(np.asarray, jm.init_cache(B, 4))
    got, want = kv_cache_from_numpy(jcache, device="cpu"), model.init_cache(B, 4)
    assert set(got) == set(want) == {"state", "x_time", "x_chan"}
    for k in got:
        assert got[k].shape == want[k].shape == jcache[k].shape
        assert got[k].dtype == want[k].dtype
    assert want["state"].dtype == torch.float32 and want["x_time"].dtype == torch.bfloat16


# ------------------------------------------------------------------ WKV -----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_wkv_matches_jax(form, dtype):
    """T = 77 (not a multiple of either chunk), the state carried in: the
    port's form against the reference's on the same inputs (r, k, v and u
    in ``dtype``, w float32), outputs and final state; the chunked output
    in r's dtype, the scan's float32.  In float32 the chunked form also
    against the port's own scan at the reference test's 1e-4."""
    x = wkv_inputs(0)
    dt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    port = {n: torch.tensor(a) for n, a in x.items()}
    jx = {n: jnp.asarray(a) for n, a in x.items()}
    for n in ("r", "k", "v", "u"):
        port[n], jx[n] = port[n].to(dt), jx[n].astype(jdt)
    fn, jfn = (rwkv._wkv_scan, J_SCAN) if form == "scan" else (rwkv._wkv_chunked_parallel,
                                                                J_CHUNKED)
    out, state = fn(**port)
    jout, jstate = jfn(**jx)
    assert out.dtype == (torch.float32 if form == "scan" else dt)
    assert str(out.dtype)[6:] == str(jout.dtype) and state.dtype == torch.float32
    rel = 1e-5 if dtype == "float32" else 2 * BF16_EPS
    close(out, np.asarray(jout, np.float32), rel, "out")
    close(state, jstate, 1e-5, "state")
    if form == "chunked" and dtype == "float32":
        o_scan, s_scan = rwkv._wkv_scan(**port)
        np.testing.assert_allclose(out.numpy(), o_scan.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(state.numpy(), s_scan.numpy(), rtol=1e-4, atol=1e-4)


def test_wkv_underflow_recorded():
    """Where the decay underflows (w0 + lora > ~4.5: w = exp(-exp(.)) below
    float32's smallest normal), the chunked form's floor log(max(w, 1e-38))
    differs by platform.  XLA on the CPU flushes subnormals: the floor
    (itself subnormal) is 0, the log -inf and the reference's output NaN.
    torch keeps subnormals: the floor holds, the port's output is finite,
    but not the recurrence's: the cumulative log-decay passes the +-50
    clamp within a chunk, so exp(L_{t-1}) exp(-L_s) reads 1 where the
    decay is ~0, and the output parts from the sequential scan by far
    more than the 1e-4 that holds in the reference test's decay range.
    The sequential scan is exact in both frameworks."""
    x = wkv_inputs(1, t=40)
    dec = np.random.default_rng(2).uniform(4.4, 6.0, x["w"].shape).astype(np.float32)
    w = np.exp(-np.exp(dec.astype(np.float64))).astype(np.float32)   # subnormal or 0
    assert (w < np.finfo(np.float32).tiny).mean() > 0.8
    x["w"] = w
    port = {n: torch.tensor(a) for n, a in x.items()}
    jx = {n: jnp.asarray(a) for n, a in x.items()}
    jout, _ = J_CHUNKED(**jx)
    assert np.isnan(np.asarray(jout)).any()
    out, state = rwkv._wkv_chunked_parallel(**port)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    o_scan, s_scan = rwkv._wkv_scan(**port)
    jo_scan, js_scan = J_SCAN(**jx)
    close(o_scan, jo_scan, 1e-5, "scan at underflow")
    close(s_scan, js_scan, 1e-5, "scan state at underflow")
    assert float((out - o_scan).abs().max()) > 1e-2 * float(o_scan.abs().max())


# ---------------------------------------------------------------- block -----
@pytest.mark.parametrize("t", [None, 1, 3])
def test_rwkv_block_matches_jax(t):
    """Without a cache (T = 20: the chunked form), and with a cache of
    random state and token-shift rows over T = 1 (decode) and T = 3 (the
    scan over a cached state): the output and the new cache against the
    reference's; the cache written in place; x_time the block's input's
    last row, x_chan the channel mix's."""
    jm, jp, model, _ = models()
    cfg = model.cfg
    jl, pl = layer0(jp)
    rng = np.random.default_rng(3)
    x = rand(rng, B, t or 20, cfg.d_model)
    if t is None:
        out, cache = rwkv.rwkv_block(pl, torch.tensor(x), cfg)
        jout, _ = J_BLOCK(jl, jnp.asarray(x), jm.cfg)
        assert cache is None
        close(out, jout, what="out")
        return
    h, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    c = dict(state=rand(rng, B, h, hd, hd), x_time=rand(rng, B, cfg.d_model),
             x_chan=rand(rng, B, cfg.d_model))
    cache = {k: torch.tensor(v) for k, v in c.items()}
    views = dict(cache)
    out, new = rwkv.rwkv_block(pl, torch.tensor(x), cfg, cache=cache)
    jout, jnew = J_BLOCK(jl, jnp.asarray(x), jm.cfg,
                         cache={k: jnp.asarray(v) for k, v in c.items()})
    close(out, jout, what="out")
    for k in c:
        close(new[k], jnew[k], what=k)
        assert new[k] is views[k]                   # written in place
    np.testing.assert_array_equal(new["x_time"].numpy(), x[:, -1])


# ---------------------------------------------------------------- model -----
def tokens(vocab: int, batch: int = B, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (batch, S + 1)).astype(np.int32)


def test_loss_fn_and_gradients_match_jax():
    """float32: the loss and every parameter's gradient (w0 and u among
    them) to 1e-5 of JAX's; the chunked WKV under the block remat and each
    chunk's checkpoint."""
    jm, jp, model, params = models()
    toks = tokens(model.cfg.vocab_size)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {"tokens": jnp.asarray(toks)})
    params.requires_grad_(True)
    try:
        loss, metrics = model.loss_fn(params, {"tokens": toks})
        tree = params.reference_tree()
        grads = tree_unflatten_like(tree, list(torch.autograd.grad(loss, tree_leaves(tree))))
    finally:
        params.requires_grad_(False)
    loss = loss.detach()
    assert set(metrics) == set(jmetrics) == {"lm_loss", "loss"}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = dict(tree_leaves_with_path(grads, lambda x: isinstance(x, Stacked)))
    want = {tuple(str(k.key) for k in p): g for p, g in jax.tree_util.tree_leaves_with_path(jgrads)}
    assert set(got) == set(want)
    for path, g in want.items():
        mine = got[path]
        mine = torch.stack(list(mine)) if isinstance(mine, Stacked) else mine
        close(mine, g, what="/".join(path))
        assert np.abs(np.asarray(g)).max() > 0, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype):
    jm, jp, model, params = models(dtype)
    toks = tokens(model.cfg.vocab_size)[:, :S]
    got = model.prefill(params, {"tokens": toks})
    want = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    assert got.shape == (B, model.cfg.vocab_size) and got.dtype == model.cfg.cdtype()
    close(got, np.asarray(want, np.float32), 1e-5 if dtype == "float32" else 2 * BF16_EPS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype):
    """8 decode_steps from an empty cache, slot by slot at other
    positions: the logits of each and the final cache (the float32 state,
    the token-shift rows) against JAX's; in float32 the last logits also
    against the port's prefill (the reference's test_decode_matches_prefill,
    rtol 1e-3 / atol 1e-4)."""
    jm, jp, model, params = models(dtype)
    toks = tokens(model.cfg.vocab_size, seed=1)
    rel = 1e-5 if dtype == "float32" else 2 * BF16_EPS
    cache, jcache = model.init_cache(B, S), jm.init_cache(B, S)
    jstep = jax.jit(jm.decode_step)
    for t in range(8):
        pos = np.asarray([t, t + 3], np.int32)
        logits, out = model.decode_step(params, cache, toks[:, t], pos)
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t]), jnp.asarray(pos))
        assert out is cache
        close(logits, np.asarray(jlogits, np.float32), rel, f"logits {t}")
    # the state is float32 in both dtypes, but in bf16 it sums bf16 k and v
    jc = kv_cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    for k in ("state", "x_time", "x_chan"):
        assert cache[k].dtype == jc[k].dtype
        close(cache[k], jc[k].float().numpy(), rel, k)
    if dtype == "float32":
        want = model.prefill(params, {"tokens": toks[:, :8]})
        np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-3, atol=1e-4)
        assert torch.equal(logits.argmax(-1), want.argmax(-1))


# -------------------------------------------------------------- serving -----
FIRST, SECOND = [9, 8, 7, 6, 5], [5, 6]


def served(engine_cls, request_cls, model, params, prompts, max_new=8):
    eng = engine_cls(model, batch_slots=1, max_seq=32)
    for r, prompt in enumerate(prompts):
        eng.submit(request_cls(rid=r, prompt=list(prompt), max_new_tokens=max_new))
    return {req.rid: req.generated for req in eng.run(params)}


def test_refilled_slot_serves_jax_tokens_alone():
    """Repair 1: one slot, [9, 8, 7, 6, 5] first, then [5, 6] refills the
    slot: the port's tokens for [5, 6] equal the JAX engine's for [5, 6]
    served alone (float32).  The JAX engine's refilled slot carries the
    first request's state over and serves other tokens (the reference's
    defect, ROADMAP.md §3)."""
    jm, jp, model, params = models()
    alone = served(JServeEngine, JRequest, jm, jp, [SECOND])[0]
    got = served(ServeEngine, Request, model, params, [FIRST, SECOND])
    assert got[1] == alone and len(alone) == 8
    assert served(ServeEngine, Request, model, params, [SECOND])[0] == alone
    assert served(JServeEngine, JRequest, jm, jp, [FIRST, SECOND])[1] != alone


# --------------------------------------------------------- entry points -----
def test_entry_points_on_cpu(tmp_path, capsys):
    log = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
                             "--seq", "16", "--device", "cpu", "--ckpt_dir", str(tmp_path)])
    assert [m["step"] for m in log] == [2] and np.isfinite(log[0]["loss_mean"])
    assert (tmp_path / "step_0000000002" / "manifest.json").exists()
    done = launch_serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                              "--max_new", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    done = serve_lm.main(["--device", "cpu", "--arch", ARCH, "--requests", "3", "--max_new", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    out = capsys.readouterr().out
    assert "step 2 loss" in out and "served 3 requests (12 tokens)" in out \
        and "3 requests, 12 tokens" in out
