"""The port's hybrid family (``repro_torch.models.ssm``, the hybrid stack of
``repro_torch.models.transformer``, the ``hybrid`` family of
``build_model``, its checkpoints, optimizer state, serving and entry
points) against the JAX package on the CPU, on the reduced zamba2_2p7b (4
Mamba-2 layers, d_model 64, d_inner 128, 8 heads of 16, state 8, conv 4,
chunk 16; the shared block of 2 heads of 32 after layers 0 and 2).

The parameters are drawn once by the port's own init, then the leaves the
init leaves constant (``dt_bias``, ``a_log``, ``d_skip`` and the norm
scales) are redrawn, so that every term is exercised.  They cross as the
reference's numpy tree: into JAX as arrays in the dtypes of its own init
(``dt_bias``, ``a_log``, ``d_skip`` float32), into the port through
``convert.lm_params_from_numpy``.  Inputs are numpy draws from a seed.
Tolerances, relative to the scale (largest magnitude) of the compared
quantity: float32 to ``1e-5`` (the two frameworks sum in other orders);
a bf16 block to two bf16 epsilons (2 x 2^-7), the tolerance of
``test_torch_lm.py``; the SSD scan against float64 autograd of the
sequential recurrence to ``1e-4`` (the float32 gradient of ``a_log`` sums
every step's terms: measured 1.3e-5 of its scale), the limit of
``chip_smoke.py``'s phase 21 (d).

bf16 through the whole model is held to the reference's own bf16 error
instead.  XLA on the CPU keeps fused bf16 chains in excess precision (its
default ``xla_allow_excess_precision``) where the port rounds every op,
and the reduced model amplifies the difference layer by layer (measured:
the hidden states of one, two, three and four layers part by 1.0%, 1.8%,
3.3% and 5.5% of their scale): both frameworks' bf16 logits land ~5% of
the scale from the float32 logits, the port's up to 1.7x as far as the
reference's.  So a bf16 logits or cache leaf of the port must lie within
twice the reference's bf16 distance from the reference's float32 value.
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
from repro.models import ssm as jssm  # noqa: E402
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
    adamw_state_from_numpy, kv_cache_from_numpy, lm_params_from_numpy, lm_params_to_numpy,
)
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.models.model import DecoderLM, build_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.step import make_train_step, opt_config_for  # noqa: E402
from repro_torch.tree import Stacked, tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402
from repro_torch.tree import tree_unflatten_like  # noqa: E402

ARCH = "zamba2_2p7b"
BF16_EPS = 2.0**-7
B, S = 2, 16
J_CONV = jax.jit(jssm._causal_conv)
J_SSD = jax.jit(jssm._ssd_chunked, static_argnums=5)
J_MAMBA = jax.jit(jssm.mamba_block, static_argnums=2)
J_HYBRID = jax.jit(jtransformer.hybrid_forward, static_argnums=3)


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
    m = tree["layers"]["mamba"]
    m["dt_bias"] = rng.uniform(-2.0, 0.5, m["dt_bias"].shape).astype(np.float32)
    m["a_log"] = rng.uniform(-1.0, 1.0, m["a_log"].shape).astype(np.float32)
    m["d_skip"] = rng.normal(1.0, 0.5, m["d_skip"].shape).astype(np.float32)
    m["norm"] = rng.normal(0.0, 0.1, m["norm"].shape).astype(np.float32)
    for k in ("ln1", "ln2"):
        sh = tree["layers"]["shared"][k]
        tree["layers"]["shared"][k] = rng.normal(0.0, 0.1, sh.shape).astype(np.float32)
    return tree


def jax_params(jcfg):
    want = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a, w: jnp.asarray(a, w.dtype), numpy_params(), want)


@functools.lru_cache(maxsize=None)
def models(dtype: str = "float32", **kw):
    """(JAX model, JAX params, port model, port params) in compute dtype
    ``dtype``."""
    jcfg, cfg = reduced(compute_dtype=dtype, **kw)
    jp = jax_params(jcfg)
    return jbuild_model(jcfg), jp, build_model(cfg, device="cpu"), port_params(cfg, jp)


def port_params(cfg, jp):
    return lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


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


def mamba0(jp):
    """Mamba layer 0 of the JAX stack (JAX arrays) and the port's copy."""
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mamba"])
    return jl, jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jl)


# ------------------------------------------------------- init, convert -----
def test_init_matches_reference_tree():
    """The port's init under a bf16 param_dtype: the reference's leaves
    (``layers/mamba`` stacked [L, ...], ``layers/shared`` one block; dt_bias,
    a_log, d_skip float32), its constants, seeded; and the full config's
    sizes."""
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
    for k in ("dt_bias", "a_log", "d_skip"):
        assert got[f"layers/mamba/{k}"][1] == "float32"
    assert got["layers/shared/attn/wq"] == ((cfg.d_model, cfg.n_heads * cfg.head_dim), "bfloat16")
    m = ours.layers.mamba[1]
    assert not m["a_log"].any() and not m["dt_bias"].any() and bool((m["d_skip"] == 1).all())
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(ours.parameters(), again.parameters()))
    full = configs.get_config(ARCH)
    assert param_count(full)[0] == 2_427_453_440      # the reference's approximate count
    assert transformer.n_shared_apps(full) == 9 and transformer.n_shared_apps(cfg) == 2
    shapes = jax.eval_shape(jbuild_model(jconfigs.get_config(ARCH)).init, jax.random.PRNGKey(0))
    assert sum(x.size for x in jax.tree.leaves(shapes)) == 2_422_220_960


def test_convert_round_trip_and_caches():
    """A bf16 param_dtype: dt_bias, a_log and d_skip cross in float32, the
    rest bit for bit, back in the reference's {"mamba": stacked, "shared":
    one block} tree; the recurrent and shared caches cross in their
    dtypes, ``shared`` as () without a shared block."""
    jcfg, cfg = reduced(param_dtype="bfloat16")
    jp = jax_params(jcfg)
    params = port_params(cfg, jp)
    m = params.layers.mamba[2]
    assert m["a_log"].dtype == m["d_skip"].dtype == m["dt_bias"].dtype == torch.float32
    assert m["in_proj"].dtype == params.layers.shared.attn["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(m["dt_bias"].numpy(),
                                  numpy_params()["layers"]["mamba"]["dt_bias"][2])
    for stacked in (True, False):
        back = lm_params_to_numpy(params, stacked=stacked)
        assert jax.tree.structure(back) == jax.tree.structure(jp)
        for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    with pytest.raises(ValueError, match="layers/mamba"):
        bad = jax.tree.map(np.asarray, jp)
        port_params(cfg, dict(bad, layers=dict(bad["layers"], mamba=[])))

    for stride in (2, 0):
        jcfg, cfg = reduced(compute_dtype="bfloat16",
                            ssm=dataclasses.replace(reduced()[1].ssm, shared_stride=stride))
        jcache = jax.tree.map(np.asarray, jbuild_model(jcfg).init_cache(B, 4))
        got = kv_cache_from_numpy(jcache, device="cpu")
        want = build_model(cfg, device="cpu").init_cache(B, 4)
        assert jax.tree.structure(jcache) == jax.tree.structure(
            tree_map(lambda t: np.zeros(1), want))
        for g, w, j in zip(tree_leaves(got), tree_leaves(want), jax.tree.leaves(jcache)):
            assert g.shape == w.shape == j.shape and g.dtype == w.dtype
        assert want["ssm"]["state"].dtype == torch.float32
        assert want["ssm"]["conv"].dtype == torch.bfloat16
        if stride:
            assert want["shared"]["k"].shape == (2, B, 4, cfg.n_kv_heads, cfg.head_dim)
        else:
            assert want["shared"] == () == got["shared"]


# ---------------------------------------------------------- conv, SSD -----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seeded", [False, True])
def test_causal_conv_matches_jax(seeded, dtype):
    """Without and with a conv_state: the output and the new state; in bf16
    bit for bit (the W shifted products summed in the reference's order)."""
    rng = np.random.default_rng(1)
    xs, w, st = rand(rng, B, 9, 12), rand(rng, 4, 12), rand(rng, B, 3, 12)
    dt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    state = torch.tensor(st).to(dt) if seeded else None
    out, new = ssm._causal_conv(torch.tensor(xs).to(dt), torch.tensor(w).to(dt), state)
    jout, jnew = J_CONV(jnp.asarray(xs, jdt), jnp.asarray(w, jdt),
                        jnp.asarray(st, jdt) if seeded else None)
    assert out.dtype == dt
    if dtype == "bfloat16":
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(jout, np.float32))
    close(out, np.asarray(jout, np.float32), what="out")
    np.testing.assert_array_equal(new.float().numpy(), np.asarray(jnew, np.float32))


def ssd_inputs(seed: int, t: int = 77, h: int = 3, p: int = 8, n: int = 5, dt=None):
    rng = np.random.default_rng(seed)
    return dict(xh=rand(rng, 2, t, h, p), bt=rand(rng, 2, t, n), ct=rand(rng, 2, t, n),
                dt=(rng.uniform(0.05, 1.0, (2, t, h)) if dt is None
                    else np.full((2, t, h), dt)).astype(np.float32),
                a_log=rng.uniform(-1.0, 1.0, (h,)).astype(np.float32))


def test_ssd_chunked_matches_jax():
    """T = 77 in chunks of 16 (the last one short), from a zero state: y
    and the final state against the reference's."""
    x = ssd_inputs(2)
    y, state = ssm._ssd_chunked(**{k: torch.tensor(v) for k, v in x.items()}, chunk=16)
    jy, jstate = J_SSD(*(jnp.asarray(v) for v in x.values()), 16)
    assert y.dtype == state.dtype == torch.float32
    close(y, jy, what="y")
    close(state, jstate, what="state")


def ssd_sequential64(xh, bt, ct, dt, a_log):
    """The recurrence step by step in float64 (autograd-able): S_t =
    exp(dt_t A) S_{t-1} + dt_t B_t (x) x_t, y_t = C_t . S_t."""
    a = -torch.exp(a_log)
    s = torch.zeros(xh.shape[0], xh.shape[2], bt.shape[-1], xh.shape[3], dtype=torch.float64)
    ys = []
    for t in range(xh.shape[1]):
        s = torch.exp(dt[:, t] * a)[:, :, None, None] * s \
            + dt[:, t, :, None, None] * bt[:, t, None, :, None] * xh[:, t, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", ct[:, t], s))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("dt", [0.5, 0.8])
def test_ssd_gradient_finite_at_published_chunk(dt):
    """Repair 2, at zamba2's chunk of 128, T 256, a_log 0 (A = -1), a
    constant dt: the reference's masked exponent above the diagonal passes
    88.7 at dt 0.8 (127 x 0.8 = 101.6) and its gradient is NaN; the port's
    forward equals the reference's to 1e-5 at both dts, and its gradient of
    sum(y) (to x, B, C, dt, a_log) is finite and within 1e-5 of float64
    autograd through the sequential recurrence (and of the reference's,
    where that is finite)."""
    x = ssd_inputs(3, t=256, h=2, p=4, n=4, dt=dt)
    x["a_log"] = np.zeros_like(x["a_log"])
    jin = [jnp.asarray(v) for v in x.values()]
    jy, _ = J_SSD(*jin, 128)
    jgrads = jax.jit(jax.grad(lambda *a: jssm._ssd_chunked(*a, 128)[0].sum(),
                              argnums=(0, 1, 2, 3, 4)))(*jin)
    finite = all(bool(jnp.isfinite(g).all()) for g in jgrads)
    assert finite == (dt == 0.5)

    ins = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    y, _ = ssm._ssd_chunked(**ins, chunk=128)
    close(y, jy, what="forward")
    grads = torch.autograd.grad(y.sum(), list(ins.values()))
    ins64 = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True) for k, v in x.items()}
    y64 = ssd_sequential64(**ins64)
    close(y, y64.detach().numpy(), what="forward vs float64 recurrence")
    grads64 = torch.autograd.grad(y64.sum(), list(ins64.values()))
    for name, g, g64, jg in zip(x, grads, grads64, jgrads):
        assert torch.isfinite(g).all(), name
        close(g, g64.numpy(), 1e-4, f"d{name} vs float64")
        if finite:
            close(g, jg, what=f"d{name} vs reference")


# ---------------------------------------------------------------- block -----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decode", [False, True])
def test_mamba_block_matches_jax(decode, dtype):
    """Prefill (T = 20, no cache: the chunked scan) and decode (T = 1 from
    a random state and conv rows), the parameters and x in ``dtype`` (the
    state float32): the output and the new cache against the reference's;
    the cache written in place; the conv rows the in_proj's x half."""
    jm, jp, model, _ = models()
    cfg = dataclasses.replace(model.cfg, compute_dtype=dtype)
    jl, pl = mamba0(jp)
    dt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    pl = tree_map(lambda t: t.to(dt), pl)
    jl = jax.tree.map(lambda a: a.astype(jdt), jl)
    rel = 1e-5 if dtype == "float32" else 2 * BF16_EPS
    rng = np.random.default_rng(4)
    x = rand(rng, B, 1 if decode else 20, cfg.d_model)
    if not decode:
        out, cache = ssm.mamba_block(pl, torch.tensor(x).to(dt), cfg)
        jout, _ = J_MAMBA(jl, jnp.asarray(x, jdt), jm.cfg)
        assert cache is None and out.dtype == dt
        close(out, np.asarray(jout, np.float32), rel, "out")
        return
    empty = ssm.init_ssm_cache(cfg, B, dt)
    c = {k: rand(rng, *v.shape) for k, v in empty.items()}
    cache = {k: torch.tensor(v).to(empty[k].dtype) for k, v in c.items()}
    views = dict(cache)
    out, new = ssm.mamba_block(pl, torch.tensor(x).to(dt), cfg, cache=cache)
    jout, jnew = J_MAMBA(jl, jnp.asarray(x, jdt), jm.cfg,
                         cache={k: jnp.asarray(v, empty[k].dtype == torch.float32 and jnp.float32
                                               or jdt) for k, v in c.items()})
    close(out, np.asarray(jout, np.float32), rel, "out")
    assert new["state"].dtype == torch.float32 and new["conv"].dtype == dt
    for k in c:
        close(new[k], np.asarray(jnew[k], np.float32), rel, k)
        assert new[k] is views[k]
    np.testing.assert_array_equal(new["conv"][:, -1].float().numpy(),
                                  (torch.tensor(x).to(dt)[:, 0] @ pl["in_proj"])
                                  [:, :2 * cfg.d_model].float().numpy())


@pytest.mark.parametrize("decode", [False, True])
def test_hybrid_forward_matches_jax(decode, monkeypatch):
    """The whole stack: the shared block runs after layers 0 and 2 (two
    applications of one parameter set), reading and writing its own KV
    cache each; the hidden states and (decode) every cache leaf against the
    reference's."""
    jm, jp, model, params = models()
    cfg = model.cfg
    apps = []
    real = transformer.block_forward
    monkeypatch.setattr(transformer, "block_forward",
                        lambda p, x, *a, **kw: apps.append(kw.get("cache")) or real(p, x, *a, **kw))
    tree = params.tree()
    rng = np.random.default_rng(5)
    if not decode:
        x = rand(rng, B, 20, cfg.d_model)
        out, _ = transformer.hybrid_forward(tree["layers"], torch.tensor(x), torch.arange(20), cfg)
        jout, _ = J_HYBRID(jp["layers"], jnp.asarray(x), jnp.arange(20), jm.cfg)
        close(out, jout, what="hidden")
        assert len(apps) == transformer.n_shared_apps(cfg) == 2
        return
    pos = np.asarray([3, 6], np.int32)
    jcache = jax.tree.map(lambda a: jnp.asarray(rand(rng, *a.shape)), jm.init_cache(B, 8))
    cache = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jcache)
    x = rand(rng, B, 1, cfg.d_model)
    out, new = transformer.hybrid_forward(tree["layers"], torch.tensor(x),
                                          torch.tensor(pos)[:, None], cfg, cache=cache,
                                          cache_pos=torch.tensor(pos))
    jout, jnew = J_HYBRID(jp["layers"], jnp.asarray(x), jnp.asarray(pos)[:, None], jm.cfg,
                          cache=jcache, cache_pos=jnp.asarray(pos))
    close(out, jout, what="hidden")
    assert new is cache and len(apps) == 2
    assert all(a["k"].data_ptr() == cache["shared"]["k"][i].data_ptr() for i, a in enumerate(apps))
    for part in ("ssm", "shared"):
        for k in new[part]:
            close(new[part][k], jnew[part][k], what=f"{part}/{k}")


# ---------------------------------------------------------------- model -----
def tokens(vocab: int, batch: int = B, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (batch, S + 1)).astype(np.int32)


def test_loss_fn_and_gradients_match_jax():
    """float32: the loss and every parameter's gradient (the shared
    block's, summed over its two applications, among them) to 1e-5 of
    JAX's, under the per-layer remat."""
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
    assert set(metrics) == set(jmetrics) == {"lm_loss", "loss"}
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = dict(tree_leaves_with_path(grads, lambda x: isinstance(x, Stacked)))
    want = {tuple(str(k.key) for k in p): g for p, g in jax.tree_util.tree_leaves_with_path(jgrads)}
    assert set(got) == set(want)
    for path, g in want.items():
        mine = got[path]
        mine = torch.stack(list(mine)) if isinstance(mine, Stacked) else mine
        close(mine, g, what="/".join(path))
        assert np.abs(np.asarray(g)).max() > 0, path


def assert_like_jax(got, want, want32, dtype: str, what: str) -> None:
    """float32: to 1e-5 of JAX's.  bf16: within twice JAX's own bf16
    distance from JAX's float32 value (module docstring)."""
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        close(got, want, 1e-5, what)
        return
    want32 = np.asarray(want32, np.float32)
    err = float(np.abs(got.float().numpy() - want32).max())
    assert err <= 2 * float(np.abs(want - want32).max()), (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """prefill's logits, then 8 decode_steps (slots at other positions):
    the logits of each and the final cache (the float32 state, the conv
    rows, the shared block's K/V) against JAX's; in float32 decode also
    against the port's prefill (rtol 1e-3 / atol 1e-4, as the reference's
    test_decode_matches_prefill)."""
    jm, jp, model, params = models(dtype)
    jm32, jp32 = models()[:2]
    toks = tokens(model.cfg.vocab_size, seed=1)
    batch = {"tokens": jnp.asarray(toks[:, :S])}
    got = model.prefill(params, {"tokens": toks[:, :S]})
    assert got.shape == (B, model.cfg.vocab_size) and got.dtype == model.cfg.cdtype()
    assert_like_jax(got, jax.jit(jm.prefill)(jp, batch), jax.jit(jm32.prefill)(jp32, batch),
                    dtype, "prefill")
    cache, jcache, jcache32 = model.init_cache(B, S), jm.init_cache(B, S), jm32.init_cache(B, S)
    jstep, jstep32 = jax.jit(jm.decode_step), jax.jit(jm32.decode_step)
    for t in range(8):
        pos = np.asarray([t, t + 3], np.int32)
        logits, out = model.decode_step(params, cache, toks[:, t], pos)
        args = (jnp.asarray(toks[:, t]), jnp.asarray(pos))
        jlogits, jcache = jstep(jp, jcache, *args)
        jlogits32, jcache32 = jstep32(jp32, jcache32, *args)
        assert out is cache
        assert_like_jax(logits, jlogits, jlogits32, dtype, f"logits {t}")
    jc = kv_cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    for part in ("ssm", "shared"):
        for k in cache[part]:
            assert cache[part][k].dtype == jc[part][k].dtype
            assert_like_jax(cache[part][k], jc[part][k].float().numpy(),
                            np.asarray(jcache32[part][k]), dtype, f"{part}/{k}")
    if dtype == "float32":
        cache = model.init_cache(B, S)
        for t in range(8):
            logits, cache = model.decode_step(params, cache, toks[:, t], np.full(B, t))
        want = model.prefill(params, {"tokens": toks[:, :8]})
        np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-3, atol=1e-4)
        assert torch.equal(logits.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------- checkpoints -----
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


def test_checkpoints_and_adamw_state_cross_packages(tmp_path):
    """bf16 factored moments (the [L, H] dt_bias and the shared block's
    norms factored as the reference factors them): JAX's (params,
    AdamWState) after one step restores in the port leaf for leaf and bit
    for bit, and adamw_state_from_numpy reads the same state; after one
    more step on the port, the reference restores the port's checkpoint bit
    for bit, with the same file names and treedef."""
    jcfg, cfg = reduced(compute_dtype="float32", optimizer_dtype="bfloat16",
                        optimizer_factored=True)
    jp = jax_params(jcfg)
    jopt = joptimizer.AdamWConfig(moment_dtype="bfloat16", factored=True)
    toks = tokens(cfg.vocab_size, seed=3)
    jp, jstate, _ = jax.jit(jmake_train_step(jbuild_model(jcfg), jopt))(
        jp, joptimizer.init_adamw(jp, jopt), {"tokens": jnp.asarray(toks)})
    JaxManager(tmp_path / "jax").save(1, (jp, jstate), blocking=True)
    model, opt = build_model(cfg, device="cpu"), opt_config_for(cfg)
    fresh = model.init(torch.Generator().manual_seed(0))
    (params, state), step = CheckpointManager(tmp_path / "jax").restore(
        (fresh, optimizer.init_adamw(fresh, opt)))
    assert step == 1 and params.layers.mamba[0]["a_log"].dtype == torch.float32
    want = [bits(x) for x in jax.tree.leaves((jp, jstate))]
    got = port_bits(params, state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    state_np = adamw_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    assert set(state_np.v["layers"]) == {"mamba", "shared"}
    assert state_np.v["layers"]["mamba"]["in_proj"]["row"].shape == \
        (cfg.n_layers, cfg.d_model)
    for g, w in zip(tree_leaves((state_np.m, state_np.v)), tree_leaves((state.m, state.v))):
        np.testing.assert_array_equal(bits(g), bits(w))
    with pytest.raises(ValueError, match="layers/mamba"):
        m = jax.tree.map(np.asarray, jstate.m)
        listed = dict(m, layers=dict(m["layers"], mamba=[m["layers"]["mamba"]]))
        adamw_state_from_numpy(cfg, (1, listed, jax.tree.map(np.asarray, jstate.v)),
                               device="cpu")

    params, state, _ = make_train_step(model, opt)(params, state,
                                                   {"tokens": tokens(cfg.vocab_size, seed=4)})
    CheckpointManager(tmp_path / "port").save(2, (params, state), blocking=True)
    (jr, jrs), jstep = JaxManager(tmp_path / "port").restore((jp, jstate))
    assert jstep == 2 and int(jrs.step) == 2
    for g, w in zip([bits(x) for x in jax.tree.leaves((jr, jrs))], port_bits(params, state)):
        np.testing.assert_array_equal(g, w)
    a, b = tmp_path / "jax" / "step_0000000001", tmp_path / "port" / "step_0000000002"
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma["treedef"] == mb["treedef"] and ma["leaves"] == mb["leaves"]
    assert {"name": "0__layers__mamba__a_log", "shape": [cfg.n_layers, 8],
            "dtype": "float32"} in mb["leaves"]
    assert {"name": "0__layers__shared__attn__wq", "shape": [cfg.d_model, 64],
            "dtype": "float32"} in mb["leaves"]


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
    first request's Mamba state and conv rows over and serves other tokens
    (the reference's defect, ROADMAP.md §3)."""
    jm, jp, model, params = models()
    alone = served(JServeEngine, JRequest, jm, jp, [SECOND])[0]
    got = served(ServeEngine, Request, model, params, [FIRST, SECOND])
    assert got[1] == alone and len(alone) == 8
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


# ------------------------------------------------------------ the depth -----
@pytest.mark.parametrize("depth", [8, 24])
def test_deep_stack_collapses_as_the_reference(depth):
    """The reference's hybrid stack has no residual around a Mamba block,
    and its init scales out_proj by 1 / sqrt(2 L): past ~11 layers the
    hidden state is exactly 0, in the reference and in the port alike, so
    at 24 layers (the shared block after every 6th: 4 applications) every
    logit of the published init is 0 in both.  At 8 layers (2
    applications; the depth chip_smoke.py's phase 21 (a) checks besides
    the full 54) the logits live, and the port's prefill and 6
    decode_steps give JAX's to 1e-4 (float32): the hidden state shrinks
    ~10x a layer and the final norm scales it back up, rounding with it
    (measured: 1.6e-5 of the scale)."""
    jcfg, cfg = reduced(n_layers=depth, compute_dtype="float32",
                        ssm=dataclasses.replace(reduced()[1].ssm, shared_stride=6))
    tree = lm_params_to_numpy(build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)))
    jm, model = jbuild_model(jcfg), build_model(cfg, device="cpu")
    jp, params = jax.tree.map(jnp.asarray, tree), port_params(cfg, tree)
    toks = tokens(cfg.vocab_size, seed=2)
    got = model.prefill(params, {"tokens": toks[:, :S]})
    want = np.asarray(jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :S])}))
    if depth == 24:
        assert not got.any() and not want.any()
        return
    assert np.abs(want).max() > 1.0
    close(got, want, 1e-4, f"prefill at {depth} layers")
    cache, jcache = model.init_cache(B, S), jm.init_cache(B, S)
    jstep = jax.jit(jm.decode_step)
    for i in range(6):
        pos = np.full(B, i, np.int32)
        logits, cache = model.decode_step(params, cache, toks[:, i], pos)
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(toks[:, i]), jnp.asarray(pos))
        close(logits, jlogits, 1e-4, f"decode {i} at {depth} layers")
