"""The port's LM substrate (``repro_torch.{configs,models,data.pipeline}``,
``convert.lm_params_from_numpy``) against the JAX package on the CPU.

Every comparison carries JAX's parameters across (``model.init(PRNGKey(0))``
through ``lm_params_from_numpy``): the port cannot reproduce JAX's draws.
Tolerances: float32 paths agree to ``1e-5`` of the logits' scale (the two
frameworks sum in other orders); bfloat16 paths to two bf16 epsilons
(2 x 2^-7) of it: both cast at the same places, but bf16 rounds there by
other routes (e.g. XLA's silu rounds twice, PyTorch's once), so single
logits land one bf16 ulp apart.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import param_count  # noqa: E402
from repro_torch.convert import kv_cache_from_numpy, lm_params_from_numpy  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models.model import DecoderLM, build_model  # noqa: E402

DENSE = ["deepseek_7b", "phi4_mini_3p8b", "minitron_8b"]
BF16_EPS = 2.0**-7
B, S = 2, 16


def assert_logits(got: torch.Tensor, want, dtype: str) -> None:
    """got (port) against want (JAX) within the module's stated tolerance."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    tol = 1e-5 * scale if dtype == "float32" else 2 * BF16_EPS * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@functools.lru_cache(maxsize=None)
def jax_model(arch: str, dtype: str):
    """(JAX cfg, JAX model, JAX params, port cfg, port model, port params)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch), compute_dtype=dtype)
    cfg = dataclasses.replace(configs.get_reduced_config(arch), compute_dtype=dtype)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, cfg, build_model(cfg, device="cpu"), params


def rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------- configs -----
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_count_equals_reference(arch):
    assert param_count(configs.get_config(arch)) == jconfigs.param_count(jconfigs.get_config(arch))
    assert param_count(configs.get_reduced_config(arch)) == \
        jconfigs.param_count(jconfigs.get_reduced_config(arch))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_reference_as_data(arch):
    for ours, ref in ((configs.get_config(arch), jconfigs.get_config(arch)),
                      (configs.get_reduced_config(arch), jconfigs.get_reduced_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.resolved_head_dim == ref.resolved_head_dim
        assert ours.pdtype() == getattr(torch, str(ref.pdtype()))
        assert ours.cdtype() == getattr(torch, str(ref.cdtype()))


def test_registry_and_shapes():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS and configs.ALIASES == jconfigs.ALIASES
    assert configs.get_config("deepseek-7b") is configs.get_config("deepseek_7b")
    assert configs.SHAPES == {k: configs.ShapeConfig(**dataclasses.asdict(v))
                              for k, v in jconfigs.SHAPES.items()}
    assert set(configs.all_configs()) == set(configs.ARCH_IDS)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt5")
    bad = dataclasses.replace(configs.get_reduced_config("deepseek_7b"), compute_dtype="Tensor")
    with pytest.raises(ValueError, match="not a torch dtype"):
        bad.cdtype()


def test_deepseek_7b_full_width():
    cfg = configs.get_config("deepseek_7b")
    total, active = param_count(cfg)
    assert total == active == 6_910_115_840            # without the norms' 61 x 4 096
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings) == \
        (30, 4096, 32, 32, 128, 11008, 102400, False)
    # bf16 KV cache a token: 2 (k, v) x L x Hkv x dh x 2 bytes
    assert 2 * cfg.n_layers * cfg.n_kv_heads * cfg.resolved_head_dim * 2 == 491_520


# ------------------------------------------------------------ pipeline -----
@pytest.mark.parametrize("step", [0, 3, 2**31 + 5])
def test_token_pipeline_bit_equal(step):
    ours, ref = pipeline.TokenPipeline(100, 4, 8, seed=1), jpipeline.TokenPipeline(100, 4, 8, seed=1)
    np.testing.assert_array_equal(ours.batch(step)["tokens"], ref.batch(step)["tokens"])
    assert ours.batch(step)["tokens"].dtype == np.int32
    kw = dict(vocab_size=50, global_batch=2, seq_len=6, seed=4, frontend_key="patches",
              frontend_shape=(3, 5))
    fo, fr = pipeline.FrontendPipeline(**kw).batch(step), jpipeline.FrontendPipeline(**kw).batch(step)
    assert fo.keys() == fr.keys()
    for k in fo:
        np.testing.assert_array_equal(fo[k], fr[k])


# -------------------------------------------------------------- layers -----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x, scale = rand(rng, 3, 5, 64), rand(rng, 64)
    got = layers.rms_norm(torch.tensor(x).to(getattr(torch, dtype)), torch.tensor(scale), 1e-5)
    want = jlayers.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    assert_logits(got, want, dtype)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_apply_rope(kind):
    rng = np.random.default_rng(1)
    x = rand(rng, 2, 7 if kind == "prefill" else 1, 3, 16)
    pos = np.arange(7) if kind == "prefill" else np.array([[3], [40]])   # [S] or [B, 1]
    got = layers.apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layers.rope_frequencies(16, 5e5).numpy(),
                               np.asarray(jlayers.rope_frequencies(16, 5e5)), rtol=1e-6)


@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_repeat_kv(n_rep):
    k = rand(np.random.default_rng(2), 2, 5, 3, 8)
    got = layers._repeat_kv(torch.tensor(k), n_rep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlayers._repeat_kv(jnp.asarray(k), n_rep)))
    # query head j reads kv head j // n_rep
    np.testing.assert_array_equal(got.numpy(), np.repeat(k, n_rep, axis=2))


@pytest.mark.parametrize("case", ["causal", "causal_offset", "mask", "gqa_mask"])
def test_attention(case):
    rng = np.random.default_rng(3)
    hkv = 2 if case == "gqa_mask" else 4
    q, k, v = rand(rng, 2, 5, 4, 8), rand(rng, 2, 9, hkv, 8), rand(rng, 2, 9, hkv, 8)
    kw = {}
    if case == "causal":
        kw = dict(causal=True)
    elif case == "causal_offset":
        # the reference's q_offset = 4 is the port's mask kpos <= qpos + 4
        got = layers.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=False,
                               mask=torch.arange(9)[None, :] <= torch.arange(5)[:, None] + 4)
        want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                 q_offset=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        return
    else:
        kw = dict(causal=False)
        kw["mask"] = rng.random((2, 1, 1, 9)) < 0.7
        kw["mask"][..., 0] = True
    got = layers.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           **{a: (torch.tensor(b) if a == "mask" else b) for a, b in kw.items()})
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **{a: (jnp.asarray(b) if a == "mask" else b) for a, b in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s", [20, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 2])
def test_chunked_attention(s, causal, hkv):
    """chunk = 8: S = 20 takes three chunks, the last ragged; S = 16 two."""
    rng = np.random.default_rng(4)
    q, k, v = rand(rng, 2, s, 4, 8), rand(rng, 2, s, hkv, 8), rand(rng, 2, s, hkv, 8)
    got, lse = layers._fa_forward(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal, 8)
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, chunk=8)
    _, want_lse = jlayers._fa_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 8, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=1e-6)
    # and the chunked core equals the plain one
    plain = layers.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal)
    np.testing.assert_allclose(
        layers.chunked_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                 causal=causal, chunk=8).numpy(),
        plain.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pos", [[0, 3], [5, 7], [9, 2]])
def test_attention_block_decode_writes_the_cache(pos):
    """One decode token per slot into a capacity-8 cache: the row written
    at min(pos, 7) (pos 9 overflows), the mask kpos <= pos, the output."""
    cfg = dataclasses.replace(configs.get_reduced_config("minitron_8b"), compute_dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_reduced_config("minitron_8b"), compute_dtype="float32")
    rng = np.random.default_rng(5)
    jp = jattention.init_attention(jax.random.PRNGKey(1), jcfg, jnp.float32)
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = rand(rng, 2, 1, cfg.d_model)
    kv = {k: rand(rng, 2, 8, cfg.n_kv_heads, cfg.resolved_head_dim) for k in ("k", "v")}
    cache = attention.init_kv_cache(cfg, 2, 8, torch.float32)
    assert cache["k"].shape == (2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {k: torch.tensor(v) for k, v in kv.items()}
    pos = np.asarray(pos, np.int32)
    out, new = attention.attention_block(p, torch.tensor(x), torch.tensor(pos)[:, None], cfg,
                                         cache=cache, cache_pos=torch.tensor(pos))
    jout, jnew = jattention.attention_block(jp, jnp.asarray(x), jnp.asarray(pos)[:, None], jcfg,
                                            cache={k: jnp.asarray(v) for k, v in kv.items()},
                                            cache_pos=jnp.asarray(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]), rtol=1e-5, atol=1e-6)
    assert new["k"] is cache["k"]                     # written in place


# --------------------------------------------------------------- model -----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, dtype):
    jcfg, jm, jp, cfg, model, params = jax_model(arch, dtype)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    got = model.prefill(params, {"tokens": toks})
    assert got.shape == (B, cfg.vocab_size) and got.dtype == cfg.cdtype()
    assert_logits(got, jm.prefill(jp, {"tokens": jnp.asarray(toks)}), dtype)

    cache, jcache = model.init_cache(B, S), jm.init_cache(B, S)
    jstep = jax.jit(jm.decode_step)
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        logits, cache = model.decode_step(params, cache, toks[:, t], pos)
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t]), jnp.asarray(pos))
        assert_logits(logits, jlogits, dtype)
    jc = kv_cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    for k in ("k", "v"):
        assert cache[k].dtype == jc[k].dtype == cfg.cdtype()
        assert_logits(cache[k], jc[k].float().numpy(), dtype)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_prefill(arch):
    """Greedy next-token from (prefill over S tokens) == (S decode steps),
    the reference's test_models_smoke.py check on the port, in float32."""
    _, _, _, cfg, model, params = jax_model(arch, "float32")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(7))
    want = model.prefill(params, {"tokens": tokens})
    cache = model.init_cache(B, S)
    for t in range(S):
        logits, cache = model.decode_step(params, cache, tokens[:, t], torch.full((B,), t))
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-3, atol=1e-4)
    assert torch.equal(logits.argmax(-1), want.argmax(-1))


def test_build_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(configs.get_reduced_config("deepseek_7b"))


# ------------------------------------------------------- init, convert -----
@pytest.mark.parametrize("arch", DENSE)
def test_init_matches_reference_shapes_and_scales(arch):
    jcfg, _, jp, cfg, model, _ = jax_model(arch, "bfloat16")
    ours = model.init(torch.Generator().manual_seed(0))
    assert isinstance(ours, DecoderLM)
    flat = dict(ours.named_parameters())
    want = jax.tree_util.tree_leaves_with_path(jp)
    ref_shapes = {}
    for path, leaf in want:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        ref_shapes[name] = leaf.shape
    # the reference stacks layers: [L, ...]; the port keeps a list
    got_shapes = {}
    for name, p in flat.items():
        assert p.dtype == cfg.pdtype()
        parts = name.split(".")
        if parts[0] == "layers":
            key = ".".join(["layers"] + parts[2:])
            got_shapes[key] = (cfg.n_layers, *p.shape)
        else:
            got_shapes[{"embedding": "embed.embedding"}.get(name, name)] = tuple(p.shape)
    assert got_shapes == {k: tuple(v) for k, v in ref_shapes.items()}
    assert ("unembed" in got_shapes) == (not cfg.tie_embeddings)
    # param_count leaves out the 2L + 1 norm scales
    assert sum(p.numel() for p in ours.parameters()) == \
        param_count(cfg)[0] + (2 * cfg.n_layers + 1) * cfg.d_model
    # truncated at 2 standard deviations, no correction: std = 0.8796 x nominal
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    w = torch.cat([layer.mlp["w1"].flatten() for layer in ours.layers])
    assert w.abs().max() <= 2 * d**-0.5 + 1e-6
    assert abs(float(w.std()) / (0.8796 * d**-0.5) - 1) < 0.05
    wo = torch.cat([layer.attn["wo"].flatten() for layer in ours.layers])
    hd = cfg.n_heads * cfg.resolved_head_dim
    assert wo.abs().max() <= 2 * hd**-0.5 / (2 * L) ** 0.5 + 1e-6
    w2 = torch.cat([layer.mlp["w2"].flatten() for layer in ours.layers])
    assert w2.abs().max() <= 2 * ff**-0.5 / (2 * L) ** 0.5 + 1e-6
    assert ours.embedding.abs().max() <= 2.0
    assert all(not layer.ln1.any() and not layer.ln2.any() for layer in ours.layers)
    assert not ours.final_ln.any()
    # seeded: the same generator seed gives the same parameters
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(ours.parameters(), again.parameters()))


def test_convert_reads_both_layer_layouts_and_bf16():
    jcfg = dataclasses.replace(jconfigs.get_reduced_config("phi4_mini_3p8b"), scan_layers=False,
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_reduced_config("phi4_mini_3p8b"), scan_layers=False,
                              param_dtype="bfloat16")
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(3))
    assert isinstance(jp["layers"], list)
    listed = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    stacked_tree = dict(jp, layers=jax.tree.map(lambda *a: jnp.stack(a), *jp["layers"]))
    stacked = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, stacked_tree), device="cpu")
    for (na, a), (nb, b) in zip(listed.named_parameters(), stacked.named_parameters()):
        assert na == nb and a.dtype == torch.bfloat16 and torch.equal(a, b)
    # bf16 crosses bit for bit
    np.testing.assert_array_equal(
        listed.layers[1].attn["wq"].float().numpy(),
        np.asarray(jp["layers"][1]["attn"]["wq"], np.float32))
    assert listed.unembed is None                      # tied
    with pytest.raises(ValueError, match="layers"):
        lm_params_from_numpy(cfg, dict(jax.tree.map(np.asarray, jp), layers=[]), device="cpu")


def test_kv_cache_from_numpy_bf16_bits():
    cache = {k: np.asarray(jnp.asarray(np.random.default_rng(6).normal(size=(2, 1, 4, 2, 8)),
                                       jnp.bfloat16)) for k in ("k", "v")}
    got = kv_cache_from_numpy(cache, device="cpu")
    for k in ("k", "v"):
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].float().numpy(), cache[k].astype(np.float32))
