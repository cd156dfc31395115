"""The port's MoE family (``repro_torch.models.{mla,moe}``, the ``moe``
family of ``build_model``, its training, checkpoints, serving and entry
points) against the JAX package on the CPU, on the reduced
deepseek_v2_lite_16b (softmax router, full-rank q) and deepseek_v3_671b
(sigmoid_bias router with norm_topk_prob, q_lora_rank, MTP).

The parameters are drawn once by the port's own init and cross as the
reference's numpy tree: into JAX as arrays in the dtypes of its own init,
into the port through ``convert.lm_params_from_numpy``.  Tolerances,
relative to the scale (largest magnitude) of the compared quantity:

* routing and capacity selections: equal, index for index (both break
  ties by index, lower first);
* float32: outputs, logits, losses and gradients to ``1e-5`` (the two
  frameworks sum in other orders); post-step parameters and moments to
  ``1e-5`` (AdamW ``eps`` 1e-3, as in ``test_torch_train.py``);
* bfloat16 logits: two bf16 epsilons (2 x 2^-7), PR 23's tolerance of
  ``test_torch_lm.py``.  A bf16 hidden state lands an ulp apart between
  the frameworks, so where two router scores (or two gates at an expert's
  capacity) lie within that noise the two pick differently and the
  outputs part by far more than an ulp: a logits row beyond the tolerance
  must come with such a near tie in the port's own selections of that
  call (the k-th and the (k+1)-th value within two bf16 epsilons of the
  k-th), and most rows must hold to the tolerance.
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
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
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
from repro_torch.models import mla, moe  # noqa: E402
from repro_torch.models.model import DecoderLM, build_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.tree import Stacked, tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402

MOE = ["deepseek_v2_lite_16b", "deepseek_v3_671b"]
BF16_EPS = 2.0**-7
B, S = 2, 16
# the reference's functions, each compiled once (the configs are static)
J_ROUTE = jax.jit(jmoe._route, static_argnums=3)
J_GATE = jax.jit(jmoe._gate_matrix, static_argnums=3)
J_FFN = jax.jit(jmoe._routed_ffn_local, static_argnums=5)
J_MOE = jax.jit(jmoe.moe_block, static_argnums=2)
J_MLA = jax.jit(jmla.mla_block, static_argnums=3)


def reduced(arch: str, **kw):
    """(JAX cfg, port cfg) of the reduced arch with ``kw`` replaced; a
    ``capacity_factor`` goes into the MoE config."""
    cf = kw.pop("capacity_factor", None)
    out = []
    for cfg in (jconfigs.get_reduced_config(arch), configs.get_reduced_config(arch)):
        cfg = dataclasses.replace(cfg, **kw)
        if cf is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        out.append(cfg)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def numpy_params(arch: str) -> dict:
    """The published reduced arch's parameters, drawn by the port's own
    init (seed 0), as the reference's numpy tree (bf16 values in float32
    arrays).  Drawn once: JAX's init of a reduced MoE model compiles for
    seconds."""
    cfg = configs.get_reduced_config(arch)
    return lm_params_to_numpy(build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)))


def jax_params(jcfg):
    """``numpy_params`` as JAX arrays in ``jcfg``'s layout and in the
    dtypes of the reference's own init (``param_dtype``; the router
    float32)."""
    tree = dict(numpy_params(jcfg.name))
    if not jcfg.scan_layers:
        for name in ("dense_layers", "layers"):
            if name in tree:
                depth = jax.tree.leaves(tree[name])[0].shape[0]
                tree[name] = [jax.tree.map(lambda a, i=i: a[i], tree[name]) for i in range(depth)]
    want = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a, w: jnp.asarray(a, w.dtype), tree, want)


@functools.lru_cache(maxsize=None)
def models(arch: str, dtype: str = "float32", **kw):
    """(JAX model, JAX params, port model, port params) of the reduced arch
    in compute dtype ``dtype``."""
    jcfg, cfg = reduced(arch, compute_dtype=dtype, **kw)
    jp = jax_params(jcfg)
    return jbuild_model(jcfg), jp, build_model(cfg, device="cpu"), port_params(cfg, jp)


def port_params(cfg, jp):
    return lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def close(got, want, rel: float = 1e-5, what: str = "") -> None:
    """|got - want| <= rel x max|want|, elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float32) - want).max())
    assert err <= rel * scale, (what, err, scale)


def layer0(jp, name: str = "layers"):
    """Layer 0 of a stacked JAX stack in float32 (numpy) and the port's copy
    (tensors)."""
    jl = jax.tree.map(lambda a: np.asarray(a, np.float32)[0], jp[name])
    return jl, tree_map(torch.tensor, jl)


def rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------------- init, convert -----
@pytest.mark.parametrize("arch", MOE)
def test_init_matches_reference_tree(arch):
    """The port's own init: the reference's leaves (paths, shapes, dtypes:
    the router float32 whatever param_dtype is), param_count's total plus
    the norm scales, zero norms and router bias, seeded."""
    jm, _, model, _ = models(arch)
    cfg = model.cfg
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    ours = model.init(torch.Generator().manual_seed(0))
    assert isinstance(ours, DecoderLM)
    got = {"/".join(p): (tuple(x.shape), str((x[0] if isinstance(x, Stacked) else x).dtype)[6:])
           for p, x in tree_leaves_with_path(ours.reference_tree(),
                                             lambda x: isinstance(x, Stacked))}
    want = {"/".join(str(getattr(k, "key", k)) for k in p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(jp)}
    assert got == want
    assert got["layers/mlp/router/w"][1] == "float32"
    assert got["layers/mlp/experts/w1"][1] == cfg.param_dtype
    assert ("mtp/block/mlp/experts/w1" in got) == cfg.mtp
    norms = sum(p.numel() for n, p in ours.named_parameters()
                if n.rsplit(".", 1)[-1] in ("ln1", "ln2", "final_ln", "kv_ln", "q_ln",
                                            "ln_h", "ln_e", "bias"))
    n_mtp = sum(p.numel() for n, p in ours.named_parameters()
                if n.startswith("mtp.") and n.rsplit(".", 1)[-1] not in
                ("ln1", "ln2", "final_ln", "kv_ln", "q_ln", "ln_h", "ln_e", "bias"))
    assert sum(p.numel() for p in ours.parameters()) == param_count(cfg)[0] + norms + n_mtp
    assert all(not p.any() for n, p in ours.named_parameters()
               if n.endswith(("ln1", "ln2", "final_ln", "kv_ln", "bias")))
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(ours.parameters(), again.parameters()))


def test_deepseek_v2_lite_full_width():
    cfg = configs.get_config("deepseek_v2_lite_16b")
    assert param_count(cfg)[0] == 15_706_357_760
    m = cfg.mla
    # the latent cache a token and layer against a per-head KV cache's
    assert m.kv_lora_rank + m.qk_rope_head_dim == 576
    assert 2 * cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim) == 6144
    # decode at 8 slots: int(8 * 6 / 64 * 1.25) = 0, so each expert takes one token
    t = 8
    assert max(1, int(t * cfg.moe.top_k / cfg.moe.n_experts * cfg.moe.capacity_factor)) == 1


@pytest.mark.parametrize("scan_layers", [True, False])
def test_convert_round_trip_keeps_dtypes(scan_layers):
    """deepseek_v3 (bf16 parameters, float32 router, MTP): both layer
    layouts read, bf16 bit for bit, and lm_params_to_numpy gives the
    reference's tree back."""
    jcfg, cfg = reduced("deepseek_v3_671b", scan_layers=scan_layers)
    jp = jax_params(jcfg)
    assert isinstance(jp["layers"], dict) == scan_layers
    params = port_params(cfg, jp)
    assert params.layers[0].mlp["router"]["w"].dtype == torch.float32
    assert params.layers[0].mlp["experts"]["w1"].dtype == torch.bfloat16
    assert params.mtp["block"]["mlp"]["router"]["bias"].dtype == torch.float32
    back = lm_params_to_numpy(params, stacked=scan_layers)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    with pytest.raises(ValueError, match="dense_layers"):
        port_params(cfg, dict(jp, dense_layers=[]))


def test_latent_cache_from_numpy():
    jm, _, model, _ = models("deepseek_v3_671b", "bfloat16")
    jcache = jax.tree.map(np.asarray, jm.init_cache(B, 4))
    got = kv_cache_from_numpy(jcache, device="cpu")
    want = model.init_cache(B, 4)
    assert set(got) == set(want) == {"dense", "moe"}
    for part in ("dense", "moe"):
        for k in ("ckv", "krope"):
            assert got[part][k].shape == want[part][k].shape == jcache[part][k].shape
            assert got[part][k].dtype == want[part][k].dtype == torch.bfloat16
    v2 = models("deepseek_v2_lite_16b")[2]
    cfg2 = dataclasses.replace(v2.cfg, moe=dataclasses.replace(v2.cfg.moe, first_dense_layers=0))
    assert build_model(cfg2, device="cpu").init_cache(B, 4)["dense"] is None
    assert kv_cache_from_numpy({"dense": None, "moe": jcache["moe"]}, device="cpu")["dense"] \
        is None


def test_build_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(configs.get_reduced_config("deepseek_v2_lite_16b"))


# -------------------------------------------------------------- routing -----
@pytest.mark.parametrize("arch", MOE)
def test_route_and_gate_matrix_match_jax(arch):
    """_route's expert indices equal, weights and probabilities to 1e-5;
    the sigmoid router with a bias that moves the choice."""
    jm, jp, model, _ = models(arch)
    cfg = model.cfg
    jl, pl = layer0(jp)
    rng = np.random.default_rng(0)
    x = rand(rng, 40, cfg.d_model)
    bias = rand(rng, cfg.moe.n_experts) * 0.05
    want = J_ROUTE(jnp.asarray(x), jl["mlp"]["router"]["w"], jnp.asarray(bias), cfg)
    got = moe._route(torch.tensor(x), pl["mlp"]["router"]["w"], torch.tensor(bias), cfg)
    assert torch.equal(got[1], torch.tensor(np.asarray(want[1])).long())
    close(got[0], want[0], what="weights")
    close(got[2], want[2], what="probs")
    if cfg.moe.router == "sigmoid_bias":
        # the bias enters the choice: without it the choice differs
        _, idx0, _ = moe._route(torch.tensor(x), pl["mlp"]["router"]["w"],
                                torch.zeros_like(torch.tensor(bias)), cfg)
        assert not torch.equal(idx0, got[1])
    for e_offset, e_loc in ((0, cfg.moe.n_experts), (4, 4)):
        g = moe._gate_matrix(got[0], got[1], e_offset, e_loc)
        jg = J_GATE(want[0], want[1], e_offset, e_loc)
        close(g, jg, what="gate")
        assert torch.equal(g != 0, torch.tensor(np.asarray(jg) != 0))


@pytest.mark.parametrize("capacity", [3, 12, 64])
@pytest.mark.parametrize("arch", MOE)
def test_routed_ffn_local_matches_jax(arch, capacity):
    """The capacity selection (each expert's tokens) equal, the combined
    output to 1e-5: capacity 3 and 12 drop tokens, 64 drops none (40
    tokens)."""
    jm, jp, model, _ = models(arch)
    cfg = model.cfg
    jl, pl = layer0(jp)
    rng = np.random.default_rng(1)
    x = rand(rng, 40, cfg.d_model)
    w, idx, _ = moe._route(torch.tensor(x), pl["mlp"]["router"]["w"],
                           pl["mlp"]["router"]["bias"], cfg)
    gate = moe._gate_matrix(w, idx, 0, cfg.moe.n_experts)
    c = min(capacity, 40)
    _, sel = moe.top_k(gate.T, c)
    _, jsel = jax.lax.top_k(jnp.asarray(gate.T.numpy()), c)
    assert torch.equal(sel, torch.tensor(np.asarray(jsel)).long())
    ex, jex = pl["mlp"]["experts"], jl["mlp"]["experts"]
    got = moe._routed_ffn_local(torch.tensor(x), gate, ex["w1"], ex["w3"], ex["w2"], capacity)
    want = J_FFN(jnp.asarray(x), jnp.asarray(gate.numpy()),
                                  jex["w1"], jex["w3"], jex["w2"], capacity)
    close(got, want, what="routed ffn")


def test_planted_ties_select_what_lax_top_k_selects():
    """Duplicated rows tie exactly in every expert's gate column, and an
    under-full expert's zero gates tie too: the port's top_k (and so its
    capacity selection) picks the indices lax.top_k picks, and the outputs
    agree."""
    jm, jp, model, _ = models("deepseek_v2_lite_16b")
    cfg = model.cfg
    jl, pl = layer0(jp)
    rng = np.random.default_rng(2)
    base = rand(rng, 5, cfg.d_model)
    x = base[[0, 1, 0, 2, 1, 0, 3, 4, 3, 0, 2, 1]]          # exact duplicates, interleaved
    w, idx, _ = moe._route(torch.tensor(x), pl["mlp"]["router"]["w"],
                           pl["mlp"]["router"]["bias"], cfg)
    gate = moe._gate_matrix(w, idx, 0, cfg.moe.n_experts)
    assert (gate.T == 0).sum() > 0
    for c in (1, 2, 3, 5, 12):
        _, sel = moe.top_k(gate.T, c)
        _, jsel = jax.lax.top_k(jnp.asarray(gate.T.numpy()), c)
        assert torch.equal(sel, torch.tensor(np.asarray(jsel)).long()), c
    ties = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 0.0, 1.0]])
    for k in range(1, 8):
        assert moe.top_k(ties, k)[1].tolist() == \
            np.asarray(jax.lax.top_k(jnp.asarray(ties.numpy()), k)[1]).tolist()
    ex, jex = pl["mlp"]["experts"], jl["mlp"]["experts"]
    for capacity in (1, 2):
        got = moe._routed_ffn_local(torch.tensor(x), gate, ex["w1"], ex["w3"], ex["w2"], capacity)
        want = J_FFN(jnp.asarray(x), jnp.asarray(gate.numpy()),
                                      jex["w1"], jex["w3"], jex["w2"], capacity)
        close(got, want, what=f"planted ties, capacity {capacity}")
        # an expert takes the lowest-indexed of tied copies first, so at
        # capacity c no copy past a row's c-th is served by any expert
        for copies in ((0, 2, 5, 9), (1, 4, 11)):
            assert not got[list(copies[capacity:])].any()


@pytest.mark.parametrize("capacity_factor", [1.25, 64.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_jax(arch, capacity_factor):
    """moe_block: output to 1e-5, aux_loss to 1e-5, expert_load equal."""
    jcfg, cfg = reduced(arch, compute_dtype="float32", capacity_factor=capacity_factor)
    _, jp, _, _ = models(arch)
    jl, pl = layer0(jp)
    x = rand(np.random.default_rng(3), 3, 8, cfg.d_model)
    out, aux = moe.moe_block(pl["mlp"], torch.tensor(x), cfg)
    jout, jaux = J_MOE(jl["mlp"], jnp.asarray(x), jcfg)
    close(out, jout, what="out")
    close(aux["aux_loss"], jaux["aux_loss"], what="aux")
    assert aux["aux_loss"].dtype == torch.float32 and aux["aux_loss"].shape == ()
    np.testing.assert_array_equal(aux["expert_load"].numpy(), np.asarray(jaux["expert_load"]))


# ------------------------------------------------------------------ MLA -----
@pytest.mark.parametrize("arch", MOE)
def test_mla_block_materialised_matches_jax(arch):
    jm, jp, model, _ = models(arch)
    cfg = model.cfg
    jl, pl = layer0(jp)
    x = rand(np.random.default_rng(4), B, 20, cfg.d_model)     # chunk 512: one ragged chunk
    out, cache = mla.mla_block(pl["attn"], torch.tensor(x), torch.arange(20), cfg)
    jout, _ = J_MLA(jl["attn"], jnp.asarray(x), jnp.arange(20), jm.cfg)
    assert cache is None
    close(out, jout, what="materialised")


@pytest.mark.parametrize("pos", [[0, 3], [5, 7], [9, 2]])
@pytest.mark.parametrize("arch", MOE)
def test_mla_block_absorbed_decode_matches_jax(arch, pos):
    """One token a slot into a capacity-8 latent cache: the row written in
    place at min(pos, 7) (pos 9 overflows), the mask t <= pos, the output."""
    jm, jp, model, _ = models(arch)
    cfg = model.cfg
    jl, pl = layer0(jp)
    rng = np.random.default_rng(5)
    x = rand(rng, B, 1, cfg.d_model)
    lat = {"ckv": rand(rng, B, 8, cfg.mla.kv_lora_rank),
           "krope": rand(rng, B, 8, cfg.mla.qk_rope_head_dim)}
    empty = mla.init_mla_cache(cfg, B, 8, torch.float32)
    assert {k: v.shape for k, v in empty.items()} == {k: v.shape for k, v in lat.items()}
    cache = {k: torch.tensor(v) for k, v in lat.items()}
    pos = np.asarray(pos, np.int32)
    out, new = mla.mla_block(pl["attn"], torch.tensor(x), torch.tensor(pos)[:, None], cfg,
                             cache=cache, cache_pos=torch.tensor(pos))
    jout, jnew = J_MLA(jl["attn"], jnp.asarray(x), jnp.asarray(pos)[:, None], jm.cfg,
                                cache={k: jnp.asarray(v) for k, v in lat.items()},
                                cache_pos=jnp.asarray(pos))
    close(out, jout, what="absorbed")
    for k in ("ckv", "krope"):
        close(new[k], jnew[k], what=k)
    assert new["ckv"] is cache["ckv"]                       # written in place


# ---------------------------------------------------------------- model -----
class NearTies:
    """Records, per top_k call of the port's MoE, whether any selection had
    a near tie: the k-th and (k+1)-th values within two bf16 epsilons of a
    non-zero k-th value (a zero k-th value routes nothing)."""

    def __init__(self, monkeypatch):
        self.seen = False
        real = moe.top_k

        def spy(x, k):
            vals, idx = torch.sort(x.float(), dim=-1, descending=True, stable=True)
            if k < x.shape[-1]:
                kth, nxt = vals[..., k - 1], vals[..., k]
                self.seen |= bool(((kth > 0) & (kth - nxt <= 2 * BF16_EPS * kth)).any())
            return real(x, k)

        monkeypatch.setattr(moe, "top_k", spy)

    def take(self) -> bool:
        seen, self.seen = self.seen, False
        return seen


def assert_logits(got, want, dtype: str, near_tie: bool, tally: list) -> None:
    """float32: to 1e-5 of the scale.  bf16: each row to two bf16
    epsilons of the scale unless the call had a near tie (tallied)."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
        return
    for g, w in zip(got, want):
        ok = float(np.abs(g - w).max()) <= 2 * BF16_EPS * scale
        assert ok or near_tie, float(np.abs(g - w).max()) / scale
        tally.append(ok)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_jax(arch, dtype, monkeypatch):
    jm, jp, model, params = models(arch, dtype)
    ties = NearTies(monkeypatch)
    toks = np.random.default_rng(7).integers(0, model.cfg.vocab_size, (B, S)).astype(np.int32)
    tally: list[bool] = []
    got = model.prefill(params, {"tokens": toks})
    assert got.shape == (B, model.cfg.vocab_size) and got.dtype == model.cfg.cdtype()
    assert_logits(got, jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}), dtype,
                  ties.take(), tally)
    cache, jcache = model.init_cache(B, S), jm.init_cache(B, S)
    jstep = jax.jit(jm.decode_step)
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        logits, cache = model.decode_step(params, cache, toks[:, t], pos)
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t]), jnp.asarray(pos))
        assert_logits(logits, jlogits, dtype, ties.take(), tally)
    if dtype == "bfloat16":
        assert sum(tally) >= 0.75 * len(tally), tally
    else:
        jc = kv_cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
        for part in ("dense", "moe"):
            for k in ("ckv", "krope"):
                close(cache[part][k], jc[part][k].numpy(), what=f"{part}/{k}")


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_prefill(arch):
    """The reference's test_decode_matches_prefill on the port: float32,
    capacity_factor 64 so that neither path drops a token; the absorbed
    decode against the materialised prefill."""
    _, _, model, params = models(arch, capacity_factor=64.0)
    tokens = torch.randint(0, model.cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(7))
    want = model.prefill(params, {"tokens": tokens})
    cache = model.init_cache(B, S)
    for t in range(S):
        logits, cache = model.decode_step(params, cache, tokens[:, t], torch.full((B,), t))
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-3, atol=1e-4)
    assert torch.equal(logits.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", MOE)
def test_engine_generates_jax_tokens(arch):
    """float32 at the published capacity_factor 1.25: decode's capacity is
    1 (2 slots: int(2 * k / E * 1.25) = 0), so an expert chosen by both
    rows drops one, an idle slot's row competing too; the tokens equal
    JAX's."""
    jm, jp, model, params = models(arch)
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


# ------------------------------------------------------ loss, training -----
def tokens(vocab: int, batch: int = B, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (batch, S + 1)).astype(np.int32)


TRAIN_CASES = {
    # each arch with its published optimizer options, compute in float32:
    # v2 full float32 moments; v3 bf16 parameters, bf16 factored moments and
    # 8 microbatches (accumulated in bf16)
    "v2": ("deepseek_v2_lite_16b", 4),
    "v3": ("deepseek_v3_671b", 8),
}


def step_tols(cfg) -> dict:
    """Relative tolerances of the step's gradients, parameters and moments:
    1e-5 in float32; with bf16 moments (and so a bf16 accumulator), bf16
    parameters: one bf16 epsilon for what is stored in bf16 (a value whose
    float32 straddles a rounding lands one ulp apart) and four for the
    gradients (each of the 8 microbatches' adds rounds to bf16)."""
    bf16 = cfg.optimizer_dtype == "bfloat16"
    return dict(grads=4 * BF16_EPS if bf16 else 1e-5,
                params=BF16_EPS if cfg.param_dtype == "bfloat16" else 1e-5,
                moments=BF16_EPS if bf16 else 1e-5)


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's train step on each case, run once and shared: (JAX cfg, port
    cfg, params before, batch, params after, AdamW state, metrics).  The
    two cases compile on two threads (XLA compiles outside the GIL)."""
    def one(case):
        arch, batch = TRAIN_CASES[case]
        jcfg, cfg = reduced(arch, compute_dtype="float32")
        jm, jp = jbuild_model(jcfg), jax_params(jcfg)
        jopt = dataclasses.replace(step_mod.opt_config_for(cfg), warmup_steps=1, eps=1e-3)
        jopt = joptimizer.AdamWConfig(**dataclasses.asdict(jopt))
        toks = tokens(cfg.vocab_size, batch=batch, seed=3)
        new, state, metrics = jax.jit(jmake_train_step(jm, jopt))(
            jp, joptimizer.init_adamw(jp, jopt), {"tokens": jnp.asarray(toks)})
        return jcfg, cfg, jp, toks, new, state, metrics

    for case in TRAIN_CASES:                 # the port's init draws, before the threads
        numpy_params(TRAIN_CASES[case][0])
    with ThreadPoolExecutor(len(TRAIN_CASES)) as pool:
        futures = {case: pool.submit(one, case) for case in TRAIN_CASES}
        return {case: f.result() for case, f in futures.items()}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_loss_fn_matches_jax(case, jax_steps):
    """loss_fn's lm_loss, aux_loss, mtp_loss (v3) and loss to 1e-5 of
    JAX's, which the train step reports as its means over the step's
    microbatches."""
    jcfg, cfg, jp, toks, _, _, jmetrics = jax_steps[case]
    model, params = build_model(cfg, device="cpu"), port_params(cfg, jp)
    runs = [model.loss_fn(params, {"tokens": mb})
            for mb in np.split(toks, cfg.grad_accum)]
    want = {"lm_loss", "aux_loss", "loss"} | ({"mtp_loss"} if cfg.mtp else set())
    for loss, metrics in runs:
        assert set(metrics) == want and loss is metrics["loss"]
        assert all(v.dtype == torch.float32 and v.shape == () for v in metrics.values())
        assert float(metrics["aux_loss"]) > 0
    for k in want:
        np.testing.assert_allclose(np.mean([float(m[k]) for _, m in runs]), float(jmetrics[k]),
                                   rtol=1e-5)


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_jax(case, jax_steps, monkeypatch):
    """One make_train_step from the same parameters and batch: the
    gradients handed to AdamW against JAX's (which the step's first moment
    holds: m = (1 - beta1) x clip x g), the leaves the loss never reads
    zero in both; the metrics; then the parameters and the AdamW state
    after the step, factored (v3) and not (v2)."""
    jcfg, cfg, jp, toks, jnew, jstate, jmetrics = jax_steps[case]
    tol = step_tols(cfg)
    model = build_model(cfg, device="cpu")
    opt = dataclasses.replace(step_mod.opt_config_for(cfg), warmup_steps=1, eps=1e-3)
    seen = {}
    update = step_mod.adamw_update

    def spy(grads, *a, **kw):
        seen["grads"] = tree_map(lambda t: t.float().clone(), grads)
        return update(grads, *a, **kw)

    monkeypatch.setattr(step_mod, "adamw_update", spy)
    params = port_params(cfg, jp)
    new, state, metrics = step_mod.make_train_step(model, opt)(
        params, optimizer.init_adamw(params, opt), {"tokens": toks})
    assert set(metrics) == set(jmetrics)
    for k in ("loss_mean", "loss", "lm_loss", "aux_loss", "grad_norm") + \
            (("mtp_loss",) if cfg.mtp else ()):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)

    clip = min(1.0, opt.grad_clip / float(jmetrics["grad_norm"]))
    jgrads = {tuple(str(k.key) for k in p): np.asarray(m, np.float32) / ((1 - opt.beta1) * clip)
              for p, m in jax.tree_util.tree_leaves_with_path(jstate.m)}
    grads = dict(tree_leaves_with_path(tree_map(
        lambda x: np.stack([t.numpy() for t in x]) if isinstance(x, Stacked) else x.numpy(),
        seen["grads"], is_leaf=lambda x: isinstance(x, Stacked))))
    assert set(grads) == set(jgrads)
    unread = {p for p, g in jgrads.items() if not g.any()}
    expect = {("layers", "mlp", "router", "bias")} | ({("mtp", "final_ln"),
              ("mtp", "block", "mlp", "router", "bias")} if cfg.mtp else set())
    assert unread == expect
    for path, g in jgrads.items():
        close(grads[path], g, tol["grads"], "/".join(path))
        assert grads[path].any() != (path in unread)

    for (p, g), w in zip(tree_leaves_with_path(lm_params_to_numpy(new)), jax.tree.leaves(jnew)):
        close(g, w, tol["params"], "/".join(p))
    for ours, theirs in ((state.m, jstate.m), (state.v, jstate.v)):
        for (p, g), w in zip(tree_leaves_with_path(tree_map(lambda t: t.float(), ours)),
                             jax.tree.leaves(theirs)):
            close(g, w, tol["moments"], "/".join(p))
    w1 = state.v["layers"]["mlp"]["experts"]["w1"]
    if cfg.optimizer_factored:
        e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.expert_d_ff
        assert (w1["row"].shape, w1["col"].shape) == ((cfg.n_layers - 1, e, d),
                                                     (cfg.n_layers - 1, e, f))
    else:
        assert isinstance(w1, torch.Tensor) and w1.dim() == 4


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
    """deepseek_v3 after JAX's step (bf16 parameters, float32 router, bf16
    factored moments): its checkpoint restores in the port leaf for leaf
    and bit for bit; after one more step on the port, the port's
    checkpoint restores in JAX bit for bit, with the same file names and
    treedef."""
    jcfg, cfg, _, toks, jp, jstate, _ = jax_steps["v3"]
    JaxManager(tmp_path / "jax").save(1, (jp, jstate), blocking=True)
    model, opt = build_model(cfg, device="cpu"), step_mod.opt_config_for(cfg)
    fresh = model.init(torch.Generator().manual_seed(0))
    (params, state), step = CheckpointManager(tmp_path / "jax").restore(
        (fresh, optimizer.init_adamw(fresh, opt)))
    assert step == 1 and params.layers[0].mlp["router"]["w"].dtype == torch.float32
    want = [bits(x) for x in jax.tree.leaves((jp, jstate))]
    got = port_bits(params, state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    params, state, _ = step_mod.make_train_step(model, opt)(params, state, {"tokens": toks})
    CheckpointManager(tmp_path / "port").save(2, (params, state), blocking=True)
    (jr, jrs), jstep = JaxManager(tmp_path / "port").restore((jp, jstate))
    assert jstep == 2 and int(jrs.step) == 2
    for g, w in zip([bits(x) for x in jax.tree.leaves((jr, jrs))], port_bits(params, state)):
        np.testing.assert_array_equal(g, w)
    a, b = tmp_path / "jax" / "step_0000000001", tmp_path / "port" / "step_0000000002"
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir())
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma["treedef"] == mb["treedef"] and ma["leaves"] == mb["leaves"]
    assert {"name": "0__layers__mlp__router__w", "shape": [cfg.n_layers - 1, cfg.d_model,
            cfg.moe.n_experts], "dtype": "float32"} in mb["leaves"]
    state_np = adamw_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    assert state_np.v["layers"]["mlp"]["experts"]["w1"]["row"].dtype == torch.float32
    assert state_np.m["layers"]["mlp"]["experts"]["w1"].dtype == torch.bfloat16


# --------------------------------------------------------- entry points -----
def test_entry_points_on_cpu(tmp_path, capsys):
    log = launch_train.main(["--arch", "deepseek_v2_lite_16b", "--reduced", "--steps", "2",
                             "--batch", "2", "--seq", "16", "--device", "cpu",
                             "--ckpt_dir", str(tmp_path)])
    assert [m["step"] for m in log] == [2] and np.isfinite(log[0]["loss_mean"])
    assert log[0]["aux_loss"] > 0
    done = launch_serve.main(["--device", "cpu", "--arch", "deepseek_v2_lite_16b",
                              "--requests", "3", "--max_new", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    done = serve_lm.main(["--device", "cpu", "--arch", "deepseek_v3_671b", "--requests", "3",
                          "--max_new", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    out = capsys.readouterr().out
    assert "step 2 loss" in out and "served 3 requests (12 tokens)" in out \
        and "3 requests, 12 tokens" in out
