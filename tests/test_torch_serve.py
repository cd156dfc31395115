"""The port's serving path (``repro_torch.serve.engine``,
``repro_torch.launch.serve``, ``repro_torch.examples.{serve_lm,
lm_embedding_atlas}``) against the JAX package on the CPU.

JAX's parameters (``model.init(PRNGKey(0))``) are carried across with
``lm_params_from_numpy``.  Token-for-token parity is held in
``compute_dtype="float32"``: with bf16 logits the two frameworks' sums can
break a near-tie the other way (the reference's own decode-vs-prefill test
runs in float32 for the same reason).  bf16 is held to two bf16 epsilons
(2 x 2^-7) of the logits' scale, as in ``test_torch_lm.py``.
"""
import dataclasses
import functools
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.examples import lm_embedding_atlas, serve_lm  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

DENSE = ["deepseek_7b", "phi4_mini_3p8b", "minitron_8b"]
BF16_EPS = 2.0**-7


@functools.lru_cache(maxsize=None)
def models(arch: str, dtype: str):
    """(JAX model, JAX params, port model, port params) of the reduced arch."""
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch), compute_dtype=dtype)
    cfg = dataclasses.replace(configs.get_reduced_config(arch), compute_dtype=dtype)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(cfg, device="cpu"), \
        lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def serve(engine_cls, request_cls, model, params, prompts, max_new=4, **kw):
    eng = engine_cls(model, **{"batch_slots": 2, "max_seq": 64, **kw})
    for r, prompt in enumerate(prompts):
        eng.submit(request_cls(rid=r, prompt=list(prompt), max_new_tokens=max_new))
    done = eng.run(params)
    return {req.rid: req.generated for req in done}, eng


FIVE = [[1 + r, 2, 3] for r in range(5)]        # test_substrate.py's five requests


# -------------------------------------------------------------- engine -----
@pytest.mark.parametrize("arch", DENSE)
def test_engine_generates_jax_tokens(arch):
    jm, jp, model, params = models(arch, "float32")
    want, jeng = serve(JServeEngine, JRequest, jm, jp, FIVE)
    got, eng = serve(ServeEngine, Request, model, params, FIVE)
    assert got == want and len(got) == 5 and all(len(g) == 4 for g in got.values())
    # the same telemetry: counters, gauges' high-water marks, token histogram
    assert eng.stats() == jeng.stats()
    snap = eng.stats()
    assert set(snap) == {"serve.ticks", "serve.completed", "serve.tokens", "serve.queue_depth",
                         "serve.slot_occupancy", "serve.request_tokens"}
    assert (snap["serve.completed"], snap["serve.tokens"]) == (5, 20)
    assert snap["serve.slot_occupancy"]["max"] == 2 and snap["serve.queue_depth"]["max"] == 3
    assert snap["serve.request_tokens"]["count"] == 5


@pytest.mark.parametrize("eos_first, max_seq", [(True, 64), (False, 6)])
def test_engine_retires_as_jax(eos_first, max_seq):
    """EOS (the first request's first token) and the max_seq cap retire
    requests at the reference's ticks."""
    jm, jp, model, params = models("deepseek_7b", "float32")
    eos = None
    if eos_first:
        eos = serve(ServeEngine, Request, model, params, FIVE[:1], max_new=1)[0][0][0]
    kw = dict(max_seq=max_seq, eos_id=eos)
    want, _ = serve(JServeEngine, JRequest, jm, jp, FIVE, max_new=8, **kw)
    got, _ = serve(ServeEngine, Request, model, params, FIVE, max_new=8, **kw)
    assert got == want
    if eos_first:
        assert got[0] == [eos]
    else:
        assert all(len(g) == max_seq - 3 for g in got.values())     # pos reaches max_seq - 1


def test_step_directly_after_construction():
    _, _, model, params = models("deepseek_7b", "bfloat16")
    eng = ServeEngine(model, batch_slots=2, max_seq=32, params=params)
    eng.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=2))
    assert eng.step() is True
    done = eng.run()                    # params already bound at init
    assert len(done) == 1 and len(done[0].generated) == 2


def test_step_without_params_raises():
    _, _, model, _ = models("deepseek_7b", "bfloat16")
    eng = ServeEngine(model, batch_slots=1, max_seq=32)
    eng.submit(Request(rid=0, prompt=[1], max_new_tokens=1))
    with pytest.raises(RuntimeError, match="no model params"):
        eng.step()


def test_greedy_decode_is_deterministic():
    _, _, model, params = models("deepseek_7b", "bfloat16")
    outs = []
    for _ in range(2):
        eng = ServeEngine(model, batch_slots=1, max_seq=32)
        eng.submit(Request(rid=0, prompt=[5, 6], max_new_tokens=6))
        outs.append(eng.run(params)[0].generated)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", DENSE)
def test_slots_do_not_leak(arch):
    """Each request served alone gives the tokens it gets in a pooled run
    with refills (a refilled slot restarts at pos 0 over its old rows)."""
    _, _, model, params = models(arch, "float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, rng.integers(2, 9)).tolist()
               for _ in range(7)]
    pooled, eng = serve(ServeEngine, Request, model, params, prompts, max_new=6, batch_slots=3)
    assert eng.stats()["serve.slot_occupancy"]["max"] == 3
    for r, prompt in enumerate(prompts):
        alone, _ = serve(ServeEngine, Request, model, params, [prompt], max_new=6, batch_slots=1)
        assert alone[0] == pooled[r]


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_engine_first_tick_logits(arch):
    """bf16: every request completes inside the vocabulary, and the first
    decode tick's logits agree with JAX's to the module's bf16 tolerance."""
    jm, jp, model, params = models(arch, "bfloat16")
    got, _ = serve(ServeEngine, Request, model, params, FIVE, max_new=5)
    assert len(got) == 5 and all(len(g) == 5 for g in got.values())
    assert all(0 <= t < model.cfg.vocab_size for g in got.values() for t in g)
    tok, pos = np.array([1, 2], np.int32), np.zeros(2, np.int32)
    logits, _ = model.decode_step(params, model.init_cache(2, 8), tok, pos)
    want, _ = jm.decode_step(jp, jm.init_cache(2, 8), jnp.asarray(tok), jnp.asarray(pos))
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=2 * BF16_EPS * np.abs(want).max())


def test_submit_from_another_thread():
    """submit() while run() drains: every request completes once."""
    _, _, model, params = models("deepseek_7b", "bfloat16")
    eng = ServeEngine(model, batch_slots=2, max_seq=32, params=params)
    eng.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=3))

    def feed():
        for r in range(1, 9):
            eng.submit(Request(rid=r, prompt=[r, 2], max_new_tokens=3))

    t = threading.Thread(target=feed)
    t.start()
    eng.run()
    t.join(timeout=30)
    assert not t.is_alive()
    done = eng.run()                    # whatever arrived after the first drain
    assert sorted(r.rid for r in done) == list(range(9))
    assert all(len(r.generated) == 3 for r in done)


# ----------------------------------------------------- launcher, examples -----
def test_launch_serve_main(capsys):
    done = launch_serve.main(["--device", "cpu", "--arch", "deepseek_7b"])
    assert len(done) == 6 and all(len(r.generated) == 8 for r in done)
    assert "served 6 requests (48 tokens)" in capsys.readouterr().out


def test_serve_lm_example(capsys):
    done = serve_lm.main(["--device", "cpu", "--arch", "phi4_mini_3p8b", "--requests", "5"])
    assert len(done) == 5 and all(len(r.generated) == 16 for r in done)
    assert "5 requests, 80 tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="text archs"):
        serve_lm.main(["--device", "cpu", "--arch", "whisper_tiny"])


def test_atlas_token_batches():
    vocab = configs.get_reduced_config("deepseek_7b").vocab_size
    for dom in range(4):
        toks = lm_embedding_atlas.token_batch(vocab, dom, 3, 16)
        assert toks.shape == (4, 16) and toks.dtype == torch.int32
        lo = dom * vocab // 4
        assert int(toks.min()) >= lo and int(toks.max()) < lo + vocab // 8
        assert torch.equal(toks, lm_embedding_atlas.token_batch(vocab, dom, 3, 16))
    assert not torch.equal(lm_embedding_atlas.token_batch(vocab, 0, 0, 16),
                           lm_embedding_atlas.token_batch(vocab, 0, 1, 16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_atlas_states_match_jax_prefill(dtype):
    """The atlas's harvested states are JAX's prefill logits for the same
    token batches (float32 to 1e-5 of their scale, bf16 to two epsilons)."""
    jm, jp, model, params = models("deepseek_7b", dtype)
    x, labels = lm_embedding_atlas.harvest_states(model, params, batches=2, seq=16)
    assert x.shape == (32, model.cfg.vocab_size) and x.dtype == np.float32
    np.testing.assert_array_equal(labels, np.repeat(np.arange(4), 8))
    prefill = jax.jit(jm.prefill)
    want = np.concatenate([
        np.asarray(prefill(jp, {"tokens": jnp.asarray(
            lm_embedding_atlas.token_batch(model.cfg.vocab_size, dom, b, 16).numpy())}), np.float32)
        for dom in range(4) for b in range(2)])
    scale = np.abs(want).max()
    np.testing.assert_allclose(x, want, rtol=0,
                               atol=(1e-5 if dtype == "float32" else 2 * BF16_EPS) * scale)


def test_atlas_main(tmp_path, capsys):
    out = tmp_path / "atlas.npy"
    run = lm_embedding_atlas.main(["--device", "cpu", "--batches", "4", "--iters", "120",
                                   "--grow", "16", "--out", str(out)])
    assert run.y.shape == (64, 2) and np.isfinite(run.y).all() and run.n_grow == 16
    np.testing.assert_array_equal(np.load(out), run.y)
    assert np.isfinite(run.kl) and run.kl > 0
    assert run.service["completed"] == 16 and run.fit_s > 0
    assert np.isfinite([run.intra, run.inter, run.intra_new, run.inter_new]).all()
    printed = capsys.readouterr().out
    assert "fitting atlas on 48 states from deepseek_7b" in printed and "service: 16" in printed
