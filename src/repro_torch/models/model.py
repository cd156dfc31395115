"""Top-level model API: ``build_model(cfg)`` -> init / loss / prefill /
decode: port of ``repro/models/model.py``, all six families.

    model = build_model(get_config("deepseek_7b"))          # on cuda
    params = model.init(torch.Generator("cuda").manual_seed(0))
    loss, metrics = model.loss_fn(params, {"tokens": tokens})   # tokens [B, S + 1]
    logits = model.prefill(params, {"tokens": tokens})      # [B, V], last position
    cache = model.init_cache(batch, seq)
    logits, cache = model.decode_step(params, cache, token, pos)

The families:

* ``dense``: the scanned GQA decoder (deepseek_7b, phi4_mini_3p8b,
  minitron_8b, llama3_405b);
* ``moe``: ``first_dense_layers`` dense blocks, then MoE blocks, both with
  MLA attention (deepseek_v2_lite_16b, deepseek_v3_671b), and DeepSeek-V3's
  depth-1 multi-token-prediction module when ``cfg.mtp``.  ``loss_fn``
  adds ``aux_loss_weight`` times the summed aux load-balance loss and
  ``mtp_loss_weight`` times the MTP loss.  As in the reference, the MTP
  term belongs to this family alone: a dense config with ``mtp=True``
  trains on the plain LM loss;
* ``ssm``: RWKV-6 blocks, attention-free (rwkv6_3b); the decode cache is
  recurrent state (``models/rwkv.py``);
* ``hybrid``: Mamba-2 blocks with one shared attention block applied every
  ``shared_stride`` layers (zamba2_2p7b; ``models/ssm.py`` and
  ``transformer.hybrid_forward``);
* ``audio``: whisper's encoder-decoder (whisper_tiny).  The conv frontend
  is a stub: ``batch["frames"]`` [B, n_frames, D] are precomputed frame
  embeddings.  The encoder (:func:`_encoder`: the frames plus a sinusoid,
  dense blocks, non-causal, no RoPE) feeds each decoder layer's cross
  K/V (:func:`_cross_kv`); the decoder blocks (``decoder_cross``) add the
  sinusoid to the text and keep RoPE.  The decode cache is ``{"self":
  the KV cache, "cross": the (k, v) pair}``.  As in the reference, nothing
  here fills the cross pair (``prefill`` returns logits only, and a
  ``Request`` carries no frames), so the engine decodes against zeros;
  a caller that wants decode to see the audio writes
  ``_cross_kv(cfg, p, _encoder(cfg, p, frames))`` into it;
* ``vlm``: the dense decoder over ``[patches ; text]`` (llava_next_34b).
  The anyres vision tower is a stub: ``batch["patches"]`` [B, n_patches,
  D] are pre-projected patch embeddings placed before the text;
  ``loss_fn`` masks them out of the loss, whose mean is over the text
  positions.  Decode is the dense family's, text alone from position 0.

``build_model`` returns the reference's namespace (``cfg``, ``init``,
``loss_fn``, ``prefill``, ``decode_step``, ``init_cache``,
``input_specs``, plus ``device``),
so ``serve.engine.ServeEngine`` and ``train.trainer.Trainer`` read the same
in both packages.  ``params`` is a :class:`DecoderLM`: an ``nn.Module``
holding the reference's parameter tree as ``nn.Parameter`` objects in
``param_dtype`` (the MoE router, RWKV's ``w0`` and ``u`` and Mamba's
``dt_bias``, ``a_log`` and ``d_skip`` in float32).  Every call casts the
float parameters to ``compute_dtype`` (as the reference does, those
float32 leaves too) and embeds from the cast table; ``prefill`` and
``decode_step`` run under ``torch.no_grad``, ``loss_fn`` differentiates
back through the cast to the stored parameters.  ``input_specs(shape)``
gives a shape cell's abstract inputs (meta tensors) and
``build_model(cfg, device="meta")`` the abstract path, the counterpart of
the reference's ``jax.eval_shape``: ``launch.cell`` builds the dry-run's
cells from them and ``launch.cost`` counts their steps.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import init_kv_cache
from repro_torch.models.layers import NO_DRAWS, init_dense, rms_norm
from repro_torch.models.mla import init_mla_cache
from repro_torch.models.rwkv import init_rwkv, init_rwkv_cache, rwkv_block
from repro_torch.models.transformer import (
    block_forward, hybrid_forward, init_block, init_hybrid, init_hybrid_cache, init_stack,
    stack_forward, stacked_cache,
)
from repro_torch.tree import Stacked, tree_map

# the abstract path's device: shapes and dtypes, no storage
META = torch.device("meta")


def layer_stacks(cfg: ArchConfig) -> dict[tuple[str, ...], int]:
    """The parameter tree's layer stacks, by their path in the tree, and
    their depths: ``layers`` for the dense, vlm and ssm families;
    ``dense_layers`` (when ``first_dense_layers``) and ``layers`` (the MoE
    blocks) for the MoE family; ``encoder`` and ``layers`` (the
    ``decoder_cross`` blocks) for the audio family; ``layers/mamba`` for
    the hybrid family (whose ``layers/shared`` is one block, not a
    stack)."""
    if cfg.family == "hybrid":
        return {("layers", "mamba"): cfg.n_layers}
    if cfg.family == "audio":
        return {("encoder",): cfg.enc_dec.n_encoder_layers, ("layers",): cfg.n_layers}
    if cfg.family != "moe":
        return {("layers",): cfg.n_layers}
    nd = cfg.moe.first_dense_layers
    return {**({("dense_layers",): nd} if nd else {}), ("layers",): cfg.n_layers - nd}


def scanned(cfg: ArchConfig) -> bool:
    """Whether the reference stacks the layers ``[L, ...]``: under
    ``cfg.scan_layers``, and always for the ssm and hybrid families (their
    stacks are built by ``vmap`` and scanned whatever ``scan_layers``
    says)."""
    return cfg.scan_layers or cfg.family in ("ssm", "hybrid")


def tree_get(tree, path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def tree_put(tree: dict, path: tuple[str, ...], value) -> None:
    """``tree[path] = value``, the dicts on the way made as needed."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


class _Tree(nn.Module):
    """A dict of tensors and dicts held as parameters and submodules under
    the reference's names, in sorted order whatever the dict's (so a module
    restored from a checkpoint lists its parameters as a fresh one does);
    ``node[name]`` reads either."""

    def __init__(self, tree: dict):
        super().__init__()
        for name in sorted(tree):
            value = tree[name]
            if isinstance(value, dict):
                self.add_module(name, _Tree(value))
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def tree(self) -> dict:
        return {**{n: p for n, p in self.named_parameters(recurse=False)},
                **{n: m.tree() for n, m in self.named_children()}}


class DecoderLM(nn.Module):
    """A decoder's parameters as a module.  Built from the reference's tree
    (``embed.embedding [V, D]``, ``final_ln [D]``, ``unembed [D, V]``
    unless tied, each of :func:`layer_stacks`'s stacks (the audio family's
    ``encoder`` among them) a list of block
    dicts with ``[in, out]`` weights or the scanned layout: one block dict
    whose leaves are ``[L, ...]`` tensors or
    :class:`~repro_torch.tree.Stacked`; the MoE family's ``mtp`` module
    when ``cfg.mtp``; the hybrid family's ``layers/shared`` block when
    ``shared_stride``); :meth:`tree` gives it back with lists of layers,
    :meth:`reference_tree` in the reference's own layout.  Not called
    itself: ``build_model``'s functions take it as ``params``.  The
    parameters are frozen (``requires_grad=False``) until a caller trains
    them: ``params.requires_grad_(True)``, as ``train.step``'s step does."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Parameter(tree["embed"]["embedding"])
        self.final_ln = nn.Parameter(tree["final_ln"])
        self.unembed = None if cfg.tie_embeddings else nn.Parameter(tree["unembed"])
        for path, depth in layer_stacks(cfg).items():
            layers = tree_get(tree, path)
            if isinstance(layers, dict):
                layers = [tree_map(lambda a, i=i: a[i], layers,
                                   is_leaf=lambda x: isinstance(x, Stacked))
                          for i in range(depth)]
            parent = self
            for key in path[:-1]:                  # the hybrid's `layers` holds two parts
                if key not in parent._modules:
                    parent.add_module(key, nn.Module())
                parent = getattr(parent, key)
            parent.add_module(path[-1], nn.ModuleList(_Tree(layer) for layer in layers))
        if self._shared(cfg):
            self.layers.add_module("shared", _Tree(tree["layers"]["shared"]))
        self.mtp = _Tree(tree["mtp"]) if cfg.family == "moe" and cfg.mtp else None
        self.requires_grad_(False)

    @staticmethod
    def _shared(cfg: ArchConfig) -> bool:
        return cfg.family == "hybrid" and bool(cfg.ssm.shared_stride)

    def tree(self) -> dict:
        out = {"embed": {"embedding": self.embedding}, "final_ln": self.final_ln}
        for path in layer_stacks(self.cfg):
            stack = functools.reduce(getattr, path, self)
            tree_put(out, path, [layer.tree() for layer in stack])
        if self._shared(self.cfg):
            out["layers"]["shared"] = self.layers.shared.tree()
        if self.unembed is not None:
            out["unembed"] = self.unembed
        if self.mtp is not None:
            out["mtp"] = self.mtp.tree()
        return out

    def reference_tree(self) -> dict:
        """The tree in the reference's layout: where the reference stacks
        the layers (:func:`scanned`), each layer stack is one block dict
        whose leaves are ``Stacked`` (the L per-layer parameters of each
        stacked leaf); else the list.  The optimizer's state and the
        checkpoints follow this layout."""
        out = self.tree()
        if scanned(self.cfg):
            for path in layer_stacks(self.cfg):
                tree_put(out, path, tree_map(lambda *ps: Stacked(ps), *tree_get(out, path)))
        return out

    # a checkpoint saves the reference's layout (Stacked leaves are stacked
    # on the host) and restores a new module from it
    checkpoint_tree = reference_tree

    def from_checkpoint_tree(self, tree: dict) -> DecoderLM:
        return DecoderLM(self.cfg, tree)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood in float32 (over the
    mask's ones when a mask is given)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    nll = lse - ll
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = nll.numel()
    return nll.sum() / denom


def _sinusoid(positions: torch.Tensor, d: int, dtype: torch.dtype) -> torch.Tensor:
    """[..., S] -> [..., S, d] whisper's sinusoidal embedding: sines of the
    first d / 2 frequencies, then their cosines.  Computed in float32 as
    the reference computes it (``log(10000)`` a float32 scalar, the
    positions cast to float32 before the product), then cast to
    ``dtype``."""
    half = d // 2
    step = torch.log(torch.tensor(10000.0, device=positions.device)) / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device) * step)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _encoder(cfg: ArchConfig, p: dict, frames: torch.Tensor) -> torch.Tensor:
    """The audio family's encoder over the stubbed frontend's frames [B,
    F, D] (precomputed embeddings): the frames in the compute dtype plus
    the sinusoid, then the ``encoder`` stack's dense blocks, non-causal
    and without RoPE.  ``p`` is the parameter tree in the compute dtype
    (``build_model``'s cast of ``params.tree()``; ``params.tree()`` itself
    where param_dtype is the compute dtype)."""
    dtype = cfg.cdtype()
    f = frames.shape[1]
    pos = torch.arange(f, device=frames.device)
    x = frames.to(dtype) + _sinusoid(pos, cfg.d_model, dtype)[None]
    return stack_forward(p["encoder"], x, pos, cfg, causal=False, use_rope=False)[0]


def _cross_kv(cfg: ArchConfig, p: dict, enc_out: torch.Tensor):
    """Each decoder layer's cross K and V from the encoder's output [B, F,
    D]: the pair ``([L, B, F, Hkv, dh], [L, B, F, Hkv, dh])``, the layout
    of the decode cache's ``cross``.  ``p`` as for :func:`_encoder`.  The
    reference computes it only under ``scan_layers`` (None otherwise, and
    its blocks then attend to the text with the cross weights); the port
    in every layout."""
    return tuple(torch.stack(kv) for kv in _cross_kv_layers(cfg, p, enc_out))


def _cross_kv_layers(cfg: ArchConfig, p: dict, enc_out: torch.Tensor):
    """:func:`_cross_kv` as two lists of a ``[B, F, Hkv, dh]`` tensor a
    layer, what the forward reads: a layer's select of the stacked pair
    would make the backward write a whole ``[L, ...]`` stack of zeros a
    layer (bytes quadratic in the depth)."""
    b, f, _ = enc_out.shape
    shape = (b, f, cfg.n_kv_heads, cfg.resolved_head_dim)
    return tuple([(enc_out @ layer["cross"][w]).reshape(shape) for layer in p["layers"]]
                 for w in ("wk", "wv"))


def build_model(cfg: ArchConfig, device=None) -> SimpleNamespace:
    """The family's training and serving functions on ``device`` (default
    cuda).  ``device="meta"`` is the abstract path, the counterpart of the
    reference's ``jax.eval_shape``: ``init()`` makes every parameter with
    the reference's shape and dtype and draws nothing, ``init_cache`` and
    ``input_specs`` give meta tensors, and the functions run on them
    without storage (``launch.cost`` counts their operations)."""
    dev = resolve_device(device, abstract=True)
    dtype = cfg.cdtype()
    pdtype = cfg.pdtype()
    fam = cfg.family
    moe = fam == "moe"
    layer_kind = {"moe": "moe", "audio": "decoder_cross"}.get(fam, "dense")

    def init(gen: torch.Generator | None = None) -> DecoderLM:
        """Fresh parameters drawn from ``gen``, which must live on the
        model's device: embedding, unembed, then each stack's layers in
        order (the audio family's encoder before its decoder, the hybrid's
        shared block after its Mamba layers), then the MTP module.  On the
        abstract path ``gen`` is None (no generator lives on meta) and the
        parameters are empty meta tensors."""
        if dev.type == "meta" and gen is None:
            gen = NO_DRAWS
        elif gen is None:
            raise ValueError(f"init needs a generator on {dev}")
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        d = cfg.d_model
        tree = {
            "embed": {"embedding": init_dense(gen, (cfg.vocab_size, d), pdtype, scale=1.0)},
            "final_ln": torch.zeros((d,), dtype=pdtype, device=gen.device),
        }
        if not cfg.tie_embeddings:
            tree["unembed"] = init_dense(gen, (d, cfg.vocab_size), pdtype)
        if fam == "ssm":
            tree["layers"] = [init_rwkv(gen, cfg, pdtype) for _ in range(cfg.n_layers)]
        elif fam == "hybrid":
            tree["layers"] = init_hybrid(gen, cfg, pdtype)
        else:
            for (name,), depth in layer_stacks(cfg).items():
                kind = layer_kind if name == "layers" else "dense"
                tree[name] = init_stack(gen, cfg, depth, pdtype, kind=kind,
                                        d_ff=cfg.moe.dense_d_ff if name == "dense_layers"
                                        else None)
        if moe and cfg.mtp:
            tree["mtp"] = {
                "proj": init_dense(gen, (2 * d, d), pdtype),
                "ln_h": torch.zeros((d,), dtype=pdtype, device=gen.device),
                "ln_e": torch.zeros((d,), dtype=pdtype, device=gen.device),
                "block": init_block(gen, cfg, pdtype, kind="moe"),
                "final_ln": torch.zeros((d,), dtype=pdtype, device=gen.device),
            }
        return DecoderLM(cfg, tree)

    def _cast(params: DecoderLM) -> dict:
        """The float parameters in the compute dtype (storage stays
        param_dtype): a copy each call unless the two dtypes are equal.
        Differentiable: the copy's gradient comes back to the parameter in
        its dtype, as JAX's ``astype`` cotangent does (with tied embeddings
        the gather's and the head's gradients add on the copy first)."""
        return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p, params.tree())

    def _embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
        return p["embed"]["embedding"][tokens]

    def _head(p: dict, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, p["final_ln"], cfg.norm_eps)
        w = p["embed"]["embedding"].T if cfg.tie_embeddings else p["unembed"]
        return x @ w

    def _tokens(t) -> torch.Tensor:
        return torch.as_tensor(t, device=dev).long()

    def _frontend(a) -> torch.Tensor:
        """Stubbed frames or patches (host or device arrays) on the device
        in the compute dtype."""
        return torch.as_tensor(a, device=dev).to(dtype)

    def _backbone(p: dict, x: torch.Tensor, positions: torch.Tensor, *, cache=None,
                  cache_pos=None, cross_kv=None):
        """(hidden, the MoE blocks' summed aux loss; 0 for the others)."""
        if fam == "ssm":
            remat = cache is None and cfg.remat and torch.is_grad_enabled()
            for i, layer in enumerate(p["layers"]):
                if remat:
                    x, _ = checkpoint(rwkv_block, layer, x, cfg, use_reentrant=False)
                else:
                    x, _ = rwkv_block(layer, x, cfg, cache=None if cache is None else
                                      {n: c[i] for n, c in cache.items()})
            return x, torch.zeros((), dtype=torch.float32, device=x.device)
        if fam == "hybrid":
            x, _ = hybrid_forward(p["layers"], x, positions, cfg, cache=cache,
                                  cache_pos=cache_pos)
            return x, torch.zeros((), dtype=torch.float32, device=x.device)
        if not moe:
            return stack_forward(p["layers"], x, positions, cfg, kind=layer_kind, cache=cache,
                                 cache_pos=cache_pos, cross_kv=cross_kv)
        if "dense_layers" in p:
            x, _ = stack_forward(p["dense_layers"], x, positions, cfg, kind="dense",
                                 cache=None if cache is None else cache["dense"],
                                 cache_pos=cache_pos)
        return stack_forward(p["layers"], x, positions, cfg, kind="moe",
                             cache=None if cache is None else cache["moe"], cache_pos=cache_pos)

    def _mtp_loss(p: dict, h: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """DeepSeek-V3 depth-1 MTP: predict t + 2 from (h_t, emb_{t+1}),
        through the top-level ``final_ln`` and head (``mtp.final_ln`` is a
        parameter that nothing reads, as in the reference)."""
        mp = p["mtp"]
        inputs, nxt, tgt = tokens[:, :-2], tokens[:, 1:-1], tokens[:, 2:]
        h = h[:, : inputs.shape[1]]
        z = torch.cat([rms_norm(h, mp["ln_h"], cfg.norm_eps),
                       rms_norm(_embed(p, nxt), mp["ln_e"], cfg.norm_eps)], dim=-1) @ mp["proj"]
        z, _ = block_forward(mp["block"], z, torch.arange(z.shape[1], device=dev), cfg,
                             kind="moe")
        return _cross_entropy(_head(p, z), tgt)

    def _inputs(p: dict, batch: dict, x: torch.Tensor):
        """The text's embeddings ``x`` [B, S, D] with the batch's frontend:
        for the vlm family the patches placed before them, for the audio
        family the sinusoid added and the encoder's cross K/V.  Returns (x,
        cross_kv or None)."""
        if fam == "vlm":
            return torch.cat([_frontend(batch["patches"]), x], dim=1), None
        if fam == "audio":
            cross_kv = _cross_kv_layers(cfg, p, _encoder(cfg, p, _frontend(batch["frames"])))
            pos = torch.arange(x.shape[1], device=dev)
            return x + _sinusoid(pos, cfg.d_model, dtype)[None], cross_kv
        return x, None

    def loss_fn(params: DecoderLM, batch: dict):
        """(loss, metrics): the next-token cross-entropy of ``batch["tokens"]``
        [B, S + 1] over S positions (with ``batch["patches"]`` before them
        for the vlm family, whose P patch positions carry label 0 and mask
        0, so the mean is over the S text positions; with
        ``batch["frames"]`` through the encoder for the audio family);
        metrics ``lm_loss`` and ``loss``, and for the MoE family
        ``aux_loss`` (and ``mtp_loss`` when ``cfg.mtp``)."""
        p = _cast(params)
        tokens = _tokens(batch["tokens"])
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        x, cross_kv = _inputs(p, batch, _embed(p, inputs))
        mask = None
        if fam == "vlm":
            n = x.shape[1] - inputs.shape[1]
            labels = torch.cat([labels.new_zeros((labels.shape[0], n)), labels], dim=1)
            mask = torch.cat([torch.zeros((labels.shape[0], n), device=dev),
                              torch.ones(inputs.shape, device=dev)], dim=1)
        positions = torch.arange(x.shape[1], device=dev)
        h, aux = _backbone(p, x, positions, cross_kv=cross_kv)
        loss = _cross_entropy(_head(p, h), labels, mask)
        metrics = {"lm_loss": loss}
        if moe:
            metrics["aux_loss"] = aux
            loss = loss + cfg.moe.aux_loss_weight * aux
            if cfg.mtp:
                mtp_loss = _mtp_loss(p, h, tokens)
                metrics["mtp_loss"] = mtp_loss
                loss = loss + cfg.mtp_loss_weight * mtp_loss
        metrics["loss"] = loss
        return loss, metrics

    @torch.no_grad()
    def prefill(params: DecoderLM, batch: dict) -> torch.Tensor:
        """Full-context forward; returns the last position's logits [B, V]
        (vlm: over ``[patches ; tokens]``; audio: the tokens attending to
        the encoded ``batch["frames"]``)."""
        p = _cast(params)
        x, cross_kv = _inputs(p, batch, _embed(p, _tokens(batch["tokens"])))
        h, _ = _backbone(p, x, torch.arange(x.shape[1], device=dev), cross_kv=cross_kv)
        return _head(p, h[:, -1:, :])[:, 0]

    @torch.no_grad()
    def decode_step(params: DecoderLM, cache: dict, token, pos):
        """One token with a filled cache; token [B], pos [B] (host arrays
        or tensors).  Writes the cache in place; returns (logits, cache)."""
        p = _cast(params)
        token, pos = _tokens(token), _tokens(pos)
        x = _embed(p, token[:, None])
        if fam == "audio":
            x = x + _sinusoid(pos[:, None], cfg.d_model, dtype)
            h, _ = _backbone(p, x, pos[:, None], cache=cache["self"], cache_pos=pos,
                             cross_kv=cache["cross"])
        else:
            h, _ = _backbone(p, x, pos[:, None], cache=cache, cache_pos=pos)
        return _head(p, h)[:, 0], cache

    def init_cache(batch: int, seq: int) -> dict:
        """Zeros on the model's device: see :func:`_init_cache`."""
        return _init_cache(batch, seq, dev)

    def _init_cache(batch: int, seq: int, device: torch.device) -> dict:
        """Zeros, each leaf in its reference dtype: the stacked per-layer
        cache, ``{k, v}`` ([L, batch, seq, Hkv, dh]) or MLA's latent ``{ckv
        [L, batch, seq, r], krope [L, batch, seq, dr]}`` in the compute
        dtype; for the MoE family ``{"dense": the first dense layers' or
        None, "moe": the MoE layers'}``; for the audio family ``{"self":
        {k, v}, "cross": (k, v) [L, batch, n_frames, Hkv, dh]}``, all in the
        compute dtype; for the ssm family RWKV's
        recurrent ``{state [L, batch, H, P, P] float32, x_time, x_chan [L,
        batch, D]}``; for the hybrid family ``{"ssm": {state [L, batch, H,
        N, P] float32, conv [L, batch, W - 1, d_inner]}, "shared": {k, v}
        [apps, batch, seq, Hkv, dh] or ()}``."""
        if fam == "hybrid":
            return init_hybrid_cache(cfg, batch, seq, dtype, device=device)
        if fam == "ssm":
            layer = init_rwkv_cache(cfg, batch, dtype, device="meta")
        else:
            one = init_mla_cache if cfg.attention == "mla" else init_kv_cache
            layer = one(cfg, batch, seq, dtype, device="meta")
        if fam == "audio":
            shape = (cfg.n_layers, batch, cfg.enc_dec.n_frames, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            return {"self": stacked_cache(cfg.n_layers, layer, device),
                    "cross": tuple(torch.zeros(shape, dtype=dtype, device=device)
                                   for _ in range(2))}
        if not moe:
            return stacked_cache(cfg.n_layers, layer, device)
        stacks = layer_stacks(cfg)
        return {"dense": stacked_cache(stacks[("dense_layers",)], layer, device)
                if ("dense_layers",) in stacks else None,
                "moe": stacked_cache(stacks[("layers",)], layer, device)}

    def input_specs(shape: ShapeConfig) -> dict:
        """The step's abstract inputs for a shape cell, meta tensors of the
        reference's shapes and dtypes whatever the model's device: for
        train ``tokens`` [B, text + 1] int32, for prefill [B, text] (text =
        :func:`_text_len`), each with the frontend's stub (vlm ``patches``,
        audio ``frames``); for decode the cache of capacity S
        (``init_cache(B, S)`` on the abstract path) and ``token``, ``pos``
        [B] int32."""
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"cache": _init_cache(b, s, META),
                    "token": torch.empty((b,), dtype=torch.int32, device=META),
                    "pos": torch.empty((b,), dtype=torch.int32, device=META)}
        n = _text_len(s) + (1 if shape.kind == "train" else 0)
        return {"tokens": torch.empty((b, n), dtype=torch.int32, device=META),
                **_frontend_specs(b)}

    def _text_len(s: int) -> int:
        """The text's share of a sequence of S positions: S less the vlm
        family's patches, S for the others."""
        return s - cfg.vlm.n_patches if fam == "vlm" else s

    def _frontend_specs(b: int) -> dict:
        if fam == "vlm":
            return {"patches": torch.empty((b, cfg.vlm.n_patches, cfg.d_model), dtype=dtype,
                                           device=META)}
        if fam == "audio":
            return {"frames": torch.empty((b, cfg.enc_dec.n_frames, cfg.d_model), dtype=dtype,
                                          device=META)}
        return {}

    return SimpleNamespace(cfg=cfg, device=dev, init=init, loss_fn=loss_fn, prefill=prefill,
                           decode_step=decode_step, init_cache=init_cache,
                           input_specs=input_specs)
