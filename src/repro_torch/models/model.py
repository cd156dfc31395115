"""Top-level model API: ``build_model(cfg)`` -> init / loss / prefill /
decode: port of ``repro/models/model.py`` for the dense family.

    model = build_model(get_config("deepseek_7b"))          # on cuda
    params = model.init(torch.Generator("cuda").manual_seed(0))
    loss, metrics = model.loss_fn(params, {"tokens": tokens})   # tokens [B, S + 1]
    logits = model.prefill(params, {"tokens": tokens})      # [B, V], last position
    cache = model.init_cache(batch, seq)
    logits, cache = model.decode_step(params, cache, token, pos)

``build_model`` returns the reference's namespace (``cfg``, ``init``,
``loss_fn``, ``prefill``, ``decode_step``, ``init_cache``, plus ``device``),
so ``serve.engine.ServeEngine`` and ``train.trainer.Trainer`` read the same
in both packages.  ``params`` is a :class:`DenseLM`: an ``nn.Module``
holding the reference's parameter tree as ``nn.Parameter`` objects in
``param_dtype``.  Every call casts the float parameters to
``compute_dtype`` (as the reference does) and embeds from the cast table;
``prefill`` and ``decode_step`` run under ``torch.no_grad``, ``loss_fn``
differentiates back through the cast to the stored parameters.
``_mtp_loss`` comes with the MoE family, ``input_specs`` with the dry-run
launcher; the other families raise ``NotImplementedError`` (ROADMAP.md §1
item 2).
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import init_dense, rms_norm
from repro_torch.models.transformer import init_stack, stack_forward
from repro_torch.tree import Stacked, tree_map

NOT_PORTED = {
    "moe": "ROADMAP.md §1 item 2, slice 3 (the other families: mla, moe)",
    "ssm": "ROADMAP.md §1 item 2, slice 3 (the other families: rwkv, ssm)",
    "hybrid": "ROADMAP.md §1 item 2, slice 3 (the other families: ssm)",
    "audio": "ROADMAP.md §1 item 2, slice 3 (the other families: audio cross-attention)",
    "vlm": "ROADMAP.md §1 item 2, slice 3 (the other families: vlm patches)",
}


class _Block(nn.Module):
    """One layer's parameters, under the reference's names."""

    def __init__(self, tree: dict):
        super().__init__()
        self.ln1 = nn.Parameter(tree["ln1"])
        self.attn = nn.ParameterDict(tree["attn"])
        self.ln2 = nn.Parameter(tree["ln2"])
        self.mlp = nn.ParameterDict(tree["mlp"])

    def tree(self) -> dict:
        return {"ln1": self.ln1, "attn": dict(self.attn), "ln2": self.ln2,
                "mlp": dict(self.mlp)}


class DenseLM(nn.Module):
    """The dense decoder's parameters as a module.  Built from the
    reference's tree (``embed.embedding [V, D]``, ``final_ln [D]``,
    ``unembed [D, V]`` unless tied, ``layers`` a list of block dicts with
    ``[in, out]`` weights, or the scanned layout: one block dict whose
    leaves are ``[L, ...]`` tensors or :class:`~repro_torch.tree.Stacked`);
    :meth:`tree` gives it back with a list of layers, :meth:`reference_tree`
    in the reference's own layout.  Not called itself: ``build_model``'s
    functions take it as ``params``.  The parameters are frozen
    (``requires_grad=False``) until a caller trains them:
    ``params.requires_grad_(True)``, as ``train.step``'s step does."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        layers = tree["layers"]
        if isinstance(layers, dict):
            layers = [tree_map(lambda a, i=i: a[i], layers,
                               is_leaf=lambda x: isinstance(x, Stacked))
                      for i in range(cfg.n_layers)]
        self.embedding = nn.Parameter(tree["embed"]["embedding"])
        self.final_ln = nn.Parameter(tree["final_ln"])
        self.unembed = None if cfg.tie_embeddings else nn.Parameter(tree["unembed"])
        self.layers = nn.ModuleList(_Block(layer) for layer in layers)
        self.requires_grad_(False)

    def tree(self) -> dict:
        out = {"embed": {"embedding": self.embedding}, "final_ln": self.final_ln,
               "layers": [layer.tree() for layer in self.layers]}
        if self.unembed is not None:
            out["unembed"] = self.unembed
        return out

    def reference_tree(self) -> dict:
        """The tree in the reference's layout: with ``cfg.scan_layers``,
        ``layers`` is one block dict whose leaves are ``Stacked`` (the L
        per-layer parameters of each stacked leaf); else the list.  The
        optimizer's state and the checkpoints follow this layout."""
        out = self.tree()
        if self.cfg.scan_layers:
            out["layers"] = tree_map(lambda *ps: Stacked(ps), *out["layers"])
        return out

    # a checkpoint saves the reference's layout (Stacked leaves are stacked
    # on the host) and restores a new module from it
    checkpoint_tree = reference_tree

    def from_checkpoint_tree(self, tree: dict) -> DenseLM:
        return DenseLM(self.cfg, tree)


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


def build_model(cfg: ArchConfig, device=None) -> SimpleNamespace:
    """The dense family's training and serving functions on ``device``
    (default cuda)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: {NOT_PORTED[cfg.family]}")
    dev = resolve_device(device)
    dtype = cfg.cdtype()
    pdtype = cfg.pdtype()

    def init(gen: torch.Generator) -> DenseLM:
        """Fresh parameters drawn from ``gen``, which must live on the
        model's device: embedding, unembed, then each layer in order."""
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        tree = {
            "embed": {"embedding": init_dense(gen, (cfg.vocab_size, cfg.d_model), pdtype,
                                              scale=1.0)},
            "final_ln": torch.zeros((cfg.d_model,), dtype=pdtype, device=gen.device),
        }
        if not cfg.tie_embeddings:
            tree["unembed"] = init_dense(gen, (cfg.d_model, cfg.vocab_size), pdtype)
        tree["layers"] = init_stack(gen, cfg, pdtype)
        return DenseLM(cfg, tree)

    def _cast(params: DenseLM) -> dict:
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

    def loss_fn(params: DenseLM, batch: dict):
        """(loss, metrics): the next-token cross-entropy of ``batch["tokens"]``
        [B, S + 1] over S positions; metrics ``lm_loss`` and ``loss``."""
        if cfg.mtp:
            raise NotImplementedError(
                "the MTP loss runs the MoE block: ROADMAP.md §1 item 2, slice 3 (the "
                "other families: moe)")
        p = _cast(params)
        tokens = _tokens(batch["tokens"])
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        x = _embed(p, inputs)
        positions = torch.arange(inputs.shape[1], device=dev)
        h = stack_forward(p["layers"], x, positions, cfg)
        loss = _cross_entropy(_head(p, h), labels)
        return loss, {"lm_loss": loss, "loss": loss}

    @torch.no_grad()
    def prefill(params: DenseLM, batch: dict) -> torch.Tensor:
        """Full-context forward; returns the last position's logits [B, V]."""
        p = _cast(params)
        tokens = _tokens(batch["tokens"])
        s = tokens.shape[1]
        x = _embed(p, tokens)
        positions = torch.arange(s, device=dev)
        h = stack_forward(p["layers"], x, positions, cfg)
        return _head(p, h[:, -1:, :])[:, 0]

    @torch.no_grad()
    def decode_step(params: DenseLM, cache: dict, token, pos):
        """One token with a filled KV cache; token [B], pos [B] (host arrays
        or tensors).  Writes the cache in place; returns (logits, cache)."""
        p = _cast(params)
        token, pos = _tokens(token), _tokens(pos)
        x = _embed(p, token[:, None])
        h = stack_forward(p["layers"], x, pos[:, None], cfg, cache=cache, cache_pos=pos)
        return _head(p, h)[:, 0], cache

    def init_cache(batch: int, seq: int) -> dict:
        """The stacked cache ``{k, v}``: [L, batch, seq, Hkv, dh] zeros in
        the compute dtype."""
        shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    return SimpleNamespace(cfg=cfg, device=dev, init=init, loss_fn=loss_fn, prefill=prefill,
                           decode_step=decode_step, init_cache=init_cache)
