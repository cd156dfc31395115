"""Generic train_step over a model and an optimizer: port of
``repro/train/step.py``.

Microbatch gradient accumulation (``cfg.grad_accum``): the global batch is
split into microbatches run one after the other, so live activations scale
with the microbatch while the optimizer sees the full-batch gradient.  Each
microbatch's gradient is added into an accumulator in
``cfg.optimizer_dtype`` (bf16 when the moments are bf16), as the reference
adds it: ``acc + g.to(acc_dtype) / n``.  The gradients come from
``torch.autograd.grad``, so no ``.grad`` accumulates in float32 between
the backward passes.
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_update, init_adamw
from repro_torch.tree import tree_leaves, tree_unflatten_like


def make_train_step(model, opt_cfg: AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for a model from ``build_model``: ``params`` (a DecoderLM,
    made trainable here) and the state are updated in place; ``batch``
    holds host or device arrays of a leading batch axis divisible by
    ``cfg.grad_accum``.  Metrics: the loss's (mean over microbatches),
    ``grad_norm``, ``lr`` and ``loss_mean``; all but ``lr`` stay on the
    device."""
    n_micro = max(1, model.cfg.grad_accum)
    acc_dtype = getattr(torch, model.cfg.optimizer_dtype)

    def grads_of(params, tree, batch):
        """(loss, metrics, gradients of tree's leaves in order).  A leaf
        the loss never reads (the softmax router's bias, the sigmoid
        router's bias, which reaches the loss through top-k indices alone,
        ``mtp.final_ln``) gets a zero gradient, as JAX gives it: AdamW
        still decays it and its moments."""
        loss, metrics = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(tree), allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state: AdamWState, batch: dict):
        params.requires_grad_(True)
        tree = params.reference_tree()
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        if n_micro == 1:
            loss, metrics, grads = grads_of(params, tree, batch)
        else:
            micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
                     for k, v in batch.items()}
            grads = [torch.zeros(t.shape, dtype=acc_dtype, device=t.device)
                     for t in tree_leaves(tree)]
            losses, metricses = [], []
            for i in range(n_micro):
                loss, metrics, g = grads_of(params, tree, {k: v[i] for k, v in micro.items()})
                g = list(g)
                for j, acc in enumerate(grads):
                    acc.add_(g[j].to(acc_dtype) / n_micro)
                    g[j] = None                       # one leaf's gradient freed at a time
                losses.append(loss)
                metricses.append(metrics)
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in metricses]), dim=0)
                       for k in metricses[0]}
        params, opt_state, opt_metrics = adamw_update(
            tree_unflatten_like(tree, list(grads)), opt_state, params, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics, "loss_mean": loss}

    return train_step


def make_opt_init(model, opt_cfg: AdamWConfig):
    def opt_init(params):
        return init_adamw(params, opt_cfg)

    return opt_init


def opt_config_for(cfg) -> AdamWConfig:
    return AdamWConfig(moment_dtype=cfg.optimizer_dtype, factored=cfg.optimizer_factored)
