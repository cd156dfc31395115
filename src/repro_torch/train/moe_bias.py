"""Aux-loss-free MoE load balancing (DeepSeek-V3, arXiv:2408.15664): port of
``repro/train/moe_bias.py``.

The router bias is a *non-trainable* parameter adjusted from observed
expert load: overloaded experts get their selection bias decreased,
underloaded ones increased.  Applied between optimizer steps for
``router='sigmoid_bias'`` archs (the bias enters top-k selection only, so
this is gradient-free).  It works on a tree, such as a
``DecoderLM.reference_tree()`` of the MoE family (``models/moe.py``).
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves_with_path, tree_unflatten_like


def update_router_bias(params, expert_load: torch.Tensor, rate: float = 1e-3):
    """expert_load: [E] mean load (1.0 == perfectly balanced).

    Returns params with every ``router/bias`` leaf nudged by
    ``-rate * sign(load - 1)`` (stacked [L, E] biases accept [E] or [L, E]
    load); the other leaves are the same objects."""
    def visit(path, leaf):
        if "/".join(path).endswith("router/bias"):
            err = torch.sign(expert_load.float() - 1.0)
            return (leaf.float() - rate * err).to(leaf.dtype)
        return leaf

    return tree_unflatten_like(params, [visit(p, leaf)
                                        for p, leaf in tree_leaves_with_path(params)])
