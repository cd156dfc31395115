"""Mixture-of-Experts FFN with capacity-limited routing: port of the
no-mesh path of ``repro/models/moe.py``.

Routers: ``softmax`` (DeepSeek-V2: softmax, then top-k, with the aux
load-balance loss) and ``sigmoid_bias`` (DeepSeek-V3: sigmoid scores, the
top-k chosen on the scores plus a bias that only the trainer moves).  Each
expert takes at most ``capacity`` tokens, the ones with the largest
combine weights; the rest of its tokens are dropped.  The capacity counts
every row of the batch, idle serving slots included, as the reference's
does.

Under an active mesh the reference takes an expert-parallel ``shard_map``
branch (each device gathers the tokens of its own experts, one psum
combines).  The port has no such mesh yet: that branch comes with
multi-device training (ROADMAP.md §1 item 2, slice 2b), and this module
runs the local branch.

Every top-k here breaks ties by index, lower first, as ``lax.top_k``
does (``torch.topk`` makes no such promise): identical rows and the zero
gates of an under-full expert tie exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import init_dense, swiglu


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    """The reference's MoE parameters: the router's ``w [d, E]`` and
    ``bias [E]`` in float32 whatever ``dtype`` is, the experts ``[E, d, f]``
    / ``[E, f, d]`` and the shared SwiGLU."""
    m = cfg.moe
    d = cfg.d_model
    shared_ff = m.shared_d_ff or m.n_shared * m.expert_d_ff
    return {
        "router": {"w": init_dense(gen, (d, m.n_experts), torch.float32),
                   "bias": torch.zeros((m.n_experts,), dtype=torch.float32, device=gen.device)},
        "experts": {
            "w1": init_dense(gen, (m.n_experts, d, m.expert_d_ff), dtype),
            "w3": init_dense(gen, (m.n_experts, d, m.expert_d_ff), dtype),
            "w2": init_dense(gen, (m.n_experts, m.expert_d_ff, d), dtype,
                             scale=m.expert_d_ff**-0.5 / (2 * cfg.n_layers) ** 0.5),
        },
        "shared": {
            "w1": init_dense(gen, (d, shared_ff), dtype),
            "w3": init_dense(gen, (d, shared_ff), dtype),
            "w2": init_dense(gen, (shared_ff, d), dtype,
                             scale=shared_ff**-0.5 / (2 * cfg.n_layers) ** 0.5),
        },
    }


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, in
    descending order, equal values lower index first (``lax.top_k``'s
    order): a stable descending sort, cut to k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, router_bias: torch.Tensor,
           cfg: ArchConfig):
    """The routing decision over all E experts: (weights [t, k], idx
    [t, k], probs [t, E]), in float32.  The router weight arrives in the
    compute dtype (the model casts every parameter) and multiplies
    ``x_flat`` in float32."""
    m = cfg.moe
    logits = x_flat.float() @ router_w.float()
    if m.router == "sigmoid_bias":
        scores = torch.sigmoid(logits)
        _, idx = top_k(scores + router_bias[None, :], m.top_k)
        w = torch.take_along_dim(scores, idx, dim=1)
        probs = scores
    else:
        probs = torch.softmax(logits, dim=1)
        w, idx = top_k(probs, m.top_k)
    if m.norm_topk_prob:
        w = w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-20)
    return w, idx, probs


def _gate_matrix(weights: torch.Tensor, idx: torch.Tensor, e_offset: int,
                 e_loc: int) -> torch.Tensor:
    """[t, E_loc] combine-weight matrix for the expert range
    ``e_offset .. e_offset + E_loc`` (0 where a token is not routed)."""
    local = idx[..., None] - e_offset                                   # [t, k, 1]
    onehot = (local == torch.arange(e_loc, device=idx.device)).to(weights.dtype)
    return torch.einsum("tk,tke->te", weights, onehot)


def _routed_ffn_local(x_flat: torch.Tensor, gate: torch.Tensor, w1: torch.Tensor,
                      w3: torch.Tensor, w2: torch.Tensor, capacity: int) -> torch.Tensor:
    """Each expert's ``min(capacity, t)`` tokens of largest gate (ties to
    the lower token index) gathered, through its SwiGLU, weighted by the
    gate and scatter-added back into a tensor of ``x_flat``'s dtype.  The
    scatter-add is an accumulating ``index_put``, which on the card sorts
    the indices and sums each row's terms in a fixed order (``index_add``
    adds them atomically, in no fixed order): the same inputs give the
    same bits.

    x_flat [t, d]; gate [t, E_loc]; expert weights [E_loc, d, f] /
    [E_loc, f, d]."""
    c = min(capacity, x_flat.shape[0])
    sel_w, sel_idx = top_k(gate.T, c)                                   # [E_loc, C]
    x_sel = x_flat[sel_idx]                                             # [E_loc, C, d]
    h = F.silu(torch.bmm(x_sel, w1)) * torch.bmm(x_sel, w3)
    y = torch.bmm(h, w2) * sel_w[..., None].to(x_flat.dtype)
    return torch.zeros_like(x_flat).index_put((sel_idx.reshape(-1),),
                                              y.reshape(-1, x_flat.shape[1]), accumulate=True)


def moe_block(params, x: torch.Tensor, cfg: ArchConfig):
    """Returns (out, aux) with aux = {``aux_loss`` (float32 scalar),
    ``expert_load`` [E]}: the shared SwiGLU plus the routed experts at
    capacity ``max(1, int(t * top_k / E * capacity_factor))`` over all
    ``t = B * S`` rows."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    shared_out = swiglu(x, **params["shared"])
    capacity = max(1, int(t * m.top_k / m.n_experts * m.capacity_factor))
    x_flat = x.reshape(-1, d)
    router, ex = params["router"], params["experts"]
    weights, idx, probs = _route(x_flat, router["w"], router["bias"], cfg)
    gate = _gate_matrix(weights, idx, 0, m.n_experts)
    y = _routed_ffn_local(x_flat, gate, ex["w1"], ex["w3"], ex["w2"], capacity).reshape(b, s, d)
    # the mean of idx's one-hot rows, as XLA takes it: the count times
    # 1 / (t k); counted on the device (bincount reads the maximum back)
    flat = idx.reshape(-1)
    count = torch.zeros(m.n_experts, device=x.device).index_put_(
        (flat,), torch.ones(flat.shape, device=x.device), accumulate=True)
    load = count * (1.0 / flat.numel()) * m.n_experts
    imp = torch.mean(probs, dim=0)
    aux = m.n_experts * torch.sum(load / m.n_experts * imp)
    return shared_out + y.to(x.dtype), {"aux_loss": aux.float(), "expert_load": load}
