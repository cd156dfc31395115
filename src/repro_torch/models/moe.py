"""Mixture-of-Experts FFN with capacity-limited routing and expert
parallelism: port of ``repro/models/moe.py``.

Routers: ``softmax`` (DeepSeek-V2: softmax, then top-k, with the aux
load-balance loss) and ``sigmoid_bias`` (DeepSeek-V3: sigmoid scores, the
top-k chosen on the scores plus a bias that only the trainer moves).  Each
expert takes at most ``capacity`` tokens, the ones with the largest
combine weights; the rest of its tokens are dropped.  The capacity counts
every row of the batch, idle serving slots included, as the reference's
does.

Under active mesh rules whose ``experts`` axis (the model axis) has more
than one device and divides E, the block is expert-parallel, as the
reference's ``shard_map`` branch: each data shard routes its own tokens
with the whole router, model shard m holds experts ``m*E_loc ..
(m+1)*E_loc`` on its device and gathers (up to capacity) the tokens
routed to them, and one psum over the model axis combines.  The capacity
counts the data shard's rows (``t_local = t // dp``), so tokens that the
local branch keeps may be dropped: EP changes results, as in the
reference.  ``aux_loss`` and ``expert_load`` are data shard 0's, as the
reference's ``out_specs=P()`` returns them; the aux loss's gradient is the
mean of every data shard's, as the reference's transpose gives it.  The
shared experts are an ordinary SwiGLU, tensor-parallel when the mesh
splits ``ffn``.

Every top-k here breaks ties by index, lower first, as ``lax.top_k``
does (``torch.topk`` makes no such promise): identical rows and the zero
gates of an under-full expert tie exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import broadcast, reduce_sum
from repro_torch.distributed.sharding import (
    ShardScope, active_rules, current_shard, shard_group, use_shard,
)
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


def _load_and_aux(idx: torch.Tensor, probs: torch.Tensor, cfg: ArchConfig):
    """(expert_load [E], aux_loss): the mean of idx's one-hot rows, as XLA
    takes it (the count times 1 / (t k), counted on the device: bincount
    reads the maximum back), and the load-balance loss."""
    m = cfg.moe
    flat = idx.reshape(-1)
    count = torch.zeros(m.n_experts, device=idx.device).index_put_(
        (flat,), torch.ones(flat.shape, device=idx.device), accumulate=True)
    load = count * (1.0 / flat.numel()) * m.n_experts
    imp = torch.mean(probs, dim=0)
    return load, m.n_experts * torch.sum(load / m.n_experts * imp)


def _capacity(t: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    return max(1, int(t * m.top_k / m.n_experts * m.capacity_factor))


def _moe_shard(x: torch.Tensor, router: dict, ex: dict, cfg: ArchConfig, group):
    """One data shard's routed experts, split over ``group`` (its model
    axis): (y [b, s, d], aux_loss, expert_load) of its rows alone."""
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    weights, idx, probs = _route(x_flat, router["w"], router["bias"], cfg)
    e_loc = cfg.moe.n_experts // group.size
    capacity = _capacity(b * s, cfg)
    parts = []
    blocks = [ex[w].split(e_loc, dim=0) for w in ("w1", "w3", "w2")]
    for m, (dev, xm) in enumerate(zip(group.devices, broadcast(group, x_flat))):
        gate = _gate_matrix(weights, idx, m * e_loc, e_loc).to(dev, non_blocking=True)
        w1, w3, w2 = (blk[m].to(dev, non_blocking=True) for blk in blocks)
        parts.append(_routed_ffn_local(xm, gate, w1, w3, w2, capacity))
    load, aux = _load_and_aux(idx, probs, cfg)
    return reduce_sum(parts, x.device).reshape(b, s, d), aux, load


def _moe_ep(params, x: torch.Tensor, cfg: ArchConfig):
    """The expert-parallel branch: (y, aux_loss, expert_load).  Inside the
    train step's :func:`use_shard` x is that data shard's rows; called
    outside one, x is the global batch and its rows are split over the
    data shards here."""
    router, ex = params["router"], params["experts"]
    scope = current_shard()
    if scope is not None:
        y, aux, load = _moe_shard(x, router, ex, cfg,
                                  shard_group("experts", cfg.moe.n_experts))
        if not scope.forward:                 # remat's recompute: the values go unread
            return y, aux, load
        if scope.data == 0:
            scope.shard0.append((aux.detach(), load))
            return y, aux, load
        aux0, load0 = scope.shard0[scope.cursor]
        scope.cursor += 1
        # shard 0's value, this shard's gradient (aux - aux.detach() is 0)
        return y, aux0.to(aux.device) + (aux - aux.detach()), load0.to(load.device)
    dp = active_rules().size("batch")
    outs = []
    for d, xd in enumerate(x.chunk(dp, dim=0)):
        with use_shard(ShardScope(data=d)):
            outs.append(_moe_shard(xd, router, ex, cfg,
                                   shard_group("experts", cfg.moe.n_experts)))
    y = torch.cat([o[0].to(x.device, non_blocking=True) for o in outs])
    aux_mean = sum(o[1].to(x.device, non_blocking=True) for o in outs) / dp
    return y, outs[0][1].detach() + (aux_mean - aux_mean.detach()), outs[0][2]


def moe_block(params, x: torch.Tensor, cfg: ArchConfig):
    """Returns (out, aux) with aux = {``aux_loss`` (float32 scalar),
    ``expert_load`` [E]}: the shared SwiGLU plus the routed experts.  The
    local branch's capacity is ``max(1, int(t * top_k / E *
    capacity_factor))`` over all ``t = B * S`` rows; the expert-parallel
    branch's (see the module docstring) counts a data shard's rows."""
    m = cfg.moe
    b, s, d = x.shape
    shared_out = swiglu(x, **params["shared"])
    if shard_group("experts", m.n_experts) is not None:
        y, aux, load = _moe_ep(params, x, cfg)
    else:
        x_flat = x.reshape(-1, d)
        router, ex = params["router"], params["experts"]
        weights, idx, probs = _route(x_flat, router["w"], router["bias"], cfg)
        gate = _gate_matrix(weights, idx, 0, m.n_experts)
        y = _routed_ffn_local(x_flat, gate, ex["w1"], ex["w3"], ex["w2"],
                              _capacity(b * s, cfg)).reshape(b, s, d)
        load, aux = _load_and_aux(idx, probs, cfg)
    return shared_out + y.to(x.dtype), {"aux_loss": aux.float(), "expert_load": load}
