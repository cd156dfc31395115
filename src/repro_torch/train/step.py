"""Generic train_step over a model and an optimizer: port of
``repro/train/step.py``, on one device or on a data x model mesh.

Microbatch gradient accumulation (``cfg.grad_accum``): the global batch is
split into microbatches run one after the other, so live activations scale
with the microbatch while the optimizer sees the full-batch gradient.  Each
microbatch's gradient is added into an accumulator in
``cfg.optimizer_dtype`` (bf16 when the moments are bf16), as the reference
adds it: ``acc + g.to(acc_dtype) / n``.  The gradients come from
``torch.autograd.grad``, so no ``.grad`` accumulates in float32 between
the backward passes.

Each microbatch runs its data shards one after the other: one shard, on
the model's device, without a mesh.  On a mesh (``launch.mesh.DeviceMesh``,
as the reference's step runs under ``use_mesh_rules``) the step is
single-controller:

* the global batch is cut into microbatches first and each microbatch's
  rows into the data shards' blocks second, the order in which GSPMD
  splits the reference's reshaped batch;
* data shard d runs the forward and the backward of its rows on its
  devices (the model axis's blocks: tensor-parallel attention and SwiGLU,
  the expert-parallel MoE block; every other layer on the shard's first
  model device) under ``sharding.use_shard``;
* each microbatch's per-shard gradients are psum'd over the data axis in
  float32, in rank order, and scaled to the mean; only then are they
  accumulated as above (one shard keeps its gradients' own dtype);
* the parameters and the optimizer state are replicated over the data
  axis (the reference's trainer jits with no parameter shardings: no
  FSDP at run time), one replica a distinct device.  Where the shards
  share a card the replicas are one tensor, updated once; replicas on
  separate cards take the same update and stay equal bit for bit
  (``train_step.replicas()`` gives them after a step).

A MoE model whose mesh does not take the expert-parallel branch routes
over the whole batch in the reference (the capacity and each expert's
top-c selection couple the rows), so its step keeps the batch on data
shard 0.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed.collectives import count_bytes, same_device
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, ShardScope, active_rules, batch_coords, shard_group, use_mesh_rules,
    use_shard,
)
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_update, init_adamw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def make_train_step(model, opt_cfg: AdamWConfig, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for a model from ``build_model``: ``params`` (a DecoderLM,
    made trainable here) and the state are updated in place; ``batch``
    holds host or device arrays of a leading batch axis divisible by
    ``cfg.grad_accum`` (times the data shards on a mesh).  Metrics: the
    loss's (mean over microbatches), ``grad_norm``, ``lr`` and
    ``loss_mean``; all but ``lr`` stay on the device.  With ``mesh`` (a
    ``DeviceMesh`` whose data shard 0 lives on the model's device), the
    sharded step of the module docstring, under the active mesh rules (or
    ``DEFAULT_RULES`` when none are active for ``mesh``)."""
    from repro_torch.models.model import build_model

    n_micro = max(1, model.cfg.grad_accum)
    acc_dtype = getattr(torch, model.cfg.optimizer_dtype)
    rules, homes = _data_shards(model, mesh)
    n_data = len(homes)
    models = [model if same_device(h, model.device) else build_model(model.cfg, device=h)
              for h in homes]
    # one replica a distinct device; data shard d reads replica owner[d]
    distinct: list[torch.device] = []
    owner = []
    for h in homes:
        match = [i for i, e in enumerate(distinct) if same_device(h, e)]
        if not match:
            distinct.append(h)
        owner.append(match[0] if match else len(distinct) - 1)
    cache: dict = {"key": None, "replicas": []}

    def replicas(params, opt_state) -> list:
        """[(params, opt_state)] a distinct device, the first the caller's;
        the others copied from it when the caller's state is new (a fresh
        init or a restore), else kept from the last step."""
        if cache["key"] != (id(params), id(opt_state.m)):
            cache["replicas"] = [(params, opt_state)] + [
                (_params_to(params, dev), _state_to(opt_state, dev)) for dev in distinct[1:]]
        return cache["replicas"]

    def micro_grads(reps, trees, micro: dict):
        """(loss, metrics, gradients) of one microbatch: each data shard's
        forward and backward on its rows, the gradients summed over the
        data axis in float32 and scaled to the mean."""
        rows, rest = divmod(micro[next(iter(micro))].shape[0], n_data)
        if rest:
            raise ValueError(f"a microbatch of {rows * n_data + rest} rows over "
                             f"{n_data} data shards")
        total = None
        shard0: list = []
        losses, metricses = [], []
        for d in range(n_data):
            p, tree = reps[owner[d]][0], trees[owner[d]]
            scope = ShardScope(data=d, shard0=shard0)
            part = {k: v[d * rows:(d + 1) * rows].to(homes[d], non_blocking=True)
                    for k, v in micro.items()}
            with use_shard(scope):
                loss, metrics = models[d].loss_fn(p, part)
                scope.forward = False          # a remat recompute in the backward
                g = list(torch.autograd.grad(loss, tree_leaves(tree), allow_unused=True,
                                             materialize_grads=True))
            losses.append(loss.detach().to(homes[0], non_blocking=True))
            metricses.append({k: v.detach().to(homes[0], non_blocking=True)
                              for k, v in metrics.items()})
            if total is None:
                total = g if n_data == 1 else [t.float() for t in g]
            else:
                for j, t in enumerate(total):
                    count_bytes(2 * 4 * t.numel())  # the psum: into rank 0 and back
                    t.add_(g[j].float().to(t.device, non_blocking=True))
                    g[j] = None
            del g
        if n_data > 1:
            for t in total:                           # the data shards' own copies
                t.div_(n_data)
        return (*_mean_metrics(losses, metricses), total)

    def train_step(params, opt_state: AdamWState, batch: dict):
        with (contextlib.nullcontext() if rules is None or active_rules() == rules
              else use_mesh_rules(rules.mesh, rules.rules)):
            reps = replicas(params, opt_state)
            trees = []
            for p, _ in reps:
                p.requires_grad_(True)
                trees.append(p.reference_tree())
            micro = _micro_batches(batch, homes[0], n_micro)
            if n_micro == 1:
                loss, metrics, grads = micro_grads(reps, trees, {k: v[0] for k, v in micro.items()})
            else:
                grads = [torch.zeros(t.shape, dtype=acc_dtype, device=t.device)
                         for t in tree_leaves(trees[0])]
                losses, metricses = [], []
                for i in range(n_micro):
                    loss, metrics, g = micro_grads(reps, trees, {k: v[i] for k, v in micro.items()})
                    for j, acc in enumerate(grads):
                        acc.add_(g[j].to(acc_dtype) / n_micro)
                        g[j] = None                   # one leaf's gradient freed at a time
                    losses.append(loss)
                    metricses.append(metrics)
                loss, metrics = _mean_metrics(losses, metricses)
            updated = []
            for r, ((p, st), tree) in enumerate(zip(reps, trees)):
                g = grads if r == 0 else [t.to(distinct[r], non_blocking=True) for t in grads]
                p, st, opt_metrics = adamw_update(tree_unflatten_like(tree, g), st, p, opt_cfg)
                updated.append((p, st))
                if r == 0:
                    first_metrics = opt_metrics
            cache["replicas"] = updated
            cache["key"] = (id(updated[0][0]), id(updated[0][1].m))
        return (*updated[0], {**metrics, **first_metrics, "loss_mean": loss})

    train_step.replicas = lambda: list(cache["replicas"])
    return train_step


def _data_shards(model, mesh):
    """(the mesh rules or None, each data shard's first device): one shard
    on the model's device without a mesh."""
    if mesh is None:
        return None, [model.device]
    cfg = model.cfg
    current = active_rules()
    with (contextlib.nullcontext() if current is not None and current.mesh == mesh
          else use_mesh_rules(mesh, DEFAULT_RULES)):
        rules = active_rules()
        # a local-branch MoE block couples every row of the batch
        split = cfg.family != "moe" or shard_group("experts", cfg.moe.n_experts) is not None
        homes = [mesh.device(**batch_coords(d))
                 for d in range(rules.size("batch") if split else 1)]
    if not same_device(homes[0], model.device):
        raise ValueError(f"the model lives on {model.device}, the mesh's data shard 0 on "
                         f"{homes[0]}")
    return rules, homes


def _micro_batches(batch: dict, device, n_micro: int) -> dict:
    """The batch on ``device``, each array ``[n_micro, B / n_micro, ...]``."""
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    return {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:]) for k, v in batch.items()}


def _mean_metrics(losses: list, metricses: list):
    return (torch.mean(torch.stack(losses)),
            {k: torch.mean(torch.stack([m[k] for m in metricses]), dim=0) for k in metricses[0]})


def _params_to(params, device):
    """A DecoderLM replica on ``device``: its parameters copied."""
    return type(params)(params.cfg, tree_map(lambda t: t.detach().to(device), params.tree()))


def _state_to(state: AdamWState, device) -> AdamWState:
    return AdamWState(step=state.step, m=tree_map(lambda t: t.to(device), state.m),
                      v=tree_map(lambda t: t.to(device), state.v))


def make_opt_init(model, opt_cfg: AdamWConfig):
    def opt_init(params):
        return init_adamw(params, opt_cfg)

    return opt_init


def opt_config_for(cfg) -> AdamWConfig:
    return AdamWConfig(moment_dtype=cfg.optimizer_dtype, factored=cfg.optimizer_factored)
