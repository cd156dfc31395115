"""Build one (architecture x shape x mesh) dry-run cell: port of
``repro/launch/cell.py``.

Where the reference jits the sharded step and lowers it over
``jax.eval_shape``'s operands, a cell here holds the step function, its
abstract operands (meta tensors from ``build_model(cfg, device="meta")``)
and their resolved specs, ready for ``launch.cost`` to count, as the
reference's is ready to lower.  Nothing is allocated, compiled or launched.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, MeshRules, Spec, leaf_path, make_spec, params_shardings,
)
from repro_torch.launch.mesh import mesh_dp_size, mesh_tp_size
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import AdamWConfig, AdamWState
from repro_torch.train.step import make_opt_init, make_train_step, opt_config_for
from repro_torch.tree import tree_leaves_with_path, tree_unflatten_like


def cell_rules(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """Per-cell adjustments of the logical->physical axis rules.

    Resolves the cache sharding policy so no spec uses a mesh axis twice:
      batch shardable  -> cache: (batch over data, heads over model if they
                          divide, else sequence over model)
      batch unshardable (long_500k) -> SP: sequence over data (+ heads over
                          model when divisible)
    """
    rules = dict(DEFAULT_RULES)
    dp = mesh_dp_size(mesh)
    tp = mesh_tp_size(mesh)
    batch_ok = shape.global_batch % dp == 0
    heads_ok = cfg.n_kv_heads % tp == 0
    # Megatron-style sequence parallelism for the residual stream: the
    # layer carry (saved for backward) is sharded over the model axis
    if shape.kind in ("train", "prefill") and shape.seq_len % tp == 0:
        rules["seq"] = "model"
    if batch_ok:
        rules["kv_seq"] = None if heads_ok else "model"
    else:
        rules["batch"] = None
        rules["kv_seq"] = "data"
    if not heads_ok:
        rules["kv_heads"] = None
    # MLA latent caches have no head dim: always sequence-shard over model
    # when batch takes the data axes
    rules["latent_seq"] = ("model" if batch_ok else "data")
    return rules


def _ax_size(mesh, ax) -> int:
    if ax is None:
        return 1
    axes = (ax,) if isinstance(ax, str) else ax
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def cache_shardings(cache, cfg: ArchConfig, shape: ShapeConfig, mesh, rules: dict):
    """The spec tree of a decode cache (reads the resolved rules); a None
    subtree (the MoE family's absent dense stack) stays None."""
    mr = MeshRules(mesh, rules)
    b_ax = mr.axis("batch")
    seq_ax = mr.axis("kv_seq")
    h_ax = mr.axis("kv_heads")
    lat_ax = mr.axis("latent_seq")

    def visit(path, leaf):
        if leaf is None:
            return None
        pstr = leaf_path(path)
        nd = leaf.ndim
        spec = [None] * nd
        if (pstr.endswith("k") or pstr.endswith("v")) and nd == 5:
            spec = [None, b_ax, seq_ax, h_ax, None]   # [L, B, S, Hkv, dh]
        elif ("ckv" in pstr or "krope" in pstr) and nd == 4:
            spec = [None, b_ax, lat_ax, None]          # [L, B, S, r]
        elif nd >= 2:
            spec[1] = b_ax                              # states, conv, x_time
        return make_spec(a if leaf.shape[i] % _ax_size(mesh, a) == 0 else None
                         for i, a in enumerate(spec))

    leaves = tree_leaves_with_path(cache, is_leaf=_none)
    return tree_unflatten_like(cache, [visit(p, x) for p, x in leaves], is_leaf=_none)


def _none(x) -> bool:
    return x is None


def batch_shardings(specs: dict, mesh, rules: dict) -> dict:
    """Each input's spec: the batch axis on its leading dimension."""
    b_ax = MeshRules(mesh, rules).axis("batch")
    return {k: make_spec((b_ax, *([None] * (v.dim() - 1))) if v.dim() else ())
            for k, v in specs.items()}


@dataclasses.dataclass
class Cell:
    """A dry-run cell: ``step(*args)`` is the function a run of the cell
    makes, ``args`` its abstract operands and ``specs`` their spec trees
    (one a member of ``args``); ``donated`` names the members the step
    updates in place (the reference's ``donate_argnums``)."""

    arch: str
    cfg: ArchConfig
    shape: ShapeConfig
    mesh: Any
    rules: dict
    model: Any
    step: Callable
    args: tuple
    specs: tuple
    donated: tuple[int, ...]
    opt_cfg: AdamWConfig | None = None


def make_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, opt_cfg: AdamWConfig | None = None,
              arch: str | None = None) -> Cell:
    """The cell of any configuration and shape (``build_cell`` takes them
    from the registry; the cost report builds cells of cut depth)."""
    model = build_model(cfg, device="meta")
    rules = cell_rules(cfg, shape, mesh)
    params = model.init()
    p_sh = params_shardings(params, mesh, rules)
    specs = model.input_specs(shape)
    arch = arch or cfg.name
    if shape.kind == "train":
        opt_cfg = opt_cfg or opt_config_for(cfg)
        opt_state = make_opt_init(model, opt_cfg)(params)
        # moments share the param tree's specs; the step counter is a host int
        o_sh = AdamWState(step=Spec(), m=params_shardings(opt_state.m, mesh, rules),
                          v=params_shardings(opt_state.v, mesh, rules))
        return Cell(arch, cfg, shape, mesh, rules, model, make_train_step(model, opt_cfg),
                    (params, opt_state, specs),
                    (p_sh, o_sh, batch_shardings(specs, mesh, rules)), (0, 1), opt_cfg)
    if shape.kind == "prefill":
        return Cell(arch, cfg, shape, mesh, rules, model, model.prefill, (params, specs),
                    (p_sh, batch_shardings(specs, mesh, rules)), ())
    tok = batch_shardings({"token": specs["token"], "pos": specs["pos"]}, mesh, rules)
    return Cell(arch, cfg, shape, mesh, rules, model, model.decode_step,
                (params, specs["cache"], specs["token"], specs["pos"]),
                (p_sh, cache_shardings(specs["cache"], cfg, shape, mesh, rules),
                 tok["token"], tok["pos"]), (1,))


def build_cell(arch: str, shape_name: str, mesh, opt_cfg: AdamWConfig | None = None) -> Cell:
    """The registry's cell; raises for a shape the architecture skips."""
    cfg = get_config(arch)
    if shape_name in cfg.skip_shapes:
        raise ValueError(f"{arch} skips {shape_name}: {cfg.skip_reason}")
    return make_cell(cfg, SHAPES[shape_name], mesh, opt_cfg, arch)
