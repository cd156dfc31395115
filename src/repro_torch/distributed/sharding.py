"""Logical-axis sharding rules (MaxText-style) and the parameter specs
derived from them: port of the rule half of ``repro/distributed/sharding.py``.

Model code names axes *logically* ("batch", "heads", "fsdp"); a rule table
maps each logical name onto physical mesh axes.  Here a spec is a tuple
with one entry a dimension, each ``None`` (replicated), a mesh axis name,
or a tuple of names: the counterpart of JAX's ``PartitionSpec``.  The
dry-run (``launch.cell``, ``launch.cost``) reads these specs to size each
device's shard and the parameter traffic.  The runtime half (``logical``,
``use_mesh_rules``, ``active_rules``, ``batch_axes``, ``replicated``)
comes with multi-device training (ROADMAP.md, slice 2b).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.tree import Stacked, tree_leaves_with_path, tree_unflatten_like



class Spec(tuple):
    """A dimension's entries: None (replicated), an axis name, or a tuple of
    names.  A tuple (it equals the tuple of a ``PartitionSpec``'s entries),
    its own type so that a tree of specs tells a spec from a container."""

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),    # data parallel over pods x data axis
    "seq": None,                 # sequence replicated (activations)
    "kv_seq": "data",            # decode KV caches: sequence-sharded (SP)
    "latent_seq": None,          # MLA latent cache sequence axis (per-cell)
    "embed": None,               # d_model in activations: replicated
    "heads": "model",            # TP over attention heads
    "kv_heads": "model",
    "ffn": "model",              # TP over FFN hidden
    "vocab": "model",            # TP over vocab
    "experts": "model",          # EP shares the model axis
    "fsdp": ("pod", "data"),     # ZeRO-3 weight sharding axis
    "layers": None,              # scanned layer axis
}


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """A rule table resolved against a mesh (``launch.mesh.LogicalMesh``):
    a physical axis the mesh lacks is dropped."""

    mesh: Any
    rules: dict[str, Any]

    def axis(self, logical: str | None):
        if logical is None:
            return None
        phys = self.rules.get(logical, None)
        if phys is None:
            return None
        if isinstance(phys, str):
            return phys if phys in self.mesh.axis_names else None
        # tuple: keep only axes present in this mesh
        kept = tuple(a for a in phys if a in self.mesh.axis_names)
        return kept if kept else None

    def spec(self, *logical: str | None) -> Spec:
        return make_spec(self.axis(a) for a in logical)


def make_spec(entries) -> Spec:
    """A spec from its entries as ``PartitionSpec`` stores them: an entry
    that is a tuple of one axis becomes that axis's name."""
    return Spec(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


# ---------------------------------------------------------------------------
# Parameter specs by leaf-path pattern
# ---------------------------------------------------------------------------

# map (substring of the param path, ndim) -> logical axes; first match wins.
# paths look like "layers/attn/wq", "embed/embedding", "layers/mlp/experts/w1"
_PARAM_RULES: list[tuple[str, dict[int, tuple]]] = [
    ("embedding", {2: ("vocab", "fsdp")}),
    ("unembed", {2: ("fsdp", "vocab")}),
    ("experts", {3: ("experts", "fsdp", None), 4: (None, "experts", "fsdp", None)}),
    ("router", {2: ("fsdp", None), 3: (None, "fsdp", None)}),
    ("wq", {2: ("fsdp", "heads"), 3: (None, "fsdp", "heads")}),
    ("wk", {2: ("fsdp", "heads"), 3: (None, "fsdp", "heads")}),
    ("wv", {2: ("fsdp", "heads"), 3: (None, "fsdp", "heads")}),
    ("wo", {2: ("heads", "fsdp"), 3: (None, "heads", "fsdp")}),
    ("w_dkv", {2: ("fsdp", None), 3: (None, "fsdp", None)}),
    ("w_dq", {2: ("fsdp", None), 3: (None, "fsdp", None)}),
    ("w_uk", {3: (None, "fsdp", "heads"), 4: (None, None, "fsdp", "heads")}),
    ("w_uv", {3: (None, "fsdp", "heads"), 4: (None, None, "fsdp", "heads")}),
    ("w_uq", {2: ("fsdp", "heads"), 3: (None, "fsdp", "heads")}),
    ("w_krope", {2: ("fsdp", None), 3: (None, "fsdp", None)}),
    ("w1", {2: ("fsdp", "ffn"), 3: (None, "fsdp", "ffn")}),
    ("w3", {2: ("fsdp", "ffn"), 3: (None, "fsdp", "ffn")}),
    ("w2", {2: ("ffn", "fsdp"), 3: (None, "ffn", "fsdp")}),
    ("in_proj", {2: ("fsdp", "heads"), 3: (None, "fsdp", "heads")}),
    ("out_proj", {2: ("heads", "fsdp"), 3: (None, "heads", "fsdp")}),
    ("conv", {2: (None, "heads"), 3: (None, None, "heads")}),
]


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    axes = (ax,) if isinstance(ax, str) else ax
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def _spec_for_leaf(path: str, shape: tuple, rules: MeshRules) -> Spec:
    ndim = len(shape)
    for pat, by_ndim in _PARAM_RULES:
        if pat in path and ndim in by_ndim:
            spec = [rules.axis(a) for a in by_ndim[ndim]]
            # argument shardings need exact divisibility: drop any axis
            # that does not divide its dim (e.g. whisper's 51865 vocab)
            return make_spec(a if shape[i] % _axis_size(rules.mesh, a) == 0 else None
                             for i, a in enumerate(spec))
    # norms / biases / scalars: replicated
    return Spec((None,) * ndim)


def leaf_path(path: tuple[str, ...]) -> str:
    """A leaf's path as the reference prints it: its keys joined by ``/``."""
    return "/".join(path)


def params_shardings(params, mesh, rules: dict | None = None):
    """The spec tree of a parameter tree (keyed by leaf path): a
    ``DecoderLM`` is read in the reference's layout (a scanned stack's
    leaves ``[L, ...]``), any other tree (optimizer moments, factored
    ``{row, col}`` among them) as it is; a None subtree stays None."""
    mr = MeshRules(mesh, dict(rules or DEFAULT_RULES))
    tree = params.reference_tree() if hasattr(params, "reference_tree") else params
    leaves = tree_leaves_with_path(tree, is_leaf=_is_leaf)
    return tree_unflatten_like(tree, [
        None if leaf is None else _spec_for_leaf(leaf_path(path), tuple(leaf.shape), mr)
        for path, leaf in leaves], is_leaf=_is_leaf)


def _is_leaf(x) -> bool:
    """A stacked leaf (its shape is ``[L, ...]``) or None (no leaf, as in JAX)."""
    return x is None or isinstance(x, Stacked)
