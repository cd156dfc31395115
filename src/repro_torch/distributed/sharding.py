"""Logical-axis sharding rules (MaxText-style), the parameter specs
derived from them, and the runtime layer that model code reads: port of
``repro/distributed/sharding.py``.

Model code names axes *logically* ("batch", "heads", "fsdp"); a rule table
maps each logical name onto physical mesh axes.  Here a spec is a tuple
with one entry a dimension, each ``None`` (replicated), a mesh axis name,
or a tuple of names: the counterpart of JAX's ``PartitionSpec``.  The
dry-run (``launch.cell``, ``launch.cost``) reads these specs to size each
device's shard and the parameter traffic.

At run time :func:`use_mesh_rules` makes a mesh and its rules active and
:func:`active_rules` reads them; with no active mesh every function here
is a no-op, as in the reference.  The port has no GSPMD, so it has no
``logical`` (the reference's activation constraint) nor ``replicated``
(its ``P()`` sharding): the split is explicit where the reference's
shardings split work.  The train step (``train.step``) runs one data shard
at a time under :func:`use_shard`; inside it :func:`shard_group` gives the
tensor-parallel (``heads``, ``ffn``) and expert-parallel (``experts``)
blocks the devices of that data shard's model axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Any

from repro_torch.tree import Stacked, tree_leaves_with_path, tree_unflatten_like

# The active rules and data shard, process-wide.  The reference keeps them
# thread-local; here autograd runs a CUDA backward on a thread of its own,
# and a remat recompute there must see the rules its forward saw.
_STATE = types.SimpleNamespace(rules=None, scope=None)


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

    def size(self, logical: str | None) -> int:
        """The number of shards of a logical axis on this mesh."""
        return _axis_size(self.mesh, self.axis(logical))


def active_rules() -> MeshRules | None:
    return _STATE.rules


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: dict[str, Any] | None = None):
    prev = _STATE.rules
    _STATE.rules = MeshRules(mesh, dict(rules or DEFAULT_RULES)) if mesh is not None else None
    try:
        yield _STATE.rules
    finally:
        _STATE.rules = prev


def _names(ax) -> tuple[str, ...]:
    """A resolved axis (None, a name or a tuple of names) as a tuple."""
    return () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)


def batch_axes() -> tuple[str, ...]:
    """The mesh axes that the active rules split the batch over."""
    r = active_rules()
    return () if r is None else _names(r.axis("batch"))


# ---------------------------------------------------------------------------
# the data shard being run, and its model axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardScope:
    """The data shard that the code below runs: its index ``data`` over
    the batch axes (row-major, as the reference lays the batch out), and
    what the expert-parallel MoE block shares across the data shards of
    one microbatch: ``shard0``, data shard 0's ``(aux_loss,
    expert_load)`` a MoE call in call order, which every data shard
    returns as the reference's ``shard_map`` does (``out_specs=P()``);
    ``forward`` is False while autograd recomputes (remat) in the
    backward, where the values are not read."""

    data: int = 0
    shard0: list = dataclasses.field(default_factory=list)
    forward: bool = True
    cursor: int = 0


def current_shard() -> ShardScope | None:
    return _STATE.scope


@contextlib.contextmanager
def use_shard(scope: ShardScope):
    prev = _STATE.scope
    _STATE.scope = scope
    try:
        yield scope
    finally:
        _STATE.scope = prev


def batch_coords(data: int) -> dict[str, int]:
    """Data shard ``data``'s coordinates on the active mesh's batch axes
    (row-major)."""
    coords = {}
    for ax in reversed(batch_axes()):
        size = active_rules().mesh.shape[ax]
        coords[ax] = data % size
        data //= size
    return coords


def shard_group(logical_axis: str, dim: int):
    """The 1-D mesh of ``logical_axis``'s devices for the current data shard
    (shard 0 outside :func:`use_shard`), when the active mesh splits that
    axis over more than one device and its size divides ``dim``; else
    None: the dimension stays whole, as an axis that does not divide its
    dimension is dropped from a parameter's spec."""
    r = active_rules()
    if r is None or not hasattr(r.mesh, "group"):
        return None
    ax = r.axis(logical_axis)
    if not isinstance(ax, str) or r.mesh.shape[ax] == 1 or dim % r.mesh.shape[ax]:
        return None
    scope = current_shard()
    return r.mesh.group(ax, **batch_coords(scope.data if scope else 0))


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
