"""Op-counting cost report with the H100's constants: the port's
counterpart of ``repro/launch/hlo_cost.py`` and ``hlo_analysis.py``.

There is no HLO to parse.  :class:`OpCounter`, a ``TorchDispatchMode``,
runs a cell's step once over its abstract (meta) operands and prices each
aten operation it sees:

* **FLOPs**: ``2 * M * N * K`` for the matmul family (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``dot``, ``mv``; ``einsum`` and ``matmul``
  reach the device as these), reported as ``matmul_flops``; and, as
  ``elementwise_flops``, per output element the XLA elementwise ops an
  elementwise operation lowers to (1 for ``add``, 2 for ``silu``'s
  ``x * logistic(x)``), and per input element the reductions (``sum``,
  ``amax``, the softmaxes).  Copies, casts, sorts and gathers count no
  FLOPs, as ``hlo_cost`` counts none for ``convert``, ``sort``, ``gather``.
* **Bytes**: each operation's operands and results (an operand's touched
  extent, where a broadcast view repeats its storage), in place of XLA's
  fused top-level operations: these are *unfused eager* bytes, what
  PyTorch's eager kernels move.  Views and metadata cost nothing; a gather
  reads only the rows it returns and an in-place scatter (the decode
  cache's write) touches only its region, as ``hlo_cost`` prices a
  dynamic-slice and a dynamic-update-slice.
* **Trip counts**: the reference multiplies a while body by its trip
  count.  Here the Python loops run, so a count of the full step grows
  with the depth and the microbatches.  :func:`count_cell` counts the
  step at two depths of each layer stack (a hybrid stack's period is its
  ``shared_stride``) and at 2 and 3 microbatches, and extrapolates each
  total multilinearly to the cell's own: exact, since every count is
  affine in each of those (``tests/test_torch_cost.py`` holds the scaled
  count to the full one).
* **Collectives** (:func:`param_collectives`): no HLO, so only what the
  parameter specs force on each device: every FSDP-sharded weight
  gathered for the forward (and again for the backward in training), each
  microbatch, and each gradient reduce-scattered (all-reduced where the
  weight is replicated over the data-parallel group).  The activation
  collectives GSPMD would add are not counted
  (``"collectives_counted": "params"``).

The count is of the global step.  Per-device FLOPs and bytes split it
evenly over the mesh; the memory per device (:func:`memory_per_device`) is
exact from the specs' shard shapes.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import weakref
from typing import Any

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed.sharding import MeshRules, Spec
from repro_torch.launch.mesh import mesh_dp_size
from repro_torch.tree import Stacked, tree_leaves_with_path

# NVIDIA H100 SXM5 data sheet: bf16 dense on the tensor cores, HBM3, and
# NVLink 4 (900 GB/s a card, 450 GB/s each direction).  A bound takes the
# fastest rate of each, so that it never exceeds what the card can do.
PEAK_FLOPS = 989e12          # bf16 FLOP/s a card
HBM_BW = 3.35e12             # bytes/s a card
LINK_BW = 450e9              # bytes/s a card, one direction

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the matmul family: 2 * (output elements) * K, K the first matrix's last dim
_MATMUL = {"mm": 0, "bmm": 0, "dot": 0, "mv": 0, "addmm": 1, "baddbmm": 1, "addmv": 1}
# FLOPs per output element: the XLA elementwise ops each lowers to
_ELEMENTWISE = {
    **dict.fromkeys((
        "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "pow", "exp", "exp2",
        "log", "log2", "log1p", "expm1", "tanh", "rsqrt", "sqrt", "neg", "abs", "sin", "cos",
        "sigmoid", "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
        "logical_xor", "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
        "bitwise_not", "floor", "ceil", "round", "sign", "atan2", "erf", "remainder", "fmod",
        "clamp", "clamp_min", "clamp_max", "reciprocal", "relu", "square", "masked_fill",
        "threshold_backward"), 1),
    "silu": 2,                   # x * logistic(x)
    "softplus": 4,               # log1p(exp(-|x|)) + max(x, 0)
    "sigmoid_backward": 3,       # g * y * (1 - y)
    "tanh_backward": 3,          # g * (1 - y * y)
    "softplus_backward": 3,      # g * logistic(x)
    "silu_backward": 5,          # g * s * (1 + x * (1 - s)), s = logistic(x)
    "lerp": 3,
    "addcmul": 2,
    "addcdiv": 2,
}
# FLOPs per input element: reductions (and the softmaxes' reduce + map)
_REDUCTION = {
    **dict.fromkeys(("sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum",
                     "cumprod", "all", "any", "argmax", "argmin"), 1),
    "var": 3, "std": 3, "norm": 2, "logsumexp": 4,
    "_softmax": 5, "_log_softmax": 5, "_softmax_backward_data": 4,
    "_log_softmax_backward_data": 4,
}
# a gather reads the rows it returns; an in-place scatter its region
_GATHER = {"index", "index_select", "gather", "embedding"}
_SCATTER = {"index_put_", "_index_put_impl_", "scatter_", "scatter_add_", "index_add_",
            "index_copy_", "index_fill_", "masked_scatter_"}
_ACCUMULATE = {"scatter_add_", "index_add_"}
_OVERWRITE = {"copy_", "fill_", "zero_"}   # write self without reading it
# metadata and allocation only: no traffic
_FREE = {"_unsafe_view", "detach", "alias", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided", "lift_fresh", "set_",
         "resize_", "_reshape_alias", "sym_size", "sym_stride", "sym_numel"}

_VIEWS: dict[Any, bool] = {}


def _is_view(func) -> bool:
    v = _VIEWS.get(func)
    if v is None:
        rets = func._schema.returns
        v = _VIEWS[func] = bool(rets) and all(
            r.alias_info is not None and not r.alias_info.is_write for r in rets)
    return v


def _tensors(args, kwargs) -> list[torch.Tensor]:
    """The distinct tensors among an operation's arguments (in order; a
    list argument, as ``index`` takes, opened)."""
    seen: dict[int, torch.Tensor] = {}
    for a in itertools.chain(args, kwargs):
        if isinstance(a, torch.Tensor):
            seen[id(a)] = a
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    seen[id(b)] = b
    return list(seen.values())


def touched_bytes(t: torch.Tensor) -> int:
    """The bytes an operation moves for ``t``: its elements', or its
    extent's where a view repeats elements (a broadcast's stride 0)."""
    n = t.numel()
    if n == 0:
        return 0
    if t.is_contiguous():
        return n * t.element_size()
    span = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()))
    return min(n, span) * t.element_size()


@dataclasses.dataclass
class Counts:
    matmul_flops: int = 0
    elementwise_flops: int = 0
    bytes: int = 0
    ops: int = 0
    peak_live_bytes: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)   # name -> [flops, bytes, calls]

    @property
    def flops(self) -> int:
        return self.matmul_flops + self.elementwise_flops


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of every aten operation run under it (see
    the module docstring), and the peak of the bytes its own results hold
    alive (a storage is freed when its last tensor dies)."""

    def __init__(self):
        super().__init__()
        self.counts = Counts()
        self._live: dict[int, int] = {}
        self._live_bytes = 0

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _FREE or _is_view(func):
            return out
        ins = _tensors(args, kwargs.values())
        outs = [out] if isinstance(out, torch.Tensor) else _tensors(
            out if isinstance(out, (tuple, list)) else (out,), ())
        mm, ew = _flops(name, func, ins, outs)
        nbytes = _bytes(name, args, kwargs, ins, outs)
        c = self.counts
        c.matmul_flops += mm
        c.elementwise_flops += ew
        c.bytes += nbytes
        c.ops += 1
        row = c.by_op.setdefault(name, [0, 0, 0])
        row[0] += mm + ew
        row[1] += nbytes
        row[2] += 1
        self._track(ins, outs)
        return out

    def _track(self, ins, outs) -> None:
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in held or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self._live_bytes += n
            weakref.finalize(st, self._free, key)
        self.counts.peak_live_bytes = max(self.counts.peak_live_bytes, self._live_bytes)


def _flops(name: str, func, ins, outs) -> tuple[int, int]:
    if not outs:
        return 0, 0
    if name in _MATMUL:
        # mm(a, b) / addmm(bias, a, b): K is a's last dimension; the bias add
        # is one elementwise FLOP an output element
        a = ins[min(_MATMUL[name], len(ins) - 1)]
        return 2 * outs[0].numel() * a.shape[-1], outs[0].numel() * _MATMUL[name]
    base = name.rstrip("_")
    if base in ("max", "min") and func._overloadname == "other":
        return 0, outs[0].numel()
    if base in _ELEMENTWISE:
        return 0, _ELEMENTWISE[base] * outs[0].numel()
    if base in _REDUCTION and ins:
        return 0, _REDUCTION[base] * ins[0].numel()
    return 0, 0


def _bytes(name: str, args, kwargs, ins, outs) -> int:
    if name in _GATHER:            # the rows read and written, and the indices
        return 2 * sum(touched_bytes(t) for t in outs) + sum(touched_bytes(t) for t in ins[1:])
    if name in _SCATTER:
        region = touched_bytes(ins[-1]) if len(ins) > 1 else 0
        accumulate = name in _ACCUMULATE or (name in ("index_put_", "_index_put_impl_")
                                             and _accumulate(args, kwargs))
        return sum(touched_bytes(t) for t in ins[1:]) + region * (2 if accumulate else 1)
    if name in _OVERWRITE:
        return sum(touched_bytes(t) for t in ins[1:]) + sum(touched_bytes(t) for t in outs)
    return sum(touched_bytes(t) for t in ins) + sum(touched_bytes(t) for t in outs)


def _accumulate(args, kwargs) -> bool:
    if "accumulate" in kwargs:
        return bool(kwargs["accumulate"])
    return len(args) > 3 and bool(args[3])


def count(fn, *args, **kwargs) -> tuple[Counts, Any]:
    """(the counts, fn's result) of one call of ``fn`` under an OpCounter."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return counter.counts, out


# ---------------------------------------------------------------------------
# the cell's count, scaled over depth and microbatches
# ---------------------------------------------------------------------------

def _with_depths(cfg, depths: dict[tuple[str, ...], int]):
    """``cfg`` with each layer stack of :func:`layer_stacks` at the given depth."""
    from repro_torch.models.model import layer_stacks
    d = {**layer_stacks(cfg), **depths}
    if cfg.family == "moe":
        nd = d.get(("dense_layers",), 0)
        return dataclasses.replace(cfg, n_layers=nd + d[("layers",)],
                                   moe=dataclasses.replace(cfg.moe, first_dense_layers=nd))
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_layers=d[("layers",)], enc_dec=dataclasses.replace(
            cfg.enc_dec, n_encoder_layers=d[("encoder",)]))
    (depth,) = d.values()
    return dataclasses.replace(cfg, n_layers=depth)


def scaling_plan(cfg, shape) -> list[tuple[str, int, int, int]]:
    """The counts' variables: (name, the cell's value, the low grid value,
    the period) for each layer stack deep enough to scale (the stack's
    path, or ``microbatches``).  A stack's low value is the least >= 2 of
    its residue mod the period (a hybrid stack's period is its
    ``shared_stride``: its layers repeat in groups of that many); the
    second grid value is one period more.  Microbatches scale from 2 (one
    microbatch takes another branch).  Anything shallower is counted at
    its own value."""
    from repro_torch.models.model import layer_stacks
    plan = []
    for path, depth in layer_stacks(cfg).items():
        period = cfg.ssm.shared_stride if cfg.family == "hybrid" and cfg.ssm.shared_stride \
            else 1
        lo = depth % period
        while lo < 2:
            lo += period
        if depth > lo + period:
            plan.append(("/".join(path), depth, lo, period))
    if shape.kind == "train" and cfg.grad_accum > 3:
        plan.append(("microbatches", cfg.grad_accum, 2, 1))
    return plan


def _variant(cell, point: dict[str, int]):
    """The cell at the plan's grid point: its stacks at the point's depths
    and, for ``microbatches``, that many microbatches of the cell's size."""
    from repro_torch.launch.cell import make_cell
    from repro_torch.models.model import layer_stacks
    cfg, shape = cell.cfg, cell.shape
    depths = {p: point["/".join(p)] for p in layer_stacks(cfg) if "/".join(p) in point}
    cfg = _with_depths(cfg, depths)
    if "microbatches" in point:
        micro = shape.global_batch // cell.cfg.grad_accum
        cfg = dataclasses.replace(cfg, grad_accum=point["microbatches"])
        shape = dataclasses.replace(shape, global_batch=micro * point["microbatches"])
    return make_cell(cfg, shape, cell.mesh, cell.opt_cfg, cell.arch)


def count_cell(cell, scaled: bool = True) -> dict:
    """The cell step's global counts (:class:`Counts`' fields and ``by_op``)
    and the bytes of its results that alias no operand
    (``other_output_bytes``: logits, metrics).  ``scaled`` counts the
    :func:`scaling_plan`'s grid and extrapolates; else the step itself.
    The peak of live bytes is extrapolated as the totals are, which is
    exact only where it grows affinely with the depth (as a remat'd
    stack's saved layer inputs do); the totals always are."""
    plan = scaling_plan(cell.cfg, cell.shape) if scaled else []
    fields = ("matmul_flops", "elementwise_flops", "bytes", "ops", "peak_live_bytes")
    total = dict.fromkeys(fields, 0)
    by_op: dict[str, list[int]] = collections.defaultdict(lambda: [0, 0, 0])
    other = None
    points = []
    for corner in itertools.product((0, 1), repeat=len(plan)):
        point = {name: lo + c * period for (name, _, lo, period), c in zip(plan, corner)}
        weight = 1
        for (_, value, lo, period), c in zip(plan, corner):
            t = (value - lo) // period
            weight *= t if c else 1 - t
        var = _variant(cell, point) if plan else cell
        counts, out = count(var.step, *var.args)
        if other is None:
            other = _other_output_bytes(var, out)
        points.append(point)
        for f in fields:
            total[f] += weight * getattr(counts, f)
        for name, row in counts.by_op.items():
            acc = by_op[name]
            for i in range(3):
                acc[i] += weight * row[i]
    total["flops"] = total["matmul_flops"] + total["elementwise_flops"]
    total["by_op"] = dict(by_op)
    total["other_output_bytes"] = other
    total["counted_points"] = points
    return total


def _other_output_bytes(cell, out) -> int:
    """Bytes of the step's tensor results that are no operand's (updated in
    place): counted whole, as the cell gives them no spec."""
    held = {_storage_key(x) for _, x, _ in leaves_with_specs(cell.args, cell.specs)
            if isinstance(x, torch.Tensor)}
    params = cell.args[0]
    held |= {_storage_key(p) for p in params.parameters()}
    return sum(t.nbytes for t in pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor) and _storage_key(t) not in held)


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


# ---------------------------------------------------------------------------
# specs: memory per device and parameter collectives
# ---------------------------------------------------------------------------

def _spec_leaf(x) -> bool:
    return x is None or isinstance(x, Spec)


def _arg_leaf(x) -> bool:
    return x is None or isinstance(x, (torch.Tensor, Stacked, int))


def leaves_with_specs(args, specs) -> list[tuple[str, Any, Spec]]:
    """(path, leaf, spec) over a cell's operands and their spec trees; a
    ``DecoderLM`` is read in the reference's layout, None subtrees skipped."""
    args = tuple(a.reference_tree() if hasattr(a, "reference_tree") else a for a in args)
    leaves = tree_leaves_with_path(args, is_leaf=_arg_leaf)
    spec_leaves = tree_leaves_with_path(specs, is_leaf=_spec_leaf)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} operand leaves, {len(spec_leaves)} specs")
    return [("/".join(p), x, s) for (p, x), (_, s) in zip(leaves, spec_leaves) if x is not None]


def _axes(spec: Spec) -> list[str]:
    out = []
    for e in spec:
        if e is not None:
            out.extend((e,) if isinstance(e, str) else e)
    return out


def _leaf_shape_bytes(x) -> tuple[tuple[int, ...], int]:
    if isinstance(x, Stacked):
        return tuple(x.shape), x[0].element_size()
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.element_size()
    return (), 0                                   # a host int (the optimizer's step)


def shard_shape(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[int, ...]:
    """A device's block of a leaf: each dimension over its axes' sizes
    (``NamedSharding.shard_shape``); the axes must divide it."""
    out = []
    for i, d in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        n = math.prod(mesh.shape[a] for a in _axes(Spec((e,))))
        if d % n:
            raise ValueError(f"dimension {d} does not divide over {e} ({n})")
        out.append(d // n)
    return tuple(out)


def shard_bytes(x, spec: Spec, mesh) -> int:
    shape, itemsize = _leaf_shape_bytes(x)
    return math.prod(shard_shape(shape, spec, mesh)) * itemsize if itemsize else 0


def memory_per_device(cell, other_output_bytes: int = 0) -> dict:
    """Per-device ``argument_size_in_bytes`` (every operand's shard),
    ``alias_size_in_bytes`` (the donated operands', updated in place) and
    ``output_size_in_bytes`` (those plus the results no operand holds,
    counted whole)."""
    per_arg = [sum(shard_bytes(x, s, cell.mesh) for _, x, s in
                   leaves_with_specs((a,), (sp,))) for a, sp in zip(cell.args, cell.specs)]
    alias = sum(per_arg[i] for i in cell.donated)
    return dict(argument_size_in_bytes=sum(per_arg), alias_size_in_bytes=alias,
                output_size_in_bytes=alias + other_output_bytes)


def param_collectives(cell) -> dict:
    """Per-device bytes each collective kind must bring in for the
    parameters alone, under the cell's specs (see the module docstring):
    a gather over g devices brings (g - 1) / g of the weight's model shard,
    a reduce-scatter as much, an all-reduce twice that."""
    mesh, kind = cell.mesh, cell.shape.kind
    fsdp = set(_axes(Spec((MeshRules(mesh, cell.rules).axis("fsdp"),))))
    dp = mesh_dp_size(mesh)
    train = kind == "train"
    micro = max(1, cell.cfg.grad_accum) if train else 1
    out = dict.fromkeys(COLLECTIVES, 0.0)
    for _, x, spec in leaves_with_specs((cell.args[0],), (cell.specs[0],)):
        shape, itemsize = _leaf_shape_bytes(x)
        axes = _axes(spec)
        g = math.prod(mesh.shape[a] for a in axes if a in fsdp)
        tp = math.prod(mesh.shape[a] for a in axes if a not in fsdp)
        local = math.prod(shape) * itemsize / tp
        if g > 1:
            out["all-gather"] += (g - 1) / g * local * (2 if train else 1) * micro
            if train:
                out["reduce-scatter"] += (g - 1) / g * local * micro
        elif train and dp > 1:
            out["all-reduce"] += 2 * (dp - 1) / dp * local * micro
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


# ---------------------------------------------------------------------------
# the reference's roofline terms and model FLOPs
# ---------------------------------------------------------------------------

def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, n_chips: int) -> dict[str, Any]:
    """Three roofline terms in seconds on the H100 (global quantities /
    aggregate rate == per-device quantity / per-card rate for uniformly
    sharded work)."""
    t_compute = flops_per_dev / PEAK_FLOPS
    t_memory = bytes_per_dev / HBM_BW
    t_coll = coll_bytes_per_dev / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    total = max(terms.values())
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_time_s": total,
        "hlo_flops_global": flops_per_dev * n_chips,
        "hlo_bytes_global": bytes_per_dev * n_chips,
        "collective_bytes_global": coll_bytes_per_dev * n_chips,
    }


def model_flops(cfg, shape, active_params: int) -> float:
    """MODEL_FLOPS = 6 * N_active * D for train, 2 * N_active * D for
    inference-style steps (D = tokens processed by the step)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active_params * tokens
    tokens = shape.global_batch                      # one token per sequence
    return 2.0 * active_params * tokens


def cell_report(cell, counts: dict | None = None) -> dict:
    """The dry-run's analyses of a cell: memory per device, the counted
    cost per device (the global count split evenly), the parameter
    collectives and the roofline terms.  ``counts`` is the cell's
    :func:`count_cell` where the caller has it (the count is the global
    step's, the same on every mesh)."""
    from repro_torch.configs import param_count
    counts = counts or count_cell(cell)
    n = cell.mesh.size
    coll = param_collectives(cell)
    flops_dev = counts["flops"] / n
    bytes_dev = counts["bytes"] / n
    roof = roofline_terms(flops_dev, bytes_dev, coll["total"], n)
    total_p, active_p = param_count(cell.cfg)
    mf = model_flops(cell.cfg, cell.shape, active_p)
    roof["model_flops"] = mf
    roof["useful_fraction"] = mf / roof["hlo_flops_global"] if roof["hlo_flops_global"] else None
    memory = memory_per_device(cell, counts["other_output_bytes"])
    memory["peak_live_bytes_global"] = counts["peak_live_bytes"]
    top = sorted(counts["by_op"].items(), key=lambda kv: -kv[1][1])[:12]
    return dict(
        n_devices=n, memory=memory,
        cost_per_device={"flops": flops_dev, "bytes accessed": bytes_dev,
                         "matmul_flops": counts["matmul_flops"] / n,
                         "elementwise_flops": counts["elementwise_flops"] / n},
        cost_global={k: counts[k] for k in
                     ("matmul_flops", "elementwise_flops", "flops", "bytes", "ops")},
        bytes_by_op_global={k: {"flops": v[0], "bytes": v[1], "calls": v[2]} for k, v in top},
        counted_points=counts["counted_points"],
        collectives_per_device=coll, collectives_counted="params", roofline=roof,
        params_total=total_p, params_active=active_p,
        counted="aten ops on meta tensors: unfused eager bytes, per device an even split",
        hardware="NVIDIA H100 SXM5: 989e12 bf16 FLOP/s, 3.35e12 B/s HBM3, 450e9 B/s NVLink",
    )
