"""Static launch-contract checker for the CUDA kernel registry (codes KC2xx).

Port of ``repro.analysis.kernel_contracts``.  The parity tests and
``chip_smoke.py`` prove the kernels *compute* the right thing at the shapes
they run; this pass proves the **launch geometry** is right at the shapes
the config *permits*: the envelope of the reference's pass (K =
``MAX_N_NEIGHBORS`` = 1024, a lattice of ``MAX_N_BOXES`` boxes = 257
nodes, D = 1024) and every point-major kernel also at the paper's
N = 1 291 337 (on the TPU the risk came from the widths; here it comes
from N, which reaches the C entries as ``c_int``).

Mechanism: each registry entry's ``cuda`` wrapper is called on
``device="meta"`` tensors (shapes and dtypes only: ``data_ptr()`` is 0, no
memory is taken) while :func:`record_launches` stands in for
``ops._launch``, so no kernel is built or run.  Each launch is recorded
with its kernel name, source and integer arguments, and
``ops.launch_plan`` gives the grid, block and dynamic shared memory the C
entry computes from them.  Each record is then validated:

* **KC201**: grid x items a block reaches every output row, point, node
  or lattice band (``LaunchPlan.covers``);
* **KC202**: every argument bound as ``c_int`` lies in int32 (ctypes
  wraps silently), grid.x in [1, 2^31 - 1], grid.y and grid.z in
  [1, 65535];
* **KC203**: the ``plain`` twin and the ``cuda`` wrapper return the same
  structure, shapes and dtypes (both on meta; the Barnes-Hut walk's plain
  twin reads "any point still active" back to the host, so its parity is
  taken on a small real tree on the CPU against the wrapper on meta);
* **KC204**: at most 1024 threads a block and at most ``SMEM_LIMIT``
  bytes of dynamic shared memory.

An entry with no declared sample, a call that raises, or one that reaches
no ``_launch``, is itself a finding (**KC200**).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import re
from pathlib import Path

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import ops

REPO_ROOT = Path(__file__).resolve().parents[3]
INT32 = (-2**31, 2**31 - 1)
INT64 = (-2**63, 2**63 - 1)
GRID_X_MAX = 2**31 - 1
GRID_YZ_MAX = 65_535
BLOCK_THREADS_MAX = 1024
N_REFERENCE = 517          # the reference pass's first sample N
N_PAPER = 1_291_337        # mouse_1p3m, the paper's million-point set
ENVELOPES = (N_REFERENCE, N_PAPER)
D_ENVELOPE = 1024          # post-PCA input width of the reference's samples
SERVICE_ROWS = 60_000      # the service's reference rows (MNIST's train split)


@dataclasses.dataclass
class LaunchRecord:
    """One ``ops._launch`` call, as captured on meta tensors."""
    name: str                # registry name
    source: str              # csrc/<source>.cu
    int_args: tuple          # ((value, ctypes type), ...) of the integer arguments

    @property
    def values(self) -> tuple[int, ...]:
        return tuple(v for v, _ in self.int_args)


@contextlib.contextmanager
def record_launches(records: list[LaunchRecord]):
    """Stand in for ``ops._launch`` (the module global every ``*_cuda``
    wrapper calls) so launches append to ``records`` and run nothing."""
    orig = ops._launch

    def recorder(name, source, device, *args):
        sig = ops._SIGNATURES.get(source)
        if sig is None:     # a source the registry does not know: every int is a c_int
            ints = tuple((a, ctypes.c_int) for a in args if isinstance(a, int))
        else:
            ints = tuple((a, t) for a, t in zip(args, sig[1])
                         if t in (ctypes.c_int, ctypes.c_longlong))
        records.append(LaunchRecord(name, source, ints))

    ops._launch = recorder
    try:
        yield
    finally:
        ops._launch = orig


def _location(source: str) -> tuple[str, int]:
    """csrc/<source>.cu and the line of its C entry (or ``<source>``, 0)."""
    path = REPO_ROOT / "src" / "repro_torch" / "csrc" / f"{source}.cu"
    sig = ops._SIGNATURES.get(source)
    if sig is None or not path.exists():
        return f"<{source}>", 0
    text = path.read_text()
    m = re.search(rf'^extern "C" int {sig[0]}\(', text, re.M)
    line = text.count("\n", 0, m.start()) + 1 if m else 0
    return path.relative_to(REPO_ROOT).as_posix(), line


def validate_launch(rec: LaunchRecord, scope: str, plan_fn=None) -> list[Finding]:
    """Check one recorded launch's arguments and plans; returns findings."""
    plan_fn = plan_fn or ops.launch_plan
    path, line = _location(rec.source)
    findings: list[Finding] = []

    def emit(code, message):
        findings.append(Finding(code=code, path=path, line=line,
                                message=message, scope=scope))

    for i, (v, t) in enumerate(rec.int_args):
        lo, hi = INT32 if t is ctypes.c_int else INT64
        if not lo <= v <= hi:
            emit("KC202", f"{rec.name}: integer argument {i} = {v} is bound as "
                          f"{t.__name__}, outside [{lo}, {hi}]: ctypes wraps it")
    try:
        plans = plan_fn(rec.name, *rec.values)
    except ValueError as exc:
        emit("KC200", f"{rec.name}: no launch plan: {exc}")
        return findings
    for j, plan in enumerate(plans):
        label = f"{rec.name} launch {j}"
        gx, gy, gz = plan.grid
        if not (1 <= gx <= GRID_X_MAX and 1 <= gy <= GRID_YZ_MAX and 1 <= gz <= GRID_YZ_MAX):
            emit("KC202", f"{label}: grid {plan.grid} outside [1, {GRID_X_MAX}] x "
                          f"[1, {GRID_YZ_MAX}] x [1, {GRID_YZ_MAX}]")
        for c in plan.covers:
            if plan.grid[c.axis] * c.per_block < c.extent:
                emit("KC201", f"{label}: grid axis {c.axis} = {plan.grid[c.axis]} "
                              f"blocks x {c.per_block} {c.what} a block covers "
                              f"{plan.grid[c.axis] * c.per_block} of {c.extent} {c.what}")
        threads = plan.block[0] * plan.block[1] * plan.block[2]
        if threads > BLOCK_THREADS_MAX:
            emit("KC204", f"{label}: block {plan.block} = {threads} threads > "
                          f"{BLOCK_THREADS_MAX}")
        if plan.smem_bytes > ops.SMEM_LIMIT:
            emit("KC204", f"{label}: {plan.smem_bytes} bytes of dynamic shared memory "
                          f"> {ops.SMEM_LIMIT}")
    return findings


def _leaves(out) -> list:
    """(shape, dtype) of each tensor of a (nested) tuple, type names else."""
    if isinstance(out, torch.Tensor):
        return [(tuple(out.shape), out.dtype)]
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [type(out).__name__]


def _to_meta(obj):
    """Tensors (in tuples and NamedTuples) as meta tensors; the rest as is."""
    if isinstance(obj, torch.Tensor):
        return torch.empty_like(obj, device="meta")
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_meta(o) for o in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_meta(o) for o in obj)
    return obj


def check_kernel_callable(name: str, fn, args, kwargs: dict | None = None,
                          plain=None, plain_args=None, plan_fn=None) -> list[Finding]:
    """Call ``fn(*args, **kwargs)`` (a CUDA wrapper, on meta tensors) under
    :func:`record_launches` and validate every launch it reaches.  With
    ``plain``, also hold its outputs to the plain twin's on the same
    arguments (KC203), or on ``plain_args`` (real CPU tensors) against
    ``fn`` on their meta copies."""
    kwargs = kwargs or {}
    records: list[LaunchRecord] = []
    try:
        with record_launches(records):
            out = fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 -- the failure IS the finding
        return [Finding(code="KC200", path=f"<{name}>", line=0, scope=name,
                        message=f"calling the wrapper on meta raised "
                                f"{type(exc).__name__}: {exc}")]
    if not records:
        return [Finding(code="KC200", path=f"<{name}>", line=0, scope=name,
                        message="no ops._launch reached: nothing to validate "
                                "(wrapper dispatched elsewhere?)")]
    findings: list[Finding] = []
    for rec in records:
        findings.extend(validate_launch(rec, name, plan_fn))
    if plain is None:
        return findings
    try:
        if plain_args is None:
            ref = plain(*args, **kwargs)
        else:
            ref = plain(*plain_args, **kwargs)
            with record_launches([]):
                out = fn(*_to_meta(plain_args), **kwargs)
    except Exception as exc:  # noqa: BLE001
        findings.append(Finding(code="KC200", path=f"<{name}>", line=0, scope=name,
                                message=f"plain/cuda parity raised "
                                        f"{type(exc).__name__}: {exc}"))
        return findings
    if _leaves(ref) != _leaves(out):
        findings.append(Finding(code="KC203", path=f"<{name}>", line=0, scope=name,
                                message=f"plain outputs {_leaves(ref)} != cuda "
                                        f"outputs {_leaves(out)}"))
    return findings


# ---------------------------------------------------------- sample shapes --

@dataclasses.dataclass
class Sample:
    """One call of an entry's CUDA wrapper: meta arguments, and for a plain
    twin that reads data on the host, real CPU arguments for its parity."""
    label: str
    args: tuple
    kwargs: dict = dataclasses.field(default_factory=dict)
    plain_args: tuple | None = None


def _meta(*shape: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _walk_args(n: int, compress: bool):
    """The walk's arguments on meta at the tree's capacity for n points."""
    from repro_torch.core import morton
    from repro_torch.core.quadtree import LinearQuadtree
    from repro_torch.core.summarize import TreeSummary

    depth = morton.DEFAULT_DEPTH
    cap = 2 * n + 1 if compress else (depth + 1) * n + 1
    i64 = torch.int64
    tree = LinearQuadtree(start=_meta(cap, dtype=i64), end=_meta(cap, dtype=i64),
                          level=_meta(cap, dtype=i64), skip=_meta(cap, dtype=i64),
                          n_nodes=_meta(dtype=i64), depth=depth)
    summary = TreeSummary(count=_meta(cap), sum_y=_meta(cap, 2), com=_meta(cap, 2),
                          side=_meta(cap))
    return (_meta(n, 2), tree, summary, 0.5)


def _small_walk_args(n: int = 64):
    """A real tree of n points on the CPU, for the walk's plain parity."""
    from repro_torch.core import morton, quadtree, summarize

    y = torch.linspace(-3.0, 3.0, 2 * n).reshape(n, 2) ** 3
    cent, r_span = morton.span_radius(y)
    codes = morton.morton_encode(y, cent, r_span)
    perm = torch.argsort(codes, stable=True)
    tree = quadtree.build_quadtree(codes[perm])
    return (y[perm], tree, summarize.summarize(tree, y[perm], r_span), 0.5)


def _samples(n: int) -> dict[str, list[Sample]]:
    """name -> samples at the config-permitted maxima for n points."""
    from repro_torch.core.fft_repulsion import MAX_N_BOXES, P_ORDER
    from repro_torch.core.tsne import MAX_N_NEIGHBORS

    i32 = torch.int32
    k, d = MAX_N_NEIGHBORS, D_ENVELOPE
    nodes = MAX_N_BOXES * (P_ORDER - 1) + 1

    def tile(nq, nc):
        return (_meta(nq, d), _meta(nc, d), _meta(nq), _meta(nc))

    interp = (_meta(n, 2, dtype=i32), _meta(n, P_ORDER), _meta(n, P_ORDER))
    small_walk = _small_walk_args()
    return {
        # the knn defaults (core/knn.py), the main path's tile and a
        # service admission against every reference row
        "pairwise_sq_dists": [Sample("block 512 x 2048", tile(512, 2048)),
                              Sample("block 4096 x 8192", tile(4096, 8192)),
                              Sample(f"one row x {SERVICE_ROWS}", tile(1, SERVICE_ROWS))],
        "bsp_search": [Sample(f"K={k}", (_meta(n, k), 30.0))],
        "morton_encode": [Sample("depth 16", (_meta(n, 2), _meta(2), _meta()))],
        "attractive_ell": [Sample(f"W={k}, p_len", (_meta(n, 2), _meta(n, k, dtype=i32),
                                                    _meta(n, k), _meta(n, dtype=i32)))],
        "fft_spread": [Sample(f"{nodes} nodes, 3 charges", (*interp, _meta(n, 3), nodes))],
        "fft_gather": [Sample(f"{nodes} nodes", (_meta(nodes, nodes, 4), *interp))],
        "bh_traverse": [Sample("compressed tree", _walk_args(n, True), plain_args=small_walk),
                        Sample("uncompressed tree", _walk_args(n, False),
                               plain_args=small_walk)],
    }


def check_registry(ns=ENVELOPES, registry: dict | None = None) -> list[Finding]:
    """Validate every ``kernel_registry()`` entry at each point count of
    ``ns``: launch geometry (KC201/202/204) and plain/cuda parity (KC203)."""
    reg = registry if registry is not None else ops.kernel_registry()
    findings: list[Finding] = []
    for n in ns:
        samples = _samples(n)
        for name in sorted(reg):
            if name not in samples:
                findings.append(Finding(
                    code="KC200", path=f"<{name}>", line=0, scope=name,
                    message="registry entry has no declared sample: add one "
                            "to analysis/launch_contracts._samples"))
                continue
            entry = reg[name]
            for s in samples[name]:
                findings.extend(check_kernel_callable(
                    f"{name}[N={n}, {s.label}]", entry["cuda"], s.args, s.kwargs,
                    plain=entry["plain"], plain_args=s.plain_args))
    return findings
