"""The port's dry-run tooling (``repro_torch.launch.{mesh,cell,dryrun}``,
``distributed.sharding``'s rules, ``model.input_specs`` and the abstract
path of ``build_model``) against the JAX package on the CPU, on all 64
(architecture x shape x production mesh) cells.

The reference's side needs no devices: ``jax.sharding.AbstractMesh`` of
the two production shapes, ``jax.eval_shape`` of its init and optimizer
init, its ``cell_rules``, ``params_shardings``, ``cache_shardings`` and
``batch_shardings``, and ``NamedSharding(AbstractMesh, spec).shard_shape``
for the bytes a device holds.  Every comparison is exact: shapes, dtypes,
specs (a ``PartitionSpec``'s entries against the port's ``Spec``), bytes
and FLOP counts.  The one difference allowed is stated where it is made:
the optimizer's step counter is a host int in the port and a 4-byte int32
scalar operand in the reference.
"""
import dataclasses
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import cell as jcell  # noqa: E402
from repro.launch.hlo_analysis import model_flops as jmodel_flops  # noqa: E402
from repro.distributed.sharding import params_shardings as jparams_shardings  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.train.step import make_opt_init as jmake_opt_init  # noqa: E402
from repro.train.step import opt_config_for as jopt_config_for  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.distributed.sharding import Spec  # noqa: E402
from repro_torch.launch import cost, dryrun  # noqa: E402
from repro_torch.launch.cell import Cell, build_cell  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_production_mesh, mesh_dp_size, mesh_tp_size,
)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import Stacked, tree_leaves_with_path  # noqa: E402

MESHES = {"pod256": False, "pod512": True}
CELLS = [(a, s, m) for a in configs.ARCH_IDS for s in configs.SHAPES for m in MESHES
         if s not in configs.get_config(a).skip_shapes]
SKIPPED = [(a, s) for a in configs.ARCH_IDS for s in configs.SHAPES
           if s in configs.get_config(a).skip_shapes]


def _abstract_mesh(multi_pod: bool) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _path(p) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)


def _ref_leaves(tree) -> dict:
    """path -> leaf of a JAX pytree (None subtrees have no leaves)."""
    return {_path(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree, is_leaf=None) -> dict:
    out = {}
    for p, x in tree_leaves_with_path(tree, is_leaf=is_leaf or (lambda x: x is None)):
        if x is not None:
            out["/".join(p)] = x
    return out


def _stacked(x) -> bool:
    return x is None or isinstance(x, Stacked)


def _spec_leaves(tree) -> dict:
    return _port_leaves(tree, is_leaf=lambda x: x is None or isinstance(x, Spec))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _ref_arch(arch: str):
    """The reference's abstract parameters and optimizer state of an arch."""
    cfg = jconfigs.get_config(arch)
    model = jbuild_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(jmake_opt_init(model, jopt_config_for(cfg)), params)
    return cfg, model, params, opt


def _ref_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """The reference's cell as ``repro.launch.cell.build_cell`` builds it,
    short of jit: rules, abstract operands and their shardings."""
    cfg, model, params, opt = _ref_arch(arch)
    shape = jconfigs.SHAPES[shape_name]
    mesh = _abstract_mesh(multi_pod)
    rules = jcell.cell_rules(cfg, shape, mesh)
    specs = model.input_specs(shape)
    p_sh = jparams_shardings(params, mesh, rules)
    if shape.kind == "train":
        args = {"params": params, "m": opt.m, "v": opt.v, "step": opt.step, "batch": specs}
        sh = {"params": p_sh, "m": jparams_shardings(opt.m, mesh, rules),
              "v": jparams_shardings(opt.v, mesh, rules),
              "step": NamedSharding(mesh, jax.sharding.PartitionSpec()),
              "batch": jcell.batch_shardings(specs, mesh, rules)}
    elif shape.kind == "prefill":
        args = {"params": params, "batch": specs}
        sh = {"params": p_sh, "batch": jcell.batch_shardings(specs, mesh, rules)}
    else:
        tok = jcell.batch_shardings({"token": specs["token"], "pos": specs["pos"]}, mesh, rules)
        args = {"params": params, "cache": specs["cache"], "token": specs["token"],
                "pos": specs["pos"]}
        sh = {"params": p_sh,
              "cache": jcell.cache_shardings(specs["cache"], cfg, shape, mesh, rules),
              "token": tok["token"], "pos": tok["pos"]}
    arg_bytes = sum(
        int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
        for x, s in zip(jax.tree_util.tree_leaves(args), jax.tree_util.tree_leaves(sh)))
    return dict(cfg=cfg, shape=shape, rules=rules, specs=specs, args=args, sh=sh,
                arg_bytes=arg_bytes)


def _port_parts(cell: Cell) -> tuple[dict, dict]:
    """The port cell's operands and specs under the reference's names."""
    kind = cell.shape.kind
    if kind == "train":
        params, opt, batch = cell.args
        p_sh, o_sh, b_sh = cell.specs
        return ({"params": params.reference_tree(), "m": opt.m, "v": opt.v, "batch": batch},
                {"params": p_sh, "m": o_sh.m, "v": o_sh.v, "batch": b_sh})
    if kind == "prefill":
        return ({"params": cell.args[0].reference_tree(), "batch": cell.args[1]},
                {"params": cell.specs[0], "batch": cell.specs[1]})
    return (dict(zip(("params", "cache", "token", "pos"),
                     (cell.args[0].reference_tree(), *cell.args[1:]))),
            dict(zip(("params", "cache", "token", "pos"), cell.specs)))


@pytest.mark.parametrize("arch,shape_name,mesh_tag", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_cell_matches_reference(arch, shape_name, mesh_tag):
    """One cell: input specs, rules, every leaf's shape, dtype and spec,
    the argument bytes a device holds, model FLOPs and parameter counts."""
    multi_pod = MESHES[mesh_tag]
    ref = _ref_cell(arch, shape_name, multi_pod)
    cell = build_cell(arch, shape_name, make_production_mesh(multi_pod=multi_pod))

    # input_specs: the same keys, shapes and dtypes (decode's cache leaf by leaf)
    port_in = _port_leaves(cell.model.input_specs(cell.shape))
    ref_in = _ref_leaves(ref["specs"])
    assert port_in.keys() == ref_in.keys()
    for k, x in ref_in.items():
        assert (tuple(port_in[k].shape), _dtype(port_in[k])) == (tuple(x.shape), _dtype(x)), k
        assert port_in[k].device.type == "meta"

    assert cell.rules == ref["rules"]

    # every operand leaf: shape, dtype and spec
    args, specs = _port_parts(cell)
    for part, ref_tree in ref["args"].items():
        if part == "step":
            continue
        port_leaves = _port_leaves(args[part], is_leaf=_stacked)
        ref_leaves = _ref_leaves(ref_tree)
        assert port_leaves.keys() == ref_leaves.keys(), part
        port_specs = _spec_leaves(specs[part])
        ref_specs = {k: tuple(s.spec) for k, s in _ref_leaves(ref["sh"][part]).items()}
        assert port_specs == ref_specs, part
        for k, x in ref_leaves.items():
            y = port_leaves[k]
            dt = _dtype(y[0] if isinstance(y, Stacked) else y)
            assert (tuple(y.shape), dt) == (tuple(x.shape), _dtype(x)), (part, k)

    # bytes a device holds: the reference's also count its int32 step scalar
    mem = cost.memory_per_device(cell)
    step_bytes = 4 if cell.shape.kind == "train" else 0
    assert mem["argument_size_in_bytes"] + step_bytes == ref["arg_bytes"]

    total, active = configs.param_count(cell.cfg)
    assert (total, active) == jconfigs.param_count(ref["cfg"])
    assert cost.model_flops(cell.cfg, cell.shape, active) == \
        jmodel_flops(ref["cfg"], ref["shape"], active)


def test_skipped_shapes_raise():
    mesh = make_production_mesh()
    assert len(CELLS) == 64 and len(SKIPPED) == 8
    for arch, shape_name in SKIPPED:
        with pytest.raises(ValueError, match=f"{arch} skips {shape_name}"):
            build_cell(arch, shape_name, mesh)
        with pytest.raises(ValueError, match=f"{arch} skips"):
            jcell.build_cell(arch, shape_name, _abstract_mesh(False))


def test_production_meshes():
    for multi_pod in (False, True):
        mesh, ref = make_production_mesh(multi_pod=multi_pod), _abstract_mesh(multi_pod)
        assert mesh.axis_names == ref.axis_names
        assert mesh.shape == dict(ref.shape) and mesh.size == ref.size
        assert (mesh_dp_size(mesh), mesh_tp_size(mesh)) == (16 * (1 + multi_pod), 16)


def test_abstract_init_has_reference_leaves(monkeypatch):
    """``build_model(cfg, "meta").init()`` draws nothing: every leaf is a
    meta tensor with the reference's shape and dtype (the float32 leaves
    among bf16 ones too).  The abstract path is no way onto the CPU, and
    no device but ``build_model``'s takes meta."""
    for arch in ("deepseek_v3_671b", "rwkv6_3b", "zamba2_2p7b", "whisper_tiny"):
        params = build_model(configs.get_config(arch), device="meta").init()
        got = _port_leaves(params.reference_tree(), is_leaf=_stacked)
        want = _ref_leaves(_ref_arch(arch)[2])
        assert got.keys() == want.keys()
        for k, x in want.items():
            y = got[k]
            t = y[0] if isinstance(y, Stacked) else y
            assert t.device.type == "meta", k
            assert (tuple(y.shape), _dtype(t)) == (tuple(x.shape), _dtype(x)), k
    model = build_model(configs.get_reduced_config("deepseek_7b"), device="meta")
    with pytest.raises(ValueError, match="generator"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="needs a generator"):
        build_model(configs.get_reduced_config("deepseek_7b"), device="cpu").init()
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("meta", abstract=True).type == "meta"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None, abstract=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(configs.get_reduced_config("deepseek_7b"))


def test_run_cell_writes_record(tmp_path):
    """One small full-size cell through the CLI's ``run_cell``: ``ok``, the
    reference's keys where they have a counterpart, ``count_s`` for
    ``lower_s`` / ``compile_s``; a skipping arch's long_500k is recorded
    as skipped."""
    counted = {}
    rec = dryrun.run_cell("whisper_tiny", "decode_32k", False, tmp_path, counted)
    on_disk = json.loads((tmp_path / "whisper_tiny__decode_32k__pod256.json").read_text())
    assert on_disk["ok"] and not on_disk["skipped"] and on_disk == json.loads(json.dumps(rec))
    for key in ("arch", "shape", "mesh", "count_s", "n_devices", "memory", "cost_per_device",
                "collectives_per_device", "roofline", "params_total", "params_active"):
        assert key in rec, key
    assert "lower_s" not in rec and "compile_s" not in rec
    assert rec["collectives_counted"] == "params" and rec["n_devices"] == 256
    for key in ("argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes",
                "peak_live_bytes_global"):
        assert rec["memory"][key] > 0, key
    for key in ("compute_s", "memory_s", "collective_s", "dominant", "bound_time_s",
                "hlo_flops_global", "hlo_bytes_global", "collective_bytes_global",
                "model_flops", "useful_fraction"):
        assert key in rec["roofline"], key
    assert set(cost.COLLECTIVES) | {"total"} == set(rec["collectives_per_device"])
    roof = rec["roofline"]
    assert roof["bound_time_s"] == max(roof["compute_s"], roof["memory_s"],
                                       roof["collective_s"])
    # the other mesh reuses the global count; its per-device share halves
    other = dryrun.run_cell("whisper_tiny", "decode_32k", True, tmp_path, counted)
    assert (rec["counts_reused"], other["counts_reused"]) == (False, True)
    assert other["cost_global"] == rec["cost_global"] and other["n_devices"] == 512
    assert other["cost_per_device"]["flops"] == rec["cost_per_device"]["flops"] / 2
    skip = dryrun.run_cell("rwkv6_3b", "long_500k", True, tmp_path)
    assert skip["ok"] and not skip.get("skipped")                # rwkv runs long_500k
    skip = dryrun.run_cell("deepseek_7b", "long_500k", True, tmp_path)
    assert skip == dict(arch="deepseek_7b", shape="long_500k", mesh="pod512", ok=True,
                        skipped=True, reason=configs.get_config("deepseek_7b").skip_reason)


def test_dryrun_main_exit_codes(tmp_path, monkeypatch):
    """The CLI exits 0 when every cell is ok or skipped, 1 when one fails
    (its record then holds ``error`` and ``traceback``)."""
    argv = ["--arch", "whisper_tiny", "--shape", "long_500k", "--both_meshes",
            "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    assert len(list(tmp_path.glob("*.json"))) == 2

    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "cell_report", broken)
    assert dryrun.main(["--arch", "whisper_tiny", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "whisper_tiny__decode_32k__pod256.json").read_text())
    assert not rec["ok"] and "planted" in rec["error"] and "traceback" in rec


def test_reduced_cell_memory_is_exact():
    """On a 1 x 1 mesh a device holds every operand whole: the argument
    bytes are the operands' ``nbytes`` (the held tensors' sum)."""
    from repro_torch.launch.cell import make_cell
    from repro_torch.launch.mesh import LogicalMesh
    mesh = LogicalMesh((1, 1), ("data", "model"))
    cfg = dataclasses.replace(configs.get_reduced_config("phi4_mini_3p8b"), grad_accum=2,
                              optimizer_factored=True)
    shape = configs.SHAPES["train_4k"].__class__("t", 32, 4, "train")
    cell = make_cell(cfg, shape, mesh)
    params, opt, batch = cell.args
    held = (sum(p.nbytes for p in params.parameters())
            + sum(t.nbytes for t in jax.tree_util.tree_leaves((opt.m, opt.v)))
            + sum(t.nbytes for t in batch.values()))
    mem = cost.memory_per_device(cell)
    assert mem["argument_size_in_bytes"] == held
    assert mem["alias_size_in_bytes"] == held - sum(t.nbytes for t in batch.values())
