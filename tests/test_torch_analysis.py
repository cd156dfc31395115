"""repro_torch.analysis against repro.analysis: findings and concurrency
parity on shared inputs, the host-sync pass on its fixture, the hot-path
set pinned to the reference's jit sites, the launch-contract pass over the
registry and its fixture, the gate/baseline workflow, and the self-check
that the shipped port gates clean.  No kernel runs: the launch-contract
pass calls the CUDA wrappers on meta tensors."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import concurrency as jconcurrency  # noqa: E402
from repro.analysis import findings as jfmod  # noqa: E402
from repro_torch.analysis import concurrency, findings as fmod, hostsync  # noqa: E402
from repro_torch.analysis import launch_contracts  # noqa: E402
from repro_torch.analysis.cli import DEFAULT_BASELINE, DEFAULT_SCAN, main  # noqa: E402
from repro_torch.analysis.findings import Severity  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "fixtures" / "analysis_torch"
REF_FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
HOSTSYNC_REL = "tests/fixtures/analysis_torch/hostsync_bad.py"


def hostsync_fixture(source: str | None = None):
    """The host-sync pass over its fixture, every ``hot_*`` function hot."""
    src = source if source is not None else (FIXTURES / "hostsync_bad.py").read_text()
    hot = {f"{HOSTSYNC_REL}::{n.name}" for n in ast.parse(src).body
           if isinstance(n, ast.FunctionDef) and n.name.startswith("hot_")}
    return hostsync.scan_source(src, HOSTSYNC_REL, hot)


def expected_lines(path: Path) -> dict[str, list[int]]:
    """code -> the fixture lines whose trailing comment names it (once per mention)."""
    out: dict[str, list[int]] = {}
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        if "#" in line:
            for code in re.findall(r"\b(RT10\d)\b", line.split("#", 1)[1]):
                out.setdefault(code, []).append(i)
    return out


# ------------------------------------------------------------ host sync -----
class TestHostSync:
    def test_every_code_fires_at_its_lines(self):
        got: dict[str, list[int]] = {}
        for f in hostsync_fixture():
            got.setdefault(f.code, []).append(f.line)
        assert {c: sorted(v) for c, v in got.items()} == expected_lines(
            FIXTURES / "hostsync_bad.py")
        assert set(got) == {"RT101", "RT102", "RT104", "RT105"}

    def test_scopes_and_messages(self):
        found = hostsync_fixture()
        nested = [f for f in found if f.scope == "hot_outer.inner"]
        assert [f.code for f in nested] == ["RT101"] and "bool(x.any())" in nested[0].message
        (rt102,) = [f for f in found if f.code == "RT102"]
        assert "build_and_call" in rt102.message
        assert all(f.scope != "cold_reads" for f in found)
        assert all(f.scope != "spanned_sync" for f in found)

    def test_severities(self):
        sev = {f.code: f.severity for f in hostsync_fixture()}
        assert sev["RT101"] == Severity.ERROR and sev["RT102"] == Severity.ERROR
        assert sev["RT104"] == Severity.WARNING and sev["RT105"] == Severity.WARNING

    def test_no_rt103(self):
        assert "RT103" not in fmod.CODES and "RT103" in jfmod.CODES
        assert "RT103" in fmod.__doc__

    def test_module_level_compile_and_init_sanctioned(self):
        src = ("import torch\n"
               "fast = torch.compile(lambda x: x + 1)\n"
               "@torch.compile\n"
               "def fine(x):\n"
               "    return x * 2\n"
               "class Engine:\n"
               "    def __init__(self, model):\n"
               "        self._step = torch.compile(model.step)\n")
        assert hostsync.scan_source(src, "m.py") == []

    def test_obs_is_exempt_from_rt105(self):
        src = "import torch\ndef sync():\n    torch.cuda.synchronize()\n"
        assert hostsync.scan_source(src, "src/repro_torch/obs/x.py") == []
        assert [f.code for f in hostsync.scan_source(src, "src/repro_torch/core/x.py")] \
            == ["RT105"]


# --------------------------------------------------------- hot-path pin -----
def _jitted(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        text = ast.unparse(dec)
        if text in ("jax.jit", "jit") or re.match(r"(functools\.)?partial\((jax\.)?jit\b", text) \
                or re.match(r"(jax\.)?jit\(", text):
            return True
    return False


def _qualnames(tree: ast.Module):
    """(qualname, def) of every function, methods as Class.method."""
    def walk(body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield prefix + node.name, node
                yield from walk(node.body, prefix + node.name + ".")
            elif isinstance(node, ast.ClassDef):
                yield from walk(node.body, prefix + node.name + ".")
    yield from walk(tree.body, "")


class TestHotPaths:
    def test_hot_paths_pin_the_reference_jit_sites(self):
        ref_root, port_root = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
        jitted = set()
        for path in sorted(ref_root.rglob("*.py")):
            rel = path.relative_to(ref_root).as_posix()
            if not (port_root / rel).exists():      # only the modules the port mirrors
                continue
            for qual, fn in _qualnames(ast.parse(path.read_text())):
                if _jitted(fn):
                    key = f"{rel}::{qual}"
                    jitted.add(f"src/repro_torch/{hostsync.RENAMED.get(key, key)}")
        assert jitted == set(hostsync.JIT_COUNTERPARTS)
        assert hostsync.HOT_PATHS == hostsync.JIT_COUNTERPARTS | hostsync.STEP_PATHS
        assert {p.partition("::")[2] for p in hostsync.STEP_PATHS} == {
            "descend", "local_bh_gradient", "distributed_bh_gradient",
            "gd_update_sharded", "EmbeddingService.step", "ServeEngine.step",
            "make_train_step"}

    def test_every_hot_path_names_a_port_function(self):
        for entry in sorted(hostsync.HOT_PATHS):
            path, _, qual = entry.partition("::")
            quals = dict(_qualnames(ast.parse((ROOT / path).read_text())))
            assert qual in quals, entry


# --------------------------------------------------------- concurrency -----
class TestConcurrency:
    @pytest.mark.parametrize("path", [
        REF_FIXTURES / "concurrency_bad.py",
        ROOT / "src" / "repro" / "embed" / "service.py",
        ROOT / "src" / "repro_torch" / "embed" / "service.py",
    ], ids=["fixture", "repro_service", "repro_torch_service"])
    def test_parity_with_reference(self, path):
        src = path.read_text()
        rel = path.relative_to(ROOT).as_posix()
        ours = [(f.code, f.line, f.scope, f.message) for f in concurrency.scan_source(src, rel)]
        ref = [(f.code, f.line, f.scope, f.message)
               for f in jconcurrency.scan_source(src, rel)]
        assert ours == ref

    def test_codes_and_sites(self):
        found = concurrency.scan_source(
            (REF_FIXTURES / "concurrency_bad.py").read_text(), "c.py")
        assert {f.scope for f in found if f.code == "CC301"} == {
            "LeakyQueue.take", "LeakyQueue.finish"}
        assert [f.scope for f in found if f.code == "CC302"] == ["LeakyQueue.wait_any"]

    def test_port_service_is_clean(self):
        path = ROOT / "src" / "repro_torch" / "embed" / "service.py"
        assert concurrency.scan_source(path.read_text(), "s.py") == []


# ------------------------------------------------- findings parity --------
SHARED = [
    ("RT101", "a.py", 3, "m1", "f"), ("RT101", "a.py", 9, "m2", "f"),
    ("RT104", "a.py", 5, "m3", "g"), ("RT105", "b.py", 2, "m4", ""),
    ("KC202", "c.cu", 7, "m5", "k"), ("CC301", "d.py", 4, "m6", "C.m"),
    ("CC302", "d.py", 11, "m7", "C.w"), ("RT102", "b.py", 8, "m8", "h"),
]
PRAGMA_SOURCES = [
    "x = 1  # repro-lint: disable=RT101\n",
    "# repro-lint: disable=RT101,CC301\ny = 2\n",
    "a\n#repro-lint:disable=all\nb\n",
    "z = 3  # repro-lint: disable=RT105 -- the stage clock\n",
    "# repro-lint: enable=RT101\nw\n",
]


def _both(pkg):
    return [pkg.Finding(code=c, path=p, line=ln, message=m, scope=s)
            for c, p, ln, m, s in SHARED]


def _summary(fs):
    return [(f.code, f.path, f.line, f.scope, f.suppressed, str(f.severity)) for f in fs]


class TestFindingsParity:
    @pytest.mark.parametrize("src", PRAGMA_SOURCES)
    def test_scan_pragmas(self, src):
        assert fmod.scan_pragmas(src) == jfmod.scan_pragmas(src)

    def test_apply_pragmas(self):
        pragmas = {3: {"RT101"}, 4: {"all"}, 8: {"RT101"}, 11: {"CC302"}}
        assert _summary(fmod.apply_pragmas(_both(fmod), pragmas)) == \
            _summary(jfmod.apply_pragmas(_both(jfmod), pragmas))

    def test_fingerprints_and_gate(self):
        ours, ref = _both(fmod), _both(jfmod)
        assert set(fmod.fingerprints(ours)) == set(jfmod.fingerprints(ref))
        baseline = {fp: {} for fp in list(jfmod.fingerprints(ref))[:3]}
        baseline["RT101:gone.py:f#0"] = {}
        for sev in ("INFO", "WARNING", "ERROR"):
            a = fmod.gate(ours, baseline, fmod.Severity[sev])
            b = jfmod.gate(ref, baseline, jfmod.Severity[sev])
            assert (set(a.new), set(a.known), set(a.stale), a.ok) == \
                (set(b.new), set(b.known), set(b.stale), b.ok)

    def test_baseline_files_are_interchangeable(self, tmp_path):
        fmod.save_baseline(tmp_path / "a.json", fmod.fingerprints(_both(fmod)))
        jfmod.save_baseline(tmp_path / "b.json", jfmod.fingerprints(_both(jfmod)))
        assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
        assert fmod.load_baseline(tmp_path / "b.json") == jfmod.load_baseline(tmp_path / "a.json")


# ------------------------------------------------------------- pragmas -----
class TestPragmas:
    def _with_pragma(self, code: str) -> str:
        src = (FIXTURES / "hostsync_bad.py").read_text()
        return src.replace("return x.sum().item()  ",
                           f"return x.sum().item()  # repro-lint: disable={code}", 1)

    def test_pragma_suppresses(self):
        src = self._with_pragma("RT101")
        found = fmod.apply_pragmas(hostsync_fixture(src), fmod.scan_pragmas(src))
        (item,) = [f for f in found if f.scope == "hot_item"]
        assert item.suppressed
        assert sum(f.suppressed for f in found) == 1

    def test_wrong_code_does_not_suppress(self):
        src = self._with_pragma("RT104")
        found = fmod.apply_pragmas(hostsync_fixture(src), fmod.scan_pragmas(src))
        assert not any(f.suppressed for f in found)

    def test_suppressed_findings_do_not_gate(self):
        src = self._with_pragma("all")
        found = fmod.apply_pragmas(hostsync_fixture(src), fmod.scan_pragmas(src))
        rest = [f for f in found if f.scope != "hot_item"]
        assert fmod.gate(found, fmod.fingerprints(rest)).ok


# ---------------------------------------------------- launch contracts -----
class TestLaunchContracts:
    @pytest.fixture(scope="class")
    def cases(self):
        sys.path.insert(0, str(FIXTURES))
        try:
            import torch_kernel_fixture_mod as mod
            return mod, {c[0]: c[1:] for c in mod.kernel_cases()}
        finally:
            sys.path.remove(str(FIXTURES))

    @pytest.mark.parametrize("case,code", [
        ("no_launch", "KC200"),
        ("half_grid", "KC201"),
        ("morton_past_int32", "KC202"),
        ("morton_int32_twin", "KC203"),
        ("smem_blowout", "KC204"),
    ])
    def test_bad_contract_rejected_once(self, cases, case, code):
        mod, table = cases
        fn, args, kwargs, *plain = table[case]
        found = launch_contracts.check_kernel_callable(
            case, fn, args, kwargs, plain=plain[0] if plain else None,
            plan_fn=mod.launch_plan)
        assert [f.code for f in found] == [code], [f.format() for f in found]

    @pytest.mark.parametrize("n", launch_contracts.ENVELOPES)
    def test_registry_all_entries_clean(self, n):
        from repro_torch.kernels.ops import kernel_registry
        assert set(kernel_registry()) == {
            "pairwise_sq_dists", "bsp_search", "morton_encode", "attractive_ell",
            "fft_spread", "fft_gather", "bh_traverse"}
        assert launch_contracts.check_registry(ns=(n,)) == []

    def test_every_kernel_launch_is_recorded(self):
        records = []
        samples = launch_contracts._samples(launch_contracts.N_PAPER)
        from repro_torch.kernels.ops import kernel_registry
        with launch_contracts.record_launches(records):
            for name, entry in kernel_registry().items():
                for s in samples[name]:
                    entry["cuda"](*s.args, **s.kwargs)
        assert {r.name for r in records} == set(kernel_registry())
        mort = next(r for r in records if r.name == "morton_encode")
        assert mort.values == (launch_contracts.N_PAPER, 16)

    def test_unsampled_entry_is_kc200(self):
        from repro_torch.kernels.ops import kernel_registry
        reg = dict(kernel_registry(), extra=dict(kernel_registry()["morton_encode"]))
        found = launch_contracts.check_registry(ns=(launch_contracts.N_REFERENCE,),
                                                registry=reg)
        assert [f.code for f in found] == ["KC200"] and found[0].scope == "extra"

    def test_pass_takes_meta_tensors_and_restores_launch(self):
        import torch
        from repro_torch.kernels import ops
        orig, counts = ops._launch, dict(ops.LAUNCHES)
        for samples in launch_contracts._samples(launch_contracts.N_PAPER).values():
            for s in samples:
                tensors = [t for t in s.args if isinstance(t, torch.Tensor)]
                tensors += [t for a in s.args if isinstance(a, tuple) for t in a
                            if isinstance(t, torch.Tensor)]
                assert tensors and all(t.device.type == "meta" for t in tensors)
        assert launch_contracts.check_registry(ns=(launch_contracts.N_REFERENCE,)) == []
        assert ops._launch is orig and ops.LAUNCHES == counts


# ------------------------------------------------------ gate / baseline ----
class TestGateWorkflow:
    def test_fingerprints_ignore_line_numbers(self):
        src = (FIXTURES / "hostsync_bad.py").read_text()
        a = fmod.fingerprints(hostsync_fixture(src))
        b = fmod.fingerprints(hostsync_fixture("# padding\n# padding\n" + src))
        assert set(a) == set(b)

    def test_baseline_roundtrip_and_gate(self, tmp_path):
        found = hostsync_fixture()
        assert not fmod.gate(found, {}).ok
        path = tmp_path / "baseline.json"
        fmod.save_baseline(path, fmod.fingerprints(found))
        baseline = fmod.load_baseline(path)
        result = fmod.gate(found, baseline)
        assert result.ok and not result.stale
        fewer = [f for f in found if f.code != "RT102"]
        result = fmod.gate(fewer, baseline)
        assert result.ok and len(result.stale) == 1

    @pytest.mark.parametrize("args", [
        [str(FIXTURES / "hostsync_bad.py"), "--passes", "hostsync"],
        [str(REF_FIXTURES / "concurrency_bad.py"), "--passes", "concurrency"],
        ["--passes", "kernels", "--kernels-from", "torch_kernel_fixture_mod", str(FIXTURES)],
    ], ids=["hostsync", "concurrency", "kernels"])
    def test_gate_cli_nonzero_per_fixture_class(self, args, tmp_path, capsys, monkeypatch):
        monkeypatch.syspath_prepend(str(FIXTURES))
        rc = main([*args, "--gate", "--baseline", str(tmp_path / "missing.json")])
        capsys.readouterr()
        assert rc == 1

    def test_write_baseline_refuses_to_grow(self, tmp_path, capsys):
        path = tmp_path / "baseline.json"
        fmod.save_baseline(path, {})
        argv = [str(FIXTURES / "hostsync_bad.py"), "--passes", "hostsync",
                "--write-baseline", "--baseline", str(path)]
        rc = main(argv)
        capsys.readouterr()
        assert rc == 1 and fmod.load_baseline(path) == {}
        rc = main([*argv, "--allow-grow"])
        capsys.readouterr()
        assert rc == 0 and fmod.load_baseline(path)

    def test_json_report(self, tmp_path, capsys):
        rc = main([str(FIXTURES / "hostsync_bad.py"), "--passes", "hostsync", "--json",
                   "--baseline", str(tmp_path / "missing.json")])
        doc = json.loads(capsys.readouterr().out)
        assert rc == 0 and {f["code"] for f in doc["findings"]} == {"RT102", "RT105"}
        assert len(doc["new"]) == 3


# ----------------------------------------------------------- self-check ----
class TestShippedTree:
    def test_port_gates_clean_against_committed_baseline(self, capsys):
        """All three passes over src/repro_torch against ANALYSIS_BASELINE_TORCH.json."""
        rc = main([str(DEFAULT_SCAN), "--gate"])
        out = capsys.readouterr().out
        assert rc == 0, out

    def test_every_port_pragma_gives_a_reason(self):
        lines = []
        for path in sorted(DEFAULT_SCAN.rglob("*.py")):
            for i, text in enumerate(path.read_text().splitlines(), start=1):
                if "repro-lint: disable=" in text and path.parent.name != "analysis":
                    lines.append((path.name, i, text))
        assert lines
        assert all(re.search(r"disable=[A-Z0-9,]+ -- \S", t) for _, _, t in lines), lines

    def test_committed_baseline_parses(self):
        doc = json.loads(DEFAULT_BASELINE.read_text())
        assert doc["version"] == 1
        assert DEFAULT_BASELINE.name == "ANALYSIS_BASELINE_TORCH.json"


def test_analysis_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "from repro_torch.analysis.cli import main\n"
            "rc = main(['--gate'])\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert rc == 0, rc\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
