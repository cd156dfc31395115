"""``python -m repro_torch.analysis``: run the port's static-analysis suite.

Port of ``repro.analysis.cli``, with the same flags, finding format,
pragmas and baseline workflow.  Three passes (selectable with
``--passes``):

* ``hostsync``    -- host reads and global draws on the step path, raw
  device syncs outside spans (RT1xx), AST over ``.py`` files;
* ``concurrency`` -- lock discipline in threaded classes (CC3xx);
* ``kernels``     -- CUDA launch contracts of every ``kernel_registry()``
  entry (KC2xx), from the wrappers called on meta tensors: no kernel runs
  and no device memory is taken (ignores the path arguments).

Typical invocations::

    python -m repro_torch.analysis                     # report, exit 0
    python -m repro_torch.analysis --gate              # fail on new findings
    python -m repro_torch.analysis --gate --fix-hints  # ...with per-code hints
    python -m repro_torch.analysis src/repro_torch/embed   # scope to a subtree
    python -m repro_torch.analysis --write-baseline    # prune fixed entries

The gate compares against the checked-in ``ANALYSIS_BASELINE_TORCH.json``:
*new* findings (not in the baseline, severity >= warning, not pragma-
suppressed) fail the build; *stale* entries (fixed findings still in the
baseline) are reported so ``--write-baseline`` can prune them.
``--write-baseline`` refuses to *add* entries unless ``--allow-grow`` is
given: the baseline only shrinks.  The codes and workflow are the
reference's (docs/ANALYSIS.md).
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

from repro_torch.analysis import concurrency, findings as fmod, hostsync
from repro_torch.analysis.findings import Finding, Severity

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_SCAN = REPO_ROOT / "src" / "repro_torch"
DEFAULT_BASELINE = REPO_ROOT / "ANALYSIS_BASELINE_TORCH.json"
PASSES = ("hostsync", "concurrency", "kernels")


def iter_py_files(paths: list[Path]) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    return out


def _relpath(path: Path) -> str:
    try:
        return path.resolve().relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return path.as_posix()


def scan_files(paths: list[Path], passes: tuple[str, ...]) -> list[Finding]:
    """AST passes + pragma application over every file under ``paths``."""
    out: list[Finding] = []
    for path in iter_py_files(paths):
        source = path.read_text()
        rel = _relpath(path)
        file_findings: list[Finding] = []
        if "hostsync" in passes:
            file_findings.extend(hostsync.scan_source(source, rel))
        if "concurrency" in passes:
            file_findings.extend(concurrency.scan_source(source, rel))
        out.extend(fmod.apply_pragmas(file_findings,
                                      fmod.scan_pragmas(source)))
    return out


def run_kernel_pass(kernels_from: str | None = None) -> list[Finding]:
    from repro_torch.analysis import launch_contracts

    if kernels_from:
        # MODULE.kernel_cases() yields (name, cuda wrapper, meta args, kwargs)
        # and optionally the plain twin; MODULE.launch_plan, if defined,
        # gives the plans of kernels the registry does not know
        mod = importlib.import_module(kernels_from)
        plan_fn = getattr(mod, "launch_plan", None)
        out: list[Finding] = []
        for name, fn, args, kwargs, *plain in mod.kernel_cases():
            out.extend(launch_contracts.check_kernel_callable(
                name, fn, args, kwargs, plain=plain[0] if plain else None,
                plan_fn=plan_fn))
        return out
    return launch_contracts.check_registry()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis: host syncs on the step path, CUDA "
                    "launch contracts, lock discipline")
    ap.add_argument("paths", nargs="*", type=Path,
                    help=f"files/dirs to scan (default: {DEFAULT_SCAN})")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help=f"comma-separated subset of {','.join(PASSES)}")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                    help="baseline JSON (missing file = empty baseline)")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 on findings not covered by the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline: prune fixed entries "
                         "(never adds unless --allow-grow)")
    ap.add_argument("--allow-grow", action="store_true",
                    help="let --write-baseline record NEW findings too")
    ap.add_argument("--fix-hints", action="store_true",
                    help="print a fix hint under each finding")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print pragma-suppressed findings")
    ap.add_argument("--min-severity", default="warning",
                    choices=[s.name.lower() for s in Severity],
                    help="severity floor for gating/baseline (default: "
                         "warning; the report always shows everything)")
    ap.add_argument("--kernels-from", default=None, metavar="MODULE",
                    help="validate MODULE.kernel_cases() instead of the "
                         "port's kernel registry (fixture/testing hook)")
    args = ap.parse_args(argv)

    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    unknown = set(passes) - set(PASSES)
    if unknown:
        ap.error(f"unknown pass(es): {', '.join(sorted(unknown))} "
                 f"(known: {', '.join(PASSES)})")

    scan_paths = args.paths or [DEFAULT_SCAN]
    all_findings = scan_files(scan_paths, passes)
    if "kernels" in passes:
        all_findings.extend(run_kernel_pass(args.kernels_from))

    min_sev = Severity[args.min_severity.upper()]
    baseline = fmod.load_baseline(args.baseline)
    result = fmod.gate(all_findings, baseline, min_severity=min_sev)

    shown = [f for f in sorted(all_findings, key=lambda f: (f.path, f.line))
             if args.show_suppressed or not f.suppressed]
    if args.as_json:
        print(json.dumps({
            "findings": [dataclass_dict(f) for f in shown],
            "new": sorted(result.new),
            "known": sorted(result.known),
            "stale": sorted(result.stale),
        }, indent=2))
    else:
        for f in shown:
            print(f.format(fix_hints=args.fix_hints))
        n_sup = sum(f.suppressed for f in all_findings)
        print(f"\n{len(shown)} finding(s) "
              f"({len(result.new)} new, {len(result.known)} baselined, "
              f"{n_sup} suppressed by pragma, "
              f"{len(result.stale)} stale baseline entr{'y' if len(result.stale) == 1 else 'ies'})")
        if result.stale and not args.write_baseline:
            print("stale baseline entries — findings fixed since the "
                  "baseline was written; prune with --write-baseline:")
            for fp in sorted(result.stale):
                print(f"  - {fp}")

    if args.write_baseline:
        keep = dict(result.known)
        if args.allow_grow:
            keep.update(result.new)
        elif result.new:
            print(f"refusing to add {len(result.new)} new finding(s) to the "
                  "baseline (it only shrinks); fix them, pragma them, or "
                  "pass --allow-grow", file=sys.stderr)
            fmod.save_baseline(args.baseline, keep)
            return 1
        fmod.save_baseline(args.baseline, keep)
        print(f"baseline written: {args.baseline} ({len(keep)} entr"
              f"{'y' if len(keep) == 1 else 'ies'})")
        return 0

    if args.gate and not result.ok:
        print(f"\nGATE FAILED: {len(result.new)} finding(s) not in the "
              f"baseline ({args.baseline}):", file=sys.stderr)
        for fp, f in sorted(result.new.items()):
            print(f"  {f.format(fix_hints=args.fix_hints)}", file=sys.stderr)
        return 1
    return 0


def dataclass_dict(f: Finding) -> dict:
    return dict(code=f.code, severity=str(f.severity), path=f.path,
                line=f.line, scope=f.scope, message=f.message,
                suppressed=f.suppressed)


if __name__ == "__main__":
    sys.exit(main())
