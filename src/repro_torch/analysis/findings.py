"""Finding model shared by every analysis pass: codes, severities, pragmas,
and the checked-in baseline.

Port of ``repro.analysis.findings``, kept as its own copy (the port imports
nothing of ``repro``).  A :class:`Finding` is one diagnosed violation: a
stable ``code`` (RT1xx host-sync and reproducibility hazards on the step
path, KC2xx CUDA launch-contract breaches, CC3xx concurrency lint), a
severity from :data:`CODES`, a location, and a message/hint pair.  The
pieces that make findings *actionable over time* also live here:

* **pragmas**: ``# repro-lint: disable=RT101[,CC301|all]`` on the flagged
  line (or the line directly above it) suppresses matching findings; the
  scanner keeps them visible under ``--show-suppressed`` so waivers stay
  auditable;
* **baseline**: a JSON file of known-finding fingerprints.  The gate
  fails on any finding *not* in the baseline, and ``--write-baseline``
  only ever removes entries (``--allow-grow`` is the explicit override),
  so the baseline shrinks monotonically toward zero.

Fingerprints deliberately exclude line numbers (``code:path:scope`` plus
a per-scope occurrence index), so unrelated edits to a file don't churn
the baseline.

The code numbers are the reference's; titles and hints are restated for
eager PyTorch and CUDA.  RT103 (a non-hashable ``static_argnames`` entry)
has no counterpart: eager PyTorch has no static arguments and no trace
cache to key on them, so the number stays reserved and no pass emits it.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import re
from collections import Counter
from pathlib import Path


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error" in reports, not "Severity.ERROR"
        return self.name.lower()


# code -> (severity, one-line title, generic fix hint)
CODES: dict[str, tuple[Severity, str, str]] = {
    "RT101": (
        Severity.ERROR,
        "host read inside a hot-path function",
        "`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `float()`/`int()`/"
        "`bool()` of a tensor, `np.asarray`/`np.array` of a tensor and "
        "`torch.cuda.synchronize()` wait for the card and stall the queue of "
        "launches a step depends on; keep the value on the device (torch "
        "ops, `torch.where`) or move the read out of the step, to where the "
        "host needs it.",
    ),
    "RT102": (
        Severity.ERROR,
        "torch.compile / torch.jit created inside a function body",
        "a `torch.compile` / `torch.jit.script` / `torch.jit.trace` wrapper "
        "built per call compiles again every call. Build it once at module "
        "scope, or store it once (e.g. on `self` in `__init__`).",
    ),
    "RT104": (
        Severity.WARNING,
        "time/global-random call inside a hot-path function",
        "`time.*`, `random.*` and `np.random.*` put a host value into the "
        "step, and a torch draw without `generator=` reads the process-"
        "wide generator, so the step is not reproducible from its inputs "
        "(nor capturable as a CUDA graph). Pass the value in, or draw from "
        "a `torch.Generator` the caller seeds.",
    ),
    "RT105": (
        Severity.WARNING,
        "device synchronize outside a Tracer span",
        "a raw `torch.cuda.synchronize()` / `event.synchronize()` / "
        "`stream.synchronize()` wait is invisible to the profile and gets "
        "misattributed; use `with tracer.span(...) as sp: sp.sync(x)` "
        "(repro_torch/obs/tracer.py) so the wait is charged to the phase "
        "that launched the work.",
    ),
    "KC200": (
        Severity.ERROR,
        "launch contract could not be captured",
        "calling the kernel's CUDA wrapper on meta tensors raised, or it "
        "reached no `ops._launch`; the checker cannot vouch for this "
        "kernel's launch geometry.",
    ),
    "KC201": (
        Severity.ERROR,
        "grid does not cover the output",
        "grid x rows a block must reach every output row (or lattice band); "
        "compute the grid as ceil(extent / rows a block) in the C entry and "
        "mirror it in `ops.launch_plan`.",
    ),
    "KC202": (
        Severity.ERROR,
        "launch argument or grid out of range",
        "an integer bound as `ctypes.c_int` outside int32 wraps silently, "
        "and CUDA refuses grid.x > 2^31-1 and grid.y/z > 65535; widen the "
        "argument (`c_longlong` and 64-bit offsets in the kernel), chunk the "
        "call, or fold the large extent into grid.x.",
    ),
    "KC203": (
        Severity.ERROR,
        "plain/cuda output disagreement",
        "the plain PyTorch twin and the CUDA wrapper return different "
        "structures, shapes or dtypes for the same inputs; the wrapper must "
        "allocate its outputs as the twin returns them.",
    ),
    "KC204": (
        Severity.ERROR,
        "block exceeds the card's per-block limits",
        "a block of more than 1024 threads, or more dynamic shared memory "
        "than a block can opt into (232 448 B on Hopper), is refused at "
        "launch; shrink the tile or cap the offending config axis.",
    ),
    "CC301": (
        Severity.ERROR,
        "lock-inconsistent attribute access",
        "an attribute mutated under a lock is also touched without it (or "
        "vice versa) — either every cross-thread access takes the lock, "
        "or the attribute is single-thread-owned and should never be "
        "touched under the lock.",
    ),
    "CC302": (
        Severity.ERROR,
        "condition wait without a predicate loop",
        "`Condition.wait()` must sit in a `while <predicate>:` loop — "
        "wakeups are spurious and a bare or if-guarded wait() misses "
        "them.",
    ),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str
    path: str               # repo-relative POSIX path
    line: int               # 1-based
    message: str
    scope: str = ""         # dotted qualname of the enclosing def/class
    hint: str = ""          # finding-specific hint (falls back to CODES)
    suppressed: bool = False

    @property
    def severity(self) -> Severity:
        return CODES[self.code][0]

    @property
    def fix_hint(self) -> str:
        return self.hint or CODES[self.code][2]

    def format(self, fix_hints: bool = False) -> str:
        where = f"{self.path}:{self.line}"
        scope = f" [{self.scope}]" if self.scope else ""
        sup = " (suppressed)" if self.suppressed else ""
        out = f"{where}: {self.code} {self.severity}{sup}: {self.message}{scope}"
        if fix_hints:
            out += f"\n    hint: {self.fix_hint}"
        return out


def fingerprints(findings: list[Finding]) -> dict[str, Finding]:
    """Stable, line-number-free identity per finding.

    ``code:path:scope`` plus an occurrence index for repeats in the same
    scope, so editing unrelated lines never churns the baseline.
    """
    seen: Counter = Counter()
    out: dict[str, Finding] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.code)):
        base = f"{f.code}:{f.path}:{f.scope}"
        idx = seen[base]
        seen[base] += 1
        out[f"{base}#{idx}"] = f
    return out


# ---------------------------------------------------------------- pragmas --

_PRAGMA_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Za-z0-9_,\s]+)")


def scan_pragmas(source: str) -> dict[int, set[str]]:
    """line (1-based) -> set of codes disabled on that line (or ``{"all"}``)."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(text)
        if m:
            out[i] = {c.strip() for c in m.group(1).split(",") if c.strip()}
    return out


def apply_pragmas(findings: list[Finding],
                  pragmas: dict[int, set[str]]) -> list[Finding]:
    """Mark findings suppressed by a pragma on their line or the line above."""
    out = []
    for f in findings:
        codes = pragmas.get(f.line, set()) | pragmas.get(f.line - 1, set())
        if f.code in codes or "all" in codes:
            f = dataclasses.replace(f, suppressed=True)
        out.append(f)
    return out


# --------------------------------------------------------------- baseline --

BASELINE_VERSION = 1


def load_baseline(path: Path) -> dict[str, dict]:
    """fingerprint -> recorded metadata; a missing file is an empty baseline."""
    if not path.exists():
        return {}
    doc = json.loads(path.read_text())
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version in {path}: "
                         f"{doc.get('version')!r}")
    return doc["findings"]


def save_baseline(path: Path, findings: dict[str, Finding]) -> None:
    doc = {
        "version": BASELINE_VERSION,
        "findings": {
            fp: dict(code=f.code, path=f.path, scope=f.scope,
                     message=f.message)
            for fp, f in sorted(findings.items())
        },
    }
    path.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")


@dataclasses.dataclass
class GateResult:
    """Outcome of comparing a scan against the baseline."""
    new: dict[str, Finding]          # active findings not in the baseline
    known: dict[str, Finding]        # active findings covered by it
    stale: dict[str, dict]           # baseline entries that no longer fire

    @property
    def ok(self) -> bool:
        return not self.new


def gate(findings: list[Finding], baseline: dict[str, dict],
         min_severity: Severity = Severity.WARNING) -> GateResult:
    """Split active (unsuppressed, >= min_severity) findings by baseline."""
    active = [f for f in findings
              if not f.suppressed and f.severity >= min_severity]
    fps = fingerprints(active)
    new = {fp: f for fp, f in fps.items() if fp not in baseline}
    known = {fp: f for fp, f in fps.items() if fp in baseline}
    stale = {fp: meta for fp, meta in baseline.items() if fp not in fps}
    return GateResult(new=new, known=known, stale=stale)
