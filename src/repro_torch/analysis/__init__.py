"""Static-analysis suite of the port: ``python -m repro_torch.analysis``.

Port of ``repro.analysis``, its passes restated for eager PyTorch and CUDA;
it imports nothing of ``repro`` or ``jax``:

* :mod:`repro_torch.analysis.hostsync`: host reads, global draws and raw
  device syncs on the step path (RT1xx);
* :mod:`repro_torch.analysis.launch_contracts`: the launch geometry of
  every ``kernels.ops.kernel_registry()`` entry at the sizes the config
  permits (KC2xx), from the CUDA wrappers called on meta tensors;
* :mod:`repro_torch.analysis.concurrency`: lock discipline in the
  threaded classes (CC3xx);
* :mod:`repro_torch.analysis.findings`: codes, severities,
  ``# repro-lint: disable=<code>`` pragmas, and the monotone baseline;
* :mod:`repro_torch.analysis.cli`: ``python -m repro_torch.analysis
  [--gate]``, against ``ANALYSIS_BASELINE_TORCH.json``.

Finding codes and workflow are the reference's (docs/ANALYSIS.md).
"""
from repro_torch.analysis.findings import (
    CODES, Finding, Severity, apply_pragmas, fingerprints, gate,
    load_baseline, save_baseline, scan_pragmas,
)

__all__ = [
    "CODES", "Finding", "Severity", "apply_pragmas", "fingerprints",
    "gate", "load_baseline", "save_baseline", "scan_pragmas",
]
