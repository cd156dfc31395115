"""Frozen measurement helpers of the benchmark.

Copied from ``chip_smoke.py`` (``cuda_ms``, ``bound``, the ``PEAK_*``
data-sheet constants, the profiler's kernel-event reader) so that a later
change to the program or to its smoke script cannot move the yardstick;
plus the import check, the process age and the trace reduction
(device busy time as the union of device intervals, idle gaps labelled
by the host call running in them).
"""
from __future__ import annotations

import os
import subprocess
import time
from dataclasses import dataclass, field

import numpy as np

# H100 SXM data-sheet peaks (dense), valid at the full 700 W power limit:
# fp32 outside the tensor cores, TF32 and bf16 on the tensor cores, HBM3,
# and the special-function units (16 results a clock on each of 132 SMs at
# 1.98 GHz).
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_SFU_OPS = 132 * 16 * 1.98e9

# top-level module names that may never be loaded by a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list[str]:
    """The forbidden top-level names among module names ``names``.

    The top-level name is the part before the first dot, compared whole:
    ``repro_torch.api`` is ``repro_torch`` and passes, ``repro.core`` is
    ``repro`` and fails."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN_MODULES))


def process_age_s() -> float:
    """Seconds since this process was started (the kernel's start time,
    10 ms resolution)."""
    with open("/proc/self/stat") as f:
        stat = f.read()
    start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def power_limit() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reads them
    (written beside every number kept), or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "unknown"


def cuda_ms(fn, reps: int = 5, inner: int = 3) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS,
          sfu: float = 0.0) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the largest of flops at ``peak``, sfu
    special-function results at the SFU rate, and nbytes at the HBM rate."""
    t_ops = max(flops / peak, sfu / PEAK_SFU_OPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# Trace reduction
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """What one profiled stretch of the run left behind.

    ``device``: (name, start_ns, end_ns) of every operation that ran on the
    card (kernels, copies, sets); ``host``: the same for the host calls
    recorded; ``window_s``: host-clock length of the stretch, the card
    synchronised at both ends."""
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window_s: float = 0.0

    def kernel_seconds(self, part: str) -> list[float]:
        """Durations (s) of the device operations whose name holds ``part``."""
        return [(e - s) * 1e-9 for n, s, e in self.device if part in n]

    def busy_intervals(self) -> np.ndarray:
        """The union of the device intervals, as sorted [m, 2] ns."""
        if not self.device:
            return np.zeros((0, 2), np.int64)
        iv = np.array([(s, e) for _, s, e in self.device], np.int64)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        ends = np.maximum.accumulate(iv[:, 1])
        new = np.ones(len(iv), bool)
        new[1:] = iv[1:, 0] > ends[:-1]
        starts = iv[new, 0]
        last = np.flatnonzero(new)
        stops = ends[np.r_[last[1:] - 1, len(iv) - 1]]
        return np.stack([starts, stops], axis=1)

    def busy_s(self) -> float:
        u = self.busy_intervals()
        return float((u[:, 1] - u[:, 0]).sum()) * 1e-9

    def device_ops(self, top: int = 10) -> list:
        by: dict[str, float] = {}
        for n, s, e in self.device:
            by[n[:96]] = by.get(n[:96], 0.0) + (e - s) * 1e-9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The idle time between device operations, summed by what the host
        was doing in the middle of each gap: the host call last started
        there if it was still running, else "after" that call (the host
        was in Python between calls)."""
        u = self.busy_intervals()
        if len(u) < 2:
            return []
        mid = (u[:-1, 1] + u[1:, 0]) // 2
        length = (u[1:, 0] - u[:-1, 1]) * 1e-9
        by: dict[str, float] = {}
        if self.host:
            host = sorted(self.host, key=lambda h: h[1])
            starts = np.array([h[1] for h in host], np.int64)
            ends = np.array([h[2] for h in host], np.int64)
            last = np.searchsorted(starts, mid, side="right") - 1
            for i, m, g in zip(last, mid, length):
                if i < 0:
                    label = "before the first host call"
                else:
                    label = host[i][0] if ends[i] >= m else "after " + host[i][0]
                by[label[:96]] = by.get(label[:96], 0.0) + float(g)
        else:
            by["no host call recorded"] = float(length.sum())
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def profiled(fn, device) -> tuple[object, Trace]:
    """Run ``fn()`` under ``torch.profiler``, the card synchronised before
    and after; returns (fn's result, Trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    # on the card, its activity alone: the host calls it records are the
    # CUDA runtime's (launches, copies, syncs); recording every host op
    # would slow the host-paced stretches it measures
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    trace = Trace(window_s=window)
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            trace.device.append((e.name(), start, start + dur))
        elif dur > 0:
            trace.host.append((e.name(), start, start + dur))
    return out, trace
