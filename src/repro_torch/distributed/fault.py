"""Fault-tolerance harness: crash/restart drills and straggler semantics:
port of ``repro/distributed/fault.py``.

``run_with_restarts`` executes a Trainer run, catching (injected or real)
failures and restarting from the last checkpoint up to ``max_restarts``
times: the single-process analogue of a cluster supervisor respawning a
failed job.  A deterministic data pipeline (a pure function of the step)
and atomic checkpoints give a bit-exact resumption.  ``HeartbeatMonitor``
is the detection hook a launcher polls to decide eviction.
"""
from __future__ import annotations

import time
from typing import Callable

from repro_torch.train.trainer import SimulatedFailure, Trainer


class HeartbeatMonitor:
    """Step-scoped heartbeats: a launcher evicts ranks whose last beat is
    older than ``timeout_s`` (simulated single-process version)."""

    def __init__(self, n_ranks: int, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self.last_beat = {r: time.monotonic() for r in range(n_ranks)}

    def beat(self, rank: int):
        self.last_beat[rank] = time.monotonic()

    def dead_ranks(self) -> list[int]:
        now = time.monotonic()
        return [r for r, t in self.last_beat.items() if now - t > self.timeout_s]


def run_with_restarts(make_trainer: Callable[[], Trainer], seed: int = 0,
                      max_restarts: int = 3):
    """Run training to completion across simulated failures.

    Each restart constructs a fresh Trainer (a fresh process's analogue)
    that restores from the newest checkpoint.  Returns (params, opt,
    steps, n_failures)."""
    failures = 0
    while True:
        trainer = make_trainer()
        try:
            params, opt_state, steps = trainer.run(seed=seed)
            return params, opt_state, steps, failures
        except SimulatedFailure:
            failures += 1
            if failures > max_restarts:
                raise
            # a real supervisor would also re-provision hardware here
            trainer.tcfg.fail_at_step = None
