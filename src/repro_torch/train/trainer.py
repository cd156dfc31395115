"""Training loop with checkpoint/restart fault tolerance: port of
``repro/train/trainer.py``.

* deterministic resume: restore (params, opt) from the newest checkpoint
  and continue from that step; the data pipeline replays by step id, so a
  restarted run is bit-exact with an uninterrupted one;
* asynchronous checkpoints every ``ckpt_every`` steps and at the end;
* optional simulated failure injection (``fail_at_step``) for drills;
* a metrics log (a list, plus an optional callback), read on the host only
  at ``log_every`` steps.

The reference jits the step with its buffers donated; the port's step
updates the parameters and the optimizer state in place, which is its
donation (``donate`` is kept for the signature).

Built under active mesh rules (``distributed.sharding.use_mesh_rules``
with a ``launch.mesh.DeviceMesh``, as ``launch.train`` builds it), the
trainer runs the sharded step (``train.step``) on that mesh.  Its state is
then the parameters and optimizer state of data shard 0, whole on the
mesh's first device: a checkpoint saves those full leaves (the
reference's gathers its sharded leaves), and a restore hands them back
to the step, which copies them to every other card of the data axis; a
resume is bit for bit on the mesh as on one device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.distributed.sharding import active_rules
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import make_opt_init, make_train_step, opt_config_for


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""


@dataclasses.dataclass
class TrainerConfig:
    n_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "runs/ckpt"
    ckpt_keep: int = 3
    log_every: int = 10
    fail_at_step: int | None = None


class Trainer:
    def __init__(self, model, pipeline, tcfg: TrainerConfig,
                 opt_cfg: AdamWConfig | None = None,
                 donate: bool = True):
        self.model = model
        self.pipeline = pipeline
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or opt_config_for(model.cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        rules = active_rules()
        self.mesh = rules.mesh if rules is not None and hasattr(rules.mesh, "group") else None
        self.train_step = make_train_step(model, self.opt_cfg, mesh=self.mesh)
        self.opt_init = make_opt_init(model, self.opt_cfg)
        self.metrics_log: list[dict] = []

    def init_state(self, seed: int = 0):
        """(params, opt_state, 0): parameters drawn from a generator on the
        model's device seeded with ``seed``."""
        params = self.model.init(torch.Generator(self.model.device).manual_seed(seed))
        opt_state = self.opt_init(params)
        return params, opt_state, 0

    def restore_or_init(self, seed: int = 0):
        params, opt_state, start = self.init_state(seed)
        latest = self.ckpt.latest_step()
        if latest is not None:
            (params, opt_state), step = self.ckpt.restore((params, opt_state))
            start = step
        return params, opt_state, start

    def run(self, seed: int = 0, callback: Callable[[int, dict], None] | None = None):
        params, opt_state, start = self.restore_or_init(seed)
        t0 = time.perf_counter()
        step = start
        for step in range(start, self.tcfg.n_steps):
            if self.tcfg.fail_at_step is not None and step == self.tcfg.fail_at_step:
                self.ckpt.wait()
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = self.pipeline.batch(step)
            params, opt_state, metrics = self.train_step(params, opt_state, batch)
            if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == self.tcfg.n_steps:
                self.ckpt.save(step + 1, (params, opt_state))
            if (step + 1) % self.tcfg.log_every == 0 or step + 1 == self.tcfg.n_steps:
                m = {k: float(v) for k, v in metrics.items()
                     if not isinstance(v, torch.Tensor) or v.numel() == 1}
                m["step"] = step + 1
                m["wall_s"] = time.perf_counter() - t0
                self.metrics_log.append(m)
                if callback:
                    callback(step + 1, m)
        self.ckpt.wait()
        return params, opt_state, step + 1
