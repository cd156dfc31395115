"""GPipe-style pipeline parallelism over a "pipe" mesh axis: port of
``repro/distributed/pipeline.py``.

The stage function is replicated code; stage s's weights (entry s of the
leading stage axis) live on the pipe axis's device s.  Microbatches stream
through the stages: the schedule is ``n_micro + n_stages - 1`` ticks, in
each of which every stage with a microbatch runs it and the activations
are copied from stage s to stage s + 1 (``ppermute``), so the bubble
fraction is ``(S - 1) / (M + S - 1)`` (:func:`pipeline_bubble`).  As in
the reference, this is a building block for very deep stacks that the
trainer does not call; it is held to the sequential apply.  Unlike the
reference's scan, a stage with no microbatch at a tick skips the tick
rather than computing one that is masked.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.collectives import ppermute
from repro_torch.tree import tree_map


def pipeline_bubble(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipelined(stage_fn: Callable, mesh, *, axis: str = "pipe", n_micro: int):
    """Wrap ``stage_fn(stage_params, x) -> x`` into a pipelined apply.

    Returns ``apply(stacked_params, batch)``: ``stacked_params`` is a tree
    of tensors with a leading ``[n_stages, ...]`` axis and ``batch`` is
    ``[n_micro * micro_b, ...]``; the result is the last stage's outputs
    in microbatch order, ``[n_micro * micro_b, ...]`` on ``batch``'s
    device.  ``mesh`` is a ``launch.mesh.DeviceMesh`` with the axis (the
    pipe axis's devices at the other axes' 0)."""
    group = mesh.group(axis)
    n_stages = group.size

    def apply(stacked_params, batch: torch.Tensor) -> torch.Tensor:
        stage_params = [tree_map(lambda p, s=s: p[s].to(dev, non_blocking=True), stacked_params)
                        for s, dev in enumerate(group.devices)]
        micro = batch.reshape(n_micro, -1, *batch.shape[1:])
        fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]
        buf: list[torch.Tensor | None] = [None] * n_stages
        outs: list[torch.Tensor | None] = [None] * n_micro
        for t in range(n_micro + n_stages - 1):
            ys: list[torch.Tensor | None] = [None] * n_stages
            for s in range(n_stages):
                mid = t - s                      # stage s works on microbatch t - s
                if 0 <= mid < n_micro:
                    x_in = micro[mid].to(group.devices[0], non_blocking=True) if s == 0 \
                        else buf[s]
                    ys[s] = stage_fn(stage_params[s], x_in)
            if 0 <= t - (n_stages - 1) < n_micro:
                outs[t - (n_stages - 1)] = ys[-1]
            buf = ppermute(group, ys, fwd_perm)
        return torch.cat([o.to(batch.device, non_blocking=True) for o in outs])

    return apply
