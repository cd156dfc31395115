"""Batched serving engine with continuous batching: port of
``repro/serve/engine.py``.

A fixed pool of batch slots steps through ``decode_step`` together; slots
whose sequence finished (EOS or max tokens) are refilled from the request
queue between steps — the standard continuous-batching loop (vLLM-style).
A refilled slot is prefilled by decode: its prompt goes in one token a
tick from position 0.  Its row (dim 1) of every cache leaf is zeroed first:
a KV cache's old rows would stay hidden by the mask anyway, but a recurrent
state (the ssm and hybrid families) would carry the previous request over.
The reference's engine resets only the position and the token, so it
serves such a slot wrong tokens (ROADMAP.md §3); for a request that starts
in a fresh slot the two engines give the same tokens.

    model = build_model(get_config("deepseek_7b"))        # on cuda
    engine = ServeEngine(model, batch_slots=8, max_seq=512)
    engine.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=64))
    done = engine.run(model.init(torch.Generator("cuda").manual_seed(0)))

Each tick uploads the slots' tokens and positions and reads the greedy
argmax back (one host sync a tick, as the reference's).  ``greedy`` and
``seed`` are stored and unused, as in the reference: decoding is greedy.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """``metrics`` (default: a private registry on ``self.metrics``)
    records the same telemetry shape as the embedding service:
    ``serve.queue_depth`` / ``serve.slot_occupancy`` gauges per tick,
    ``serve.ticks`` / ``serve.completed`` / ``serve.tokens`` counters, and
    a ``serve.request_tokens`` histogram at retirement — one dashboard
    vocabulary across both continuous-batching loops."""

    def __init__(self, model, batch_slots: int = 4, max_seq: int = 128,
                 eos_id: int | None = None, greedy: bool = True, seed: int = 0,
                 params: Any | None = None,
                 metrics: obs.MetricsRegistry | None = None):
        self.metrics = metrics if metrics is not None else obs.MetricsRegistry()
        self.model = model
        self.model_params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.greedy = greedy
        self.seed = seed
        # `queue` / `completed` may be touched from outside the engine
        # thread (submit while run() drains) — guarded by `_lock`.  Slot
        # state (`active`, `pos`, `next_token`, `cache`) is engine-owned.
        self._lock = threading.Lock()
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, np.int32)
        self.next_token = np.zeros(batch_slots, np.int32)
        self.cache = model.init_cache(batch_slots, max_seq)
        self._step = model.decode_step
        self.completed: list[Request] = []

    def submit(self, req: Request):
        with self._lock:
            self.queue.append(req)

    def _refill(self):
        for s in range(self.slots):
            if self.active[s] is None:
                with self._lock:
                    if not self.queue:
                        break
                    req = self.queue.popleft()
                self.active[s] = req
                # a fresh slot: no state of the request that left it
                for leaf in tree_leaves(self.cache):
                    if isinstance(leaf, torch.Tensor):
                        leaf[:, s].zero_()
                # prefill-by-decode: feed prompt tokens one at a time into
                # this slot's cache rows (keeps a single step function)
                self.pos[s] = 0
                self.next_token[s] = req.prompt[0]
                req._prompt_cursor = 1  # type: ignore[attr-defined]

    def step(self):
        """One engine tick: decode_step over all slots, then bookkeeping."""
        if self.model_params is None:
            raise RuntimeError(
                "no model params — pass params= to ServeEngine(...) or call "
                "run(params) instead of stepping directly"
            )
        self._refill()
        occupancy = sum(a is not None for a in self.active)
        with self._lock:
            depth = len(self.queue)
        self.metrics.gauge("serve.queue_depth").set(depth)
        self.metrics.gauge("serve.slot_occupancy").set(occupancy)
        if occupancy == 0:
            return False
        self.metrics.counter("serve.ticks").inc()
        logits, self.cache = self._step(self.model_params, self.cache,
                                        self.next_token, self.pos)
        # repro-lint: disable=RT101 -- greedy decode: the host appends each slot's token and picks the next
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[s] += 1
            cur = getattr(req, "_prompt_cursor", len(req.prompt))
            if cur < len(req.prompt):                 # still consuming prompt
                self.next_token[s] = req.prompt[cur]
                req._prompt_cursor = cur + 1          # type: ignore[attr-defined]
                continue
            token = int(nxt[s])
            req.generated.append(token)
            self.next_token[s] = token
            self.metrics.counter("serve.tokens").inc()
            if (self.eos_id is not None and token == self.eos_id) or \
               len(req.generated) >= req.max_new_tokens or \
               self.pos[s] >= self.max_seq - 1:
                req.done = True
                with self._lock:
                    self.completed.append(req)
                self.active[s] = None
                self.metrics.counter("serve.completed").inc()
                self.metrics.histogram("serve.request_tokens").observe(
                    len(req.generated))
        return True

    def run(self, params: Any | None = None, max_ticks: int = 10_000):
        if params is not None:
            self.model_params = params
        ticks = 0
        while ticks < max_ticks:
            with self._lock:
                pending = bool(self.queue)
            if not pending and all(a is None for a in self.active):
                break
            self.step()
            ticks += 1
        with self._lock:
            return list(self.completed)

    def stats(self) -> dict:
        """Telemetry snapshot (counters, gauge high-water marks, token
        histogram summary) for the life of the engine."""
        return self.metrics.snapshot()
