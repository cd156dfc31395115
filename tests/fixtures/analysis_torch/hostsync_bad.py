"""Fixture: violations of each code of the host-sync pass (scanned by
tests, never imported).  Every function named ``hot_*`` is declared on the
hot path by the tests; each flagged line ends in a comment naming its code."""
import random
import time

import numpy as np
import torch


def hot_item(x: torch.Tensor):
    return x.sum().item()                        # RT101: .item()


def hot_casts(x: torch.Tensor, k: int):
    s = torch.sum(x) * k
    n = int(k)                                   # a Python int: no read
    return float(s) + np.asarray(x) + n          # RT101 RT101: float() and np.asarray


def hot_copies(x: torch.Tensor):
    rows = x.cpu().numpy()                       # RT101: one read, not two
    return rows, x.tolist()                      # RT101: .tolist()


def hot_sync(x: torch.Tensor):
    y = x * 2
    torch.cuda.synchronize()                     # RT101: a wait on the step path
    return y


def hot_draws(x: torch.Tensor, gen: torch.Generator):
    noise = torch.randn(x.shape)                 # RT104: no generator=
    seeded = torch.randn(x.shape, generator=gen)
    x.uniform_()                                 # RT104: no generator=
    return noise + seeded * time.time() + random.random()   # RT104 RT104: clock, random


def hot_outer(x: torch.Tensor):
    def inner():
        return bool(x.any())                     # RT101: nested, x from the closure
    return inner()


def build_and_call(y):
    step = torch.compile(lambda z: z + y)        # RT102: a fresh compile per call
    return step(y)


def cold_reads(x: torch.Tensor):
    return x.item(), time.time()                 # not on the hot path: no finding


def unattributed_sync(x):
    torch.cuda.synchronize()                     # RT105: outside a Tracer span
    return x


def spanned_sync(tracer, x):
    with tracer.span("phase"):
        torch.cuda.synchronize()                 # inside a span: no finding
    return x
