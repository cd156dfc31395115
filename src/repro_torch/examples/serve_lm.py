"""Serve a model with the continuous-batching engine: port of
``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch deepseek_7b --requests 8
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu --arch deepseek_v2_lite_16b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu --arch rwkv6_3b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu --arch zamba2_2p7b

Reduced configs, as the reference's; on ``--device`` (default cuda).  The
text families serve (dense, MoE, ssm and hybrid); the audio and vlm archs
exit, as the reference's example does (``repro_torch.launch.serve`` serves
them token-only).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="deepseek_7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max_new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("text archs only in this example")
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))
    eng = ServeEngine(model, batch_slots=args.slots, max_seq=128)
    for r in range(args.requests):
        eng.submit(Request(rid=r, prompt=[(r * 7 + i) % cfg.vocab_size for i in range(1, 6)],
                           max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    done = eng.run(params)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in done)
    print(f"{len(done)} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s, {args.slots} slots)")
    for r in done[:4]:
        print(f"  req {r.rid}: {r.generated}")
    return done


if __name__ == "__main__":
    main()
