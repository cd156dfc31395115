"""Serving launcher: port of ``repro/launch/serve.py`` (reduced configs).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_7b --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch deepseek_7b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch deepseek_v2_lite_16b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch rwkv6_3b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch zamba2_2p7b

Runs on cuda unless ``--device cpu`` is given.  Every family serves; the
audio and vlm families token-only, as the reference's launcher serves
them (a ``Request`` carries no frames or patches: whisper's decoder
attends to a zero cross cache).
"""
from __future__ import annotations

import argparse


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek_7b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max_new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_reduced_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))
    eng = ServeEngine(model, batch_slots=args.slots, max_seq=96)
    for r in range(args.requests):
        eng.submit(Request(rid=r, prompt=[1 + r, 2, 3], max_new_tokens=args.max_new))
    done = eng.run(params)
    print(f"served {len(done)} requests "
          f"({sum(len(r.generated) for r in done)} tokens)")
    return done


if __name__ == "__main__":
    main()
