"""Training launcher: port of ``repro/launch/train.py`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_7b --steps 20 --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch phi4_mini_3p8b --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch deepseek_v2_lite_16b --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch rwkv6_3b --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch zamba2_2p7b --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch whisper_tiny --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch llava_next_34b --reduced

Wires an architecture, its data pipeline and the fault-tolerant Trainer
together on ``--device`` (default cuda): every family, the vlm and audio
families through ``FrontendPipeline`` (stubbed patches or frames, as the
reference's launcher draws them).  ``--data_parallel`` or
``--model_parallel`` above 1 raises ``NotImplementedError``: the mesh, the
sharding rules and the pipeline come with multi-device training
(ROADMAP.md §1 item 2, slice 2b).
"""
from __future__ import annotations

import argparse

MULTI_DEVICE = ("multi-device training (the mesh, the sharding rules, the GPipe pipeline "
                "and compressed_psum) is not ported yet: ROADMAP.md §1 item 2, slice 2b "
                "(multi-device training)")


def main(argv=None) -> list[dict]:
    """Returns the trainer's metrics log."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek_7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data_parallel", type=int, default=1)
    ap.add_argument("--model_parallel", type=int, default=1)
    ap.add_argument("--ckpt_dir", default="runs/launch_train")
    ap.add_argument("--compress_grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data.pipeline import FrontendPipeline, TokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if args.data_parallel * args.model_parallel > 1:
        raise NotImplementedError(MULTI_DEVICE)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    if cfg.family == "vlm":
        pipe = FrontendPipeline(cfg.vocab_size, args.batch, args.seq, seed=0,
                                frontend_key="patches",
                                frontend_shape=(cfg.vlm.n_patches, cfg.d_model))
    elif cfg.family == "audio":
        pipe = FrontendPipeline(cfg.vocab_size, args.batch, args.seq, seed=0,
                                frontend_key="frames",
                                frontend_shape=(cfg.enc_dec.n_frames, cfg.d_model))
    else:
        pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=0)
    tcfg = TrainerConfig(n_steps=args.steps, ckpt_every=max(args.steps // 2, 5),
                         ckpt_dir=args.ckpt_dir, log_every=5)
    trainer = Trainer(model, pipe, tcfg)
    trainer.run(callback=lambda s, m: print(f"step {s} loss {m['loss_mean']:.4f}"))
    return trainer.metrics_log


if __name__ == "__main__":
    main()
