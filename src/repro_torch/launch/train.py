"""Training launcher: port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_7b --steps 20 --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch phi4_mini_3p8b --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch deepseek_v2_lite_16b --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch rwkv6_3b --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch zamba2_2p7b --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch whisper_tiny --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch llava_next_34b --reduced

    REPRO_TORCH_MESH_DEVICES=4 PYTHONPATH=src python -m repro_torch.launch.train \
        --device cpu --arch deepseek_7b --reduced --data_parallel 2 --model_parallel 2

Wires an architecture, its data pipeline and the fault-tolerant Trainer
together on ``--device`` (default cuda): every family, the vlm and audio
families through ``FrontendPipeline`` (stubbed patches or frames, as the
reference's launcher draws them).  With ``--data_parallel D`` times
``--model_parallel M`` above 1 it builds a ``(data, model)`` mesh of D x M
devices (``launch.mesh.make_local_mesh``: every card, or one card's or the
CPU's shards repeated under ``REPRO_TORCH_MESH_DEVICES``) and runs the
Trainer under ``use_mesh_rules(mesh, DEFAULT_RULES)``, as the reference's
launcher does.  ``--compress_grads`` is parsed and unused, as there.
"""
from __future__ import annotations

import argparse


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
    from repro_torch.distributed.sharding import DEFAULT_RULES, use_mesh_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig

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
    mesh = None
    if args.data_parallel * args.model_parallel > 1:
        mesh = make_local_mesh(args.data_parallel, args.model_parallel, device=args.device)
    with use_mesh_rules(mesh, DEFAULT_RULES):          # no rules without a mesh
        trainer = Trainer(model, pipe, tcfg)
        trainer.run(callback=lambda s, m: print(f"step {s} loss {m['loss_mean']:.4f}"))
    return trainer.metrics_log


if __name__ == "__main__":
    main()
