"""Train a ~100M-parameter dense LM with the full substrate (AdamW,
asynchronous checkpoints, the deterministic pipeline, restart-safe): port
of ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 --d_model 768
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 20 --d_model 256

The defaults give a ~100M-parameter model (12L x 768d, 32k vocab), in
float32, on ``--device`` (default cuda).  A rerun with the same
``--ckpt_dir`` resumes from its newest checkpoint.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import ArchConfig, param_count
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> list[dict]:
    """Returns the trainer's metrics log."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d_model", type=int, default=768)
    ap.add_argument("--n_layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt_dir", default="runs/train_lm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = lm100m_config(args.d_model, args.n_layers, args.vocab)
    total, _ = param_count(cfg)
    print(f"model: {total/1e6:.1f}M params")

    model = build_model(cfg, device=args.device)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=0)
    trainer = Trainer(
        model, pipe,
        TrainerConfig(n_steps=args.steps, ckpt_every=max(args.steps // 4, 10),
                      ckpt_dir=args.ckpt_dir, log_every=10),
        AdamWConfig(learning_rate=args.lr, warmup_steps=min(100, args.steps // 3)),
    )
    trainer.run(callback=lambda s, m: print(
        f"step {s:5d}  loss {m['loss_mean']:.4f}  gnorm {m['grad_norm']:.2f}  "
        f"{m['wall_s']:.1f}s"))
    return trainer.metrics_log


def lm100m_config(d_model: int = 768, n_layers: int = 12, vocab: int = 32768) -> ArchConfig:
    """The example's model: ``d_model / 64`` heads of 64 over
    ``d_model / 128`` KV heads, d_ff ``4 * d_model``, float32 compute."""
    return ArchConfig(
        name="lm100m", family="dense", n_layers=n_layers,
        d_model=d_model, n_heads=d_model // 64,
        n_kv_heads=max(1, d_model // 128), d_ff=4 * d_model,
        vocab_size=vocab, head_dim=64, compute_dtype="float32",
    )


if __name__ == "__main__":
    main()
