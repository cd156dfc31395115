"""Training of the port (port of ``repro/train``): AdamW, the train step,
the restart-safe trainer, checkpoints and the MoE router-bias update."""
