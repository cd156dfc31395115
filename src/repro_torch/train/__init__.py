"""Training-loop support of the port: checkpoints (``train/checkpoint.py``)."""
