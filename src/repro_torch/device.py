"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA request without a card raises.

    There is no silent fall-back to the CPU: a caller who wants the CPU
    (the tests do) passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch path on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev
