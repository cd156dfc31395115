"""Device resolution shared by every entry point of the port, and the
forced mesh size."""
from __future__ import annotations

import os

import torch

# The port's counterpart of XLA_FLAGS=--xla_force_host_platform_device_count=S:
# when set to S, a mesh sees S devices, the visible ones repeated in turn
# (read by :func:`mesh_devices` at each call, never at import).
MESH_DEVICES_ENV = "REPRO_TORCH_MESH_DEVICES"


def resolve_device(device: str | torch.device | None = None, *,
                   abstract: bool = False) -> torch.device:
    """``None`` means ``cuda``.  A CUDA request without a card raises.

    There is no silent fall-back to the CPU: a caller who wants the CPU
    (the tests do) passes ``device="cpu"``.  ``abstract=True`` also admits
    ``"meta"``, the abstract path of ``build_model`` (tensors with shapes
    and dtypes and no storage, which the dry-run counts); every other
    caller refuses it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch path on the CPU"
            )
    elif dev.type != "cpu" and not (abstract and dev.type == "meta"):
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev


def forced_mesh_size() -> int | None:
    """S from ``REPRO_TORCH_MESH_DEVICES``, or None when it is unset or empty."""
    raw = os.environ.get(MESH_DEVICES_ENV, "").strip()
    if not raw:
        return None
    s = int(raw)
    if s < 1:
        raise ValueError(f"{MESH_DEVICES_ENV} must be >= 1, got {raw!r}")
    return s


def mesh_devices(device: str | torch.device) -> tuple[torch.device, ...]:
    """The devices a mesh for data on ``device`` may use: every card for a
    CUDA device, the one CPU for the CPU.  With ``REPRO_TORCH_MESH_DEVICES=S``
    set, S of them, the visible ones repeated in turn: ``(cuda:0,) * S`` on
    one card, ``(cpu,) * S`` on the CPU, as forced host devices give S to
    the reference."""
    device = torch.device(device)
    if device.type == "cuda":
        visible = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        visible = (torch.device("cpu"),)
    s = forced_mesh_size()
    if s is None or not visible:
        return visible
    return tuple(visible[i % len(visible)] for i in range(s))
