"""Device resolution for the port's entry points.

Counterpart of cellseg_tpu/ops/pallas/gate.py, without its kill-switch:
a CUDA tensor always goes through the hand-written kernel (or the call
raises), and a CPU tensor always goes through the plain PyTorch version.
Which one runs is decided by where the data lives, never by an option.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device for `device`; raises if it names CUDA and no card
    is present. There is no silent CPU fallback: pass "cpu" to ask for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def set_f32_precision() -> None:
    """Full float32 convolutions and matmuls on the card.

    cuDNN runs float32 convolutions in TF32 by default (about three
    decimal digits); the predictor's f32 path is held to the JAX forward
    within 1e-4 on the CPU and 1e-3 on the card, so TF32 is switched off
    for both cuDNN and cuBLAS."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
