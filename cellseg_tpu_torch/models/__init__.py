"""Model factory of the port (mirrors cellseg_tpu/models/__init__.py)."""

from __future__ import annotations

from typing import Any

from .unet import UNet, UNetDecoder, UNetEncoder

__all__ = ["UNet", "UNetEncoder", "UNetDecoder", "build_model",
           "MODEL_DEFAULTS"]

MODEL_DEFAULTS: dict[str, dict[str, Any]] = {
    "unet": dict(channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2),
                 num_res_units=2),
}

# models of the JAX zoo not ported yet -> the ROADMAP item that ports them
_NOT_PORTED = {
    "dunet": "A9 (distance inference)",
    "flownet": "A10 (flow inference)",
    "unetr": "A11 (transformer models)",
    "swinunetr": "A11 (transformer models)",
}


def build_model(name: str, num_class: int = 3, input_size: int = 256, *,
                in_channels: int = 3, **overrides):
    """Instantiate a model by reference-compatible name.

    The leading parameters are the JAX factory's: input_size is the image
    size of the transformer models (not ported yet, ROADMAP A11); the UNet
    takes any size. A `channels` override without `strides` derives one
    downsample per level, as the JAX factory does."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP item "
            f"{_NOT_PORTED[name]}")
    if name != "unet":
        raise ValueError(f"unknown model name: {name}")
    if "channels" in overrides and "strides" not in overrides:
        overrides["strides"] = (2,) * (len(overrides["channels"]) - 1)
    cfg = {**MODEL_DEFAULTS["unet"], **overrides}
    return UNet(out_channels=num_class, in_channels=in_channels, **cfg)
