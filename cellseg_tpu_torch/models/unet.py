"""Residual U-Net (port of cellseg_tpu/models/unet.py:UNet).

The reference 3-class UNet: channels (16, 32, 64, 128, 256), stride 2 per
level, 2 residual subunits in the encoder and 1 in the decoder. NCHW
inside; `UNet.forward` takes and returns NHWC like the JAX model, so the
two compare like with like.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import Activation, ResidualUnit, SameConvTranspose2d, make_norm


def _strides_for(channels: Sequence[int],
                 strides: Sequence[int] | None) -> tuple[int, ...]:
    """One downsample per encoder level; an explicit strides tuple must
    match the ladder depth."""
    n = len(channels) - 1
    if strides is None:
        return (2,) * n
    if len(strides) != n:
        raise ValueError(f"strides {tuple(strides)} must have {n} entries "
                         f"for channels {tuple(channels)}")
    return tuple(strides)


class UNetEncoder(nn.Module):
    def __init__(self, in_channels: int = 3,
                 channels: Sequence[int] = (16, 32, 64, 128, 256),
                 strides: Sequence[int] | None = None,
                 num_res_units: int = 2, norm: str = "instance",
                 act: str = "prelu"):
        super().__init__()
        strides = _strides_for(channels, strides)
        units, prev = [], in_channels
        for i, feats in enumerate(channels[:-1]):
            units.append(ResidualUnit(prev, feats, strides[i],
                                      num_res_units, norm=norm, act=act))
            prev = feats
        # bottom block, stride 1
        units.append(ResidualUnit(prev, channels[-1], 1, num_res_units,
                                  norm=norm, act=act))
        self.res_units = nn.ModuleList(units)

    def forward(self, x: torch.Tensor):
        skips = []
        for unit in self.res_units[:-1]:
            x = unit(x)
            skips.append(x)
        return self.res_units[-1](x), skips


class UNetDecoder(nn.Module):
    """Each step concatenates the same-resolution skip AFTER the deeper
    block, then a strided transposed conv upsamples. The top step emits
    `out_channels` logits with no norm/activation after the upsample and
    no activation after its residual unit."""

    def __init__(self, channels: Sequence[int] = (16, 32, 64, 128, 256),
                 strides: Sequence[int] | None = None,
                 out_channels: int = 3, num_res_units: int = 1,
                 norm: str = "instance", act: str = "prelu"):
        super().__init__()
        strides = _strides_for(channels, strides)
        n_levels = len(channels) - 1
        ups, norms, acts, res = [], [], [], []
        x_ch = channels[-1]
        for i in reversed(range(n_levels)):
            is_top = i == 0
            out_feats = out_channels if is_top else channels[i - 1]
            ups.append(SameConvTranspose2d(x_ch + channels[i], out_feats, 3,
                                           strides[i]))
            if not is_top:
                norms.append(make_norm(norm)(out_feats))
                acts.append(Activation(act))
            if num_res_units > 0:
                res.append(ResidualUnit(out_feats, out_feats, 1, 1,
                                        norm=norm, act=act,
                                        last_act=not is_top))
            x_ch = out_feats
        self.ups = nn.ModuleList(ups)
        self.norms = nn.ModuleList(norms)
        self.acts = nn.ModuleList(acts)
        self.res_units = nn.ModuleList(res)

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        n_levels = len(self.ups)
        for t in range(n_levels):
            i = n_levels - 1 - t
            x = torch.cat([x, skips[i]], dim=1)
            x = self.ups[t](x)
            if t < len(self.norms):
                x = self.acts[t](self.norms[t](x))
            if len(self.res_units):
                x = self.res_units[t](x)
        return x.float()


class UNet(nn.Module):
    """Residual U-Net with a single head (the reference 3-class baseline).

    forward: (B, H, W, C_in) NHWC -> (B, H, W, out_channels) NHWC float32.
    """

    def __init__(self, out_channels: int = 3, in_channels: int = 3,
                 channels: Sequence[int] = (16, 32, 64, 128, 256),
                 strides: Sequence[int] | None = None,
                 num_res_units: int = 2, norm: str = "instance",
                 act: str = "prelu"):
        super().__init__()
        self.encoder = UNetEncoder(in_channels, channels, strides,
                                   num_res_units, norm, act)
        self.decoder = UNetDecoder(channels, strides, out_channels,
                                   max(1, num_res_units - 1), norm, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).float()
        bottom, skips = self.encoder(x)
        return self.decoder(bottom, skips).permute(0, 2, 3, 1)
