"""Conv building blocks (port of cellseg_tpu/models/blocks.py).

Tensors are NCHW inside the port (cuDNN's layout). Convolutions reproduce
flax's padding="SAME": lax splits the padding per axis as (total // 2,
total - total // 2), so a stride-2 3x3 conv pads (0, 1) on an even size
and (1, 1) on an odd one, which torch's symmetric `padding=1` does not.
Normalization runs in float32 with flax's default eps of 1e-6 and flax's
variance formula.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

FLAX_EPS = 1e-6


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of lax "SAME" along one axis."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """nn.Conv2d with flax/lax "SAME" padding for any stride."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = same_pads(x.shape[-2], k, s)
        left, right = same_pads(x.shape[-1], k, s)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return super().forward(x)


class SameConvTranspose2d(nn.Module):
    """flax nn.ConvTranspose(padding="SAME", transpose_kernel=False).

    Equals torch's conv_transpose2d with padding 0 and the spatially
    flipped kernel, cropped to stride * size starting at
    (k - 1) - pad_before, with lax's SAME transpose padding
    (jax.lax._conv_transpose_padding). Weight layout (in, out, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 2):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.weight.shape[-1], self.stride
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
        off = (k - 1) - pad_a
        y = F.conv_transpose2d(x, self.weight, self.bias, stride=s)
        h, w = x.shape[-2] * s, x.shape[-1] * s
        return y[..., off:off + h, off:off + w]


class FlaxGroupNorm(nn.GroupNorm):
    """nn.GroupNorm with flax's statistics: var = max(E[x^2] - E[x]^2, 0)
    in float32, then (x - mean) * (rsqrt(var + eps) * scale) + bias.

    torch's own GroupNorm computes the variance another way, which puts
    the trained 3-class UNet's float32 logits outside a 1e-4 tolerance of
    the JAX model on a 256x256 tile; this formula keeps them inside."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = self.num_groups
        xg = x.float().reshape(n, g, -1)
        mean = xg.mean(-1, keepdim=True)
        var = torch.clamp((xg * xg).mean(-1, keepdim=True) - mean * mean,
                          min=0)
        inv = torch.rsqrt(var + self.eps)
        mul = inv.repeat_interleave(c // g, 1).view(n, c) * self.weight
        y = (xg - mean).view(x.shape) * mul.view(n, c, 1, 1)
        return y + self.bias.view(1, c, 1, 1)


def make_norm(kind: str):
    """Normalization factory: feats -> module (float32 statistics)."""
    if kind.lower() == "instance":
        # one group per channel == instance norm
        return lambda feats: FlaxGroupNorm(feats, feats, eps=FLAX_EPS)
    raise NotImplementedError(
        f"norm kind {kind!r} is not ported yet: the DUNet/FlowNet items of "
        f"ROADMAP queue A (A9, A10) bring the other kinds")


class Activation(nn.Module):
    """PReLU with ONE learned scalar slope `alpha` (flax Activation)."""

    def __init__(self, kind: str = "prelu"):
        super().__init__()
        if kind.lower() != "prelu":
            raise NotImplementedError(
                f"activation {kind!r} is not ported yet: the DUNet/FlowNet "
                f"items of ROADMAP queue A (A9, A10) bring the others")
        self.alpha = nn.Parameter(torch.tensor(0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class ConvNormAct(nn.Module):
    """3x3 conv -> norm -> activation."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 norm: str = "instance", act: str = "prelu",
                 use_act: bool = True):
        super().__init__()
        self.conv = SameConv2d(in_channels, features, 3, stride)
        self.norm = make_norm(norm)(features)
        self.act = Activation(act) if use_act else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class ResidualUnit(nn.Module):
    """N conv-norm-act subunits plus a 1x1 projection shortcut when the
    channel count or the stride changes (MONAI ResidualUnit shape)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 subunits: int = 2, norm: str = "instance",
                 act: str = "prelu", last_act: bool = True):
        super().__init__()
        self.subunits = nn.ModuleList(
            ConvNormAct(in_channels if i == 0 else features, features,
                        stride if i == 0 else 1, norm, act,
                        use_act=(i < subunits - 1) or last_act)
            for i in range(subunits))
        self.proj = None
        if in_channels != features or stride != 1:
            self.proj = SameConv2d(in_channels, features, 1, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for unit in self.subunits:
            y = unit(y)
        residual = x if self.proj is None else self.proj(x)
        return y + residual
