"""Read the JAX package's checkpoints into the port's models.

cellseg_tpu/train/checkpoint.py writes a flax msgpack blob (params, step,
epoch, ...) plus a JSON architecture sidecar. This module reads both
without flax or msgpack: a small msgpack decoder for the subset flax
writes, `convert_params` to carry the weights across, and
`load_model_for_inference` to rebuild the model the sidecar declares.
"""

from __future__ import annotations

import json
import os
import re
import struct

import numpy as np
import torch

from .device import resolve_device, set_f32_precision
from .models import build_model

# flax's msgpack extension types (flax/serialization.py:_MsgpackExtType)
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

# msgpack type bytes: constants, (length format, kind) of sized values,
# and struct formats of fixed-width numbers
_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
          0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
          0xDC: ("H", "array"), 0xDD: ("I", "array"),
          0xDE: ("H", "map"), 0xDF: ("I", "map"),
          0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext")}
_SCALARS = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
            0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}


class _Reader:
    """Decoder for the msgpack subset flax writes: nil, bool, ints,
    floats, str, bin, arrays, maps and ext values."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw: bool = False):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F, raw)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F, raw)
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F, raw)
        if t in _FIXED:
            return _FIXED[t]
        if t in _SIZED:
            fmt, kind = _SIZED[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "ext":
                return self.ext(n)
            return getattr(self, kind)(n, raw)
        if t in _SCALARS:
            return self.unpack(_SCALARS[t])
        if 0xD4 <= t <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (t - 0xD4))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def str(self, n: int, raw: bool):
        b = self.take(n)
        return b if raw else b.decode("utf-8")

    def array(self, n: int, raw: bool):
        return [self.value(raw) for _ in range(n)]

    def map(self, n: int, raw: bool):
        out = {}
        for _ in range(n):
            k = self.value(raw)
            out[k] = self.value(raw)
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = _Reader(payload).value(raw=True)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode()))
            arr = arr.reshape(shape)
            return arr if code == _EXT_NDARRAY else arr[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore without flax: a tree of dicts,
    lists and numpy arrays. Leaves over 1 GiB, which flax stores in
    chunks, and complex numbers are not read."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError("trailing bytes after msgpack value")
    return tree


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# flax scope name -> torch module path, by the scope's parent
_SCOPES = {
    "UNetEncoder": "encoder",
    "UNetDecoder": "decoder",
    "ResidualUnit": "res_units.{i}",
    "ConvNormAct": "subunits.{i}",
    "ConvTranspose": "ups.{i}",
}
_IN_CONV_NORM_ACT = {"Conv": "conv", "GroupNorm": "norm", "Activation": "act"}
_IN_DECODER = {"GroupNorm": "norms.{i}", "Activation": "acts.{i}"}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "alpha": "alpha"}


def _torch_key(path: list[str]) -> str:
    parts, parent = [], None
    for scope in path[:-1]:
        m = re.fullmatch(r"(\w+?)_(\d+)", scope)
        if m is None:
            raise KeyError(f"unexpected flax scope {scope!r} in {path}")
        kind, i = m.group(1), m.group(2)
        if parent == "ConvNormAct" and kind in _IN_CONV_NORM_ACT:
            parts.append(_IN_CONV_NORM_ACT[kind])
        elif parent == "UNetDecoder" and kind in _IN_DECODER:
            parts.append(_IN_DECODER[kind].format(i=i))
        elif parent == "ResidualUnit" and kind == "Conv":
            parts.append("proj")
        elif kind in _SCOPES:
            parts.append(_SCOPES[kind].format(i=i))
        else:
            raise KeyError(f"unexpected flax scope {scope!r} in {path}")
        parent = kind
    parts.append(_LEAVES[path[-1]])
    return ".".join(parts)


def convert_params(params: dict) -> dict[str, torch.Tensor]:
    """flax UNet params (numpy leaves) -> the port's UNet state_dict.

    Conv kernels (kh, kw, in, out) become (out, in, kh, kw); transposed-
    conv kernels are flipped spatially and become (in, out, kh, kw)."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}

    def walk(tree, path):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, path + [name])
                continue
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                if path[-1].startswith("ConvTranspose"):
                    arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
                else:
                    arr = arr.transpose(3, 2, 0, 1)
            # a copy: the arrays read from a checkpoint are read-only views
            state[_torch_key(path + [name])] = torch.from_numpy(
                np.array(arr, order="C"))

    walk(params, [])
    return state


def load_model_for_inference(model_dir: str,
                             checkpoint: str = "best_model.ckpt",
                             device: str | torch.device = "cuda"):
    """Rebuild (model, cfg) from a checkpoint directory with its
    `config.json` sidecar, or from a bare `.ckpt` file whose sidecar is
    the sibling `<stem>.json`. The model is in eval mode on `device`, and
    on a card float32 convolutions run without TF32."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_f32_precision()
    if os.path.isfile(model_dir):
        ckpt_path = model_dir
        json_path = os.path.splitext(model_dir)[0] + ".json"
    else:
        ckpt_path = os.path.join(model_dir, checkpoint)
        json_path = os.path.join(model_dir, "config.json")
    with open(json_path) as f:
        cfg = json.load(f)
    if cfg.get("dtype", "float32") != "float32":
        raise NotImplementedError(
            f"{cfg['dtype']} checkpoints are not ported yet (float32 only)")
    arch = {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg.get("architecture", {}).items()}
    model = build_model(cfg["model_name"], num_class=cfg.get("num_class", 3),
                        in_channels=cfg.get("in_channels", 3), **arch)
    model.load_state_dict(convert_params(load_checkpoint(ckpt_path)["params"]))
    return model.to(dev).eval(), cfg
