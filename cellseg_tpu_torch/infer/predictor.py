"""Whole-image instance prediction on the card (port of
cellseg_tpu/infer/predictor.py).

Per image: pad bottom/right to a shape bucket, then three stages on the
device: percentile normalization with the channel fixup and /max scaling,
the sliding-window forward with softmax (optionally averaged over the 8
dihedral views), and the decode (pad region masked out): the CC decode of
the interior probability, or the boundary watershed of the interior and
boundary probabilities. Only the uint16 label map comes back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..decode.threeclass import (
    decode_boundary_watershed,
    decode_interior_prob,
)
from ..device import resolve_device, set_f32_precision
from ..io.images import to_hwc_raw
from ..ops.cc import check_route
from ..ops.watershed import ROUTES
from ..pipeline.normalize import normalize_image_torch
from .sliding_window import (
    balanced_sw_batch,
    sliding_window_inference,
    tile_origins,
)


def _bucket_up(v: int, bucket: int, roi: int, stride: int) -> int:
    """Padded size for one axis.

    bucket <= 1: pad only to the ROI (exact MONAI clamped tiling).
    Otherwise prefer a stride-uniform size (size = roi mod stride, so the
    parity blend applies) unless it overshoots the plain bucket pad by
    more than 15%."""
    v = max(v, roi)
    if bucket <= 1:
        return v
    p_bucket = int(np.ceil(v / bucket) * bucket)
    p_uniform = roi + int(np.ceil(max(v - roi, 0) / stride) * stride)
    if p_uniform <= p_bucket * 1.15:
        return p_uniform
    return p_bucket


class Predictor:
    """3-class sliding-window instance predictor.

    model: a callable (B, roi, roi, 3) NHWC float32 -> (B, roi, roi,
    num_class) logits, usually the port's UNet; an nn.Module is moved to
    `device` and put in eval mode. Float32 throughout, with TF32 off on
    the card (device.set_f32_precision).

    decode: "cc" (the reference's CC on the interior) or
    "boundary_watershed" (decode/threeclass.py:decode_boundary_watershed).
    ws_route: the boundary watershed's route to its fixed point, "plain"
    (the JAX package's off the TPU, which its tests check) or "stripe"
    (its route on the TPU); ops/watershed.py.
    cc_route: the route of the decode's CC propagation, "global" (default)
    or "stripe" (block-local, csrc/local_cc.cu, on the shapes it admits;
    ops/cc.py); the labels are the same.
    tta: average the softmax over the 8 flip/rot90 views before decoding
    (8 forwards)."""

    def __init__(self, model, roi: int = 256, sw_batch: int | str = "auto",
                 overlap: float = 0.25, num_class: int = 3,
                 mode: str = "constant", bucket: int = 256,
                 normalize: bool = True, decode: str = "cc",
                 tta: bool = False, ws_route: str = "plain",
                 cc_route: str = "global",
                 device: str | torch.device = "cuda"):
        if decode not in ("cc", "boundary_watershed"):
            raise ValueError(f"unknown decode {decode!r}: cc or "
                             f"boundary_watershed")
        if ws_route not in ROUTES:
            raise ValueError(f"unknown watershed route {ws_route!r}: "
                             f"{' or '.join(ROUTES)}")
        check_route(cc_route)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_precision()
        if isinstance(model, torch.nn.Module):
            model = model.to(self.device).eval()
        self.model = model
        self.roi = roi
        self.sw_batch = sw_batch
        self.overlap = overlap
        self.num_class = num_class
        self.mode = mode
        self.bucket = bucket
        self.normalize = normalize
        self.decode = decode
        self.tta = tta
        self.ws_route = ws_route
        self.cc_route = cc_route

    def stage_norm(self, padded: torch.Tensor) -> torch.Tensor:
        """Raw (H, W, C) pixels -> model-ready float32 (H, W, 3) in [0, 1]."""
        if self.normalize:
            norm = normalize_image_torch(padded).to(torch.float32)
        else:
            norm = padded.to(torch.float32)
        # channel fixup on the device: grayscale -> 3-repeat, 2ch -> zero
        # pad (per-channel normalization commutes with both)
        if norm.shape[-1] == 1:
            norm = norm.repeat(1, 1, 3)
        elif norm.shape[-1] == 2:
            norm = torch.cat([norm, torch.zeros_like(norm[..., :1])], -1)
        # reference: test_npy01 = pre_img_data / np.max(pre_img_data)
        return norm / torch.clamp(norm.max(), min=1e-8)

    def _sw_batch(self, ph: int, pw: int) -> int:
        if self.sw_batch != "auto":
            return int(self.sw_batch)
        n_tiles = (len(tile_origins(ph, self.roi, self.overlap))
                   * len(tile_origins(pw, self.roi, self.overlap)))
        return balanced_sw_batch(n_tiles)

    def _probs(self, np01: torch.Tensor) -> torch.Tensor:
        ph, pw = np01.shape[:2]
        logits = sliding_window_inference(
            self.model, np01, roi=self.roi, sw_batch=self._sw_batch(ph, pw),
            overlap=self.overlap, out_channels=self.num_class,
            mode=self.mode)
        return torch.softmax(logits, dim=-1)

    def stage_forward(self, np01: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) -> softmax probability of the interior class (H, W),
        or of the interior and boundary classes (H, W, 2) for the boundary
        watershed."""
        if self.tta:
            # the 8 dihedral views in the JAX package's order, each
            # inverse-mapped; rot90 of a non-square canvas is its own tiling
            acc = None
            for k in range(4):
                for flip in (False, True):
                    xt = torch.rot90(np01, k, dims=(0, 1))
                    if flip:
                        xt = torch.flip(xt, dims=(1,))
                    pt = self._probs(xt)
                    if flip:
                        pt = torch.flip(pt, dims=(1,))
                    pt = torch.rot90(pt, -k, dims=(0, 1))
                    acc = pt if acc is None else acc + pt
            probs = acc / 8.0
        else:
            probs = self._probs(np01)
        if self.decode == "boundary_watershed":
            return probs[..., 1:3]
        return probs[..., 1]

    def stage_decode(self, fwd_out: torch.Tensor, true_h: int,
                     true_w: int) -> torch.Tensor:
        """stage_forward's probabilities -> uint16 labels; the pad is
        background."""
        fwd_out = fwd_out.clone()
        fwd_out[true_h:] = 0.0
        fwd_out[:, true_w:] = 0.0
        if self.decode == "boundary_watershed":
            labels = decode_boundary_watershed(fwd_out[..., 0].contiguous(),
                                               fwd_out[..., 1].contiguous(),
                                               route=self.ws_route,
                                               cc_route=self.cc_route)
        else:
            labels = decode_interior_prob(fwd_out, cc_route=self.cc_route)
        # uint16 halves the transfer to the host; cell counts stay < 65k
        return labels.to(torch.uint16)

    def pad(self, img: np.ndarray):
        """Raw image -> (zero-padded (ph, pw, C) array, h, w), padded
        bottom/right to the shape bucket."""
        img = to_hwc_raw(img)
        h, w, c = img.shape
        stride = max(int(self.roi * (1 - self.overlap)), 1)
        ph = _bucket_up(h, self.bucket, self.roi, stride)
        pw = _bucket_up(w, self.bucket, self.roi, stride)
        padded = np.zeros((ph, pw, c), img.dtype)
        padded[:h, :w] = img
        return padded, h, w

    @torch.inference_mode()
    def predict_device(self, img: np.ndarray):
        """(uint16 labels (ph, pw), stage_forward's probabilities, h, w),
        all on the device."""
        padded, h, w = self.pad(img)
        x = torch.from_numpy(padded).to(self.device)
        probs = self.stage_forward(self.stage_norm(x))
        return self.stage_decode(probs, h, w), probs, h, w

    def predict(self, img: np.ndarray) -> np.ndarray:
        """Raw image (H, W[, C]) or page stack (N, H, W) -> int32 instance
        labels (H, W)."""
        labels, _, h, w = self.predict_device(img)
        return labels.cpu().numpy()[:h, :w].astype(np.int32)

    def predict_many(self, imgs):
        """Generator of label maps, one per image, in order. Same results
        as predict(); images run one after another (the decode's
        convergence checks synchronize with the host)."""
        for img in imgs:
            yield self.predict(img)
