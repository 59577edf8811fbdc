"""Host-side image IO for TIFF/PNG/BMP microscopy files.

Copy of cellseg_tpu/io/images.py for the port. PIL is imported only
inside the functions that read or write files.
"""

from __future__ import annotations

import os

import numpy as np

IMAGE_EXTENSIONS = (".tif", ".tiff", ".png", ".bmp", ".jpg", ".jpeg")


def imread(path: str) -> np.ndarray:
    """Read an image preserving dtype and (for color) RGB channel order;
    a multipage TIFF comes back as an (N, H, W) page stack."""
    from PIL import Image

    # gigapixel whole-slide images trip PIL's decompression-bomb guard
    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path) as im:
        frames = getattr(im, "n_frames", 1)
        if frames > 1:
            pages = []
            for i in range(frames):
                im.seek(i)
                pages.append(np.asarray(im))
            return np.stack(pages, axis=0)
        return np.asarray(im)


def _pages_to_channels(img: np.ndarray) -> np.ndarray:
    """Move a leading page axis of an (N, H, W) stack to the channel slot;
    ambiguous near-cubic layouts raise."""
    n, h, w = img.shape
    if n <= 16 or 4 * n <= min(h, w):
        return np.moveaxis(img, 0, -1)
    if 4 * w <= min(n, h):
        return img
    raise ValueError(
        f"ambiguous 3D image layout {img.shape}: trailing axis is too large "
        "to be channels and the leading axis is too large to be pages; "
        "pass an explicit (H, W, C) array instead"
    )


def to_hwc_raw(img: np.ndarray) -> np.ndarray:
    """(H, W, C) with C in {1, 2, 3}, without the 3-channel expansion
    (the predictor expands channels on the device)."""
    img = np.asarray(img)
    if img.ndim == 2:
        return img[..., None]
    if img.ndim != 3:
        raise ValueError(f"unsupported image rank {img.ndim}: {img.shape}")
    if img.shape[-1] > 4:
        img = _pages_to_channels(img)
    return img[..., :3]


def to_hwc3(img: np.ndarray) -> np.ndarray:
    """Any supported raw layout -> (H, W, 3): grayscale repeats, two
    channels get a zero third, more than three are truncated."""
    img = to_hwc_raw(img)
    c = img.shape[-1]
    if c == 1:
        return np.repeat(img, 3, axis=-1)
    if c == 2:
        return np.concatenate([img, np.zeros_like(img[..., :1])], axis=-1)
    return img


def _to_pil(arr: np.ndarray):
    """A PIL image from an array, keeping integer dtypes PIL can store."""
    from PIL import Image

    if arr.ndim == 2 and arr.dtype in (np.int64, np.uint64, np.uint32):
        arr = arr.astype(np.int32)  # PIL has no 64-bit or uint32 mode
    return Image.fromarray(arr)


def imwrite(path: str, arr: np.ndarray, compress: bool = True) -> None:
    """Write a 2-D or (H, W, C) image; TIFFs get zlib (deflate)
    compression by default."""
    arr = np.asarray(arr)
    ext = os.path.splitext(path)[1].lower()
    kw = ({"compression": "tiff_deflate"}
          if ext in (".tif", ".tiff") and compress else {})
    _to_pil(arr).save(path, **kw)


def imwrite_instance_tiff(path: str, labels: np.ndarray) -> None:
    """Write an instance-label map as a zlib-compressed TIFF, in uint16
    when the labels fit (the `{stem}_label.tiff` submission format)."""
    labels = np.asarray(labels)
    mx = int(labels.max()) if labels.size else 0
    labels = labels.astype(np.uint16 if mx < 2**16 else np.int32)
    imwrite(path, labels, compress=True)


def list_images(directory: str) -> list[str]:
    """Sorted image file names in a directory."""
    return sorted(f for f in os.listdir(directory)
                  if f.lower().endswith(IMAGE_EXTENSIONS))
