"""Host (numpy/scipy) morphology with skimage-parity semantics.

Copy of cellseg_tpu/ops/host_morphology.py for the port: the golden
references for the device decode and the overlay helpers of the CLI.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi


def _disk(radius: int) -> np.ndarray:
    """skimage.morphology.disk: L2 ball of the given radius."""
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (xx * xx + yy * yy) <= radius * radius


def find_boundaries_inner(label_img: np.ndarray,
                          connectivity: int = 1) -> np.ndarray:
    """skimage find_boundaries(mode='inner'): a foreground pixel whose
    footprint holds another label."""
    label_img = np.asarray(label_img)
    footprint = ndi.generate_binary_structure(label_img.ndim, connectivity)
    dil = ndi.grey_dilation(label_img, footprint=footprint, mode="nearest")
    ero = ndi.grey_erosion(label_img, footprint=footprint, mode="nearest")
    return (dil != ero) & (label_img != 0)


def binary_dilation_disk(mask: np.ndarray, radius: int) -> np.ndarray:
    """Binary dilation with an L2 disk (skimage disk(radius))."""
    return ndi.binary_dilation(mask, structure=_disk(radius))


def remove_small_objects(mask: np.ndarray, min_size: int = 16,
                         connectivity: int = 1) -> np.ndarray:
    """Drop connected components with area strictly below min_size."""
    structure = ndi.generate_binary_structure(2, connectivity)
    labeled, n = ndi.label(mask, structure=structure)
    if n == 0:
        return mask.astype(bool)
    areas = np.bincount(labeled.ravel())
    keep = areas >= min_size
    keep[0] = False
    return keep[labeled]


def remove_small_holes(mask: np.ndarray, area_threshold: int = 64,
                       connectivity: int = 1) -> np.ndarray:
    """Fill background components with area strictly below area_threshold."""
    mask = np.asarray(mask).astype(bool)
    filled = remove_small_objects(~mask, min_size=area_threshold,
                                  connectivity=connectivity)
    return ~filled


def connected_components(mask: np.ndarray,
                         connectivity: int = 2) -> np.ndarray:
    """Label connected components in raster first-encounter order."""
    structure = ndi.generate_binary_structure(2, connectivity)
    labeled, _ = ndi.label(mask, structure=structure)
    return labeled
