"""Image file IO of the port."""

from .images import (
    imread,
    imwrite,
    imwrite_instance_tiff,
    list_images,
    to_hwc3,
    to_hwc_raw,
)

__all__ = ["imread", "imwrite", "imwrite_instance_tiff", "list_images",
           "to_hwc3", "to_hwc_raw"]
