"""PyTorch/CUDA port of cellseg_tpu for one NVIDIA Hopper GPU (sm_90a).

The JAX package `cellseg_tpu` is the reference: every module here is held
against its counterpart by the `tests/test_torch_*.py` files. This package
imports torch, numpy and scipy only (PIL inside the image-file functions).

Entry points take `device=` and default to "cuda"; they raise when no card
is present unless the caller asks for "cpu" (see `device.py`). Each kernel
the TPU package wrote in Pallas is a hand-written CUDA kernel here
(`csrc/`, built by `kernels/build.py`), with a plain PyTorch version beside
it that runs only for CPU tensors.
"""

__version__ = "0.1.0"
