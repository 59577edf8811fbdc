"""Port parity: the fused neighbour-min sweeps (B3) against the JAX package.

The Pallas fused_sweeps has no interpret mode; it is defined as k calls
of ops/cc.py:_sweep_min, which is what the port's sweeps are held to here
(plain version on the CPU, bit for bit). The CUDA kernel is held against
the plain version on the card (marker `cuda`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402  (conftest pins JAX to the CPU)

from cellseg_tpu.ops import cc as jcc
from cellseg_tpu_torch.ops import cc as tcc
from cellseg_tpu_torch.ops.kernels import sweeps

torch.set_num_threads(1)
INF = 2**31 - 1


def _case(h, w, density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((h, w)) < density
    vals = rng.integers(0, h * w, (h, w)).astype(np.int32)
    return np.where(mask, vals, INF).astype(np.int32), mask


def _jax_sweeps(lab, mask, k, connectivity):
    lab_j, mask_j = jnp.asarray(lab), jnp.asarray(mask)
    for _ in range(k):
        lab_j = jcc._sweep_min(lab_j, mask_j, connectivity)
    return np.asarray(lab_j)


@pytest.fixture
def cuda_device():
    """The card, for kernel tests; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("h,w", [(64, 128), (37, 53)])
@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("density", [0.3, 0.8])
def test_fused_sweeps_match_k_sweep_min(h, w, connectivity, k, density):
    lab, mask = _case(h, w, density, seed=h * k + connectivity)
    want = _jax_sweeps(lab, mask, k, connectivity)
    got = sweeps.fused_sweeps(torch.from_numpy(lab), torch.from_numpy(mask),
                              k=k, connectivity=connectivity)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("connectivity", [1, 2])
def test_sweep_min_matches_jax_with_labels_off_mask(connectivity):
    """_sweep_min reads unmasked neighbours too (INF padding only at the
    image edge), so labels off the mask must flow in exactly as in JAX."""
    rng = np.random.default_rng(connectivity)
    lab = rng.integers(0, 500, (24, 31)).astype(np.int32)
    mask = rng.random((24, 31)) < 0.5
    want = _jax_sweeps(lab, mask, 1, connectivity)
    got = tcc._sweep_min(torch.from_numpy(lab), torch.from_numpy(mask),
                         connectivity)
    np.testing.assert_array_equal(got.numpy(), want)


def test_more_than_one_launch_worth_of_sweeps():
    """k above one launch's budget composes: 20 sweeps == 16 then 4."""
    lab, mask = _case(40, 40, 0.7, seed=3)
    lab_t, mask_t = torch.from_numpy(lab), torch.from_numpy(mask)
    got = sweeps.fused_sweeps(lab_t, mask_t, k=20, connectivity=2)
    want = _jax_sweeps(lab, mask, 20, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [{"k": 0}, {"connectivity": 3}])
def test_fused_sweeps_rejects_bad_arguments(kw):
    lab = torch.zeros((8, 8), dtype=torch.int32)
    mask = torch.ones((8, 8), dtype=torch.bool)
    with pytest.raises(ValueError):
        sweeps.fused_sweeps(lab, mask, **kw)


@pytest.mark.cuda
def test_fused_sweeps_kernel_matches_plain_on_card(cuda_device):
    for h, w in [(2176, 2176), (1000, 1537), (4096, 200), (3, 5),
                 (1, 1), (2, 20011), (20011, 3)]:
        for density in (0.1, 0.5, 0.9):
            lab, mask = _case(h, w, density, seed=h + w)
            lab_d = torch.from_numpy(lab).to(cuda_device)
            mask_d = torch.from_numpy(mask).to(cuda_device)
            for connectivity in (1, 2):
                for k in (1, 16, 20):
                    got = sweeps.fused_sweeps(lab_d, mask_d, k, connectivity)
                    want = sweeps.fused_sweeps_plain(lab_d, mask_d, k,
                                                     connectivity)
                    assert torch.equal(got, want), (h, w, density, k)
