"""Port parity: the segmented min-scans (B1, B2) against the JAX package.

The port's row/column scans, plain and region mode, on the CPU (their
plain PyTorch version) against the Pallas kernels in interpret mode and
against the XLA scans of ops/cc.py, bit for bit. The CUDA kernel itself
is held against the plain version on the card (marker `cuda`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402  (conftest pins JAX to the CPU)

from cellseg_tpu.ops import cc as jcc
from cellseg_tpu.ops.pallas.scans import (
    col_segmented_min_scan as jax_col_scan,
    row_segmented_min_scan as jax_row_scan,
)
from cellseg_tpu_torch.ops import cc as tcc
from cellseg_tpu_torch.ops.kernels import scans

torch.set_num_threads(1)
INF = 2**31 - 1


def _case(h, w, density, seed, masked=True):
    """lab: random labels (INF off the mask when `masked`), mask: bool."""
    rng = np.random.default_rng(seed)
    mask = rng.random((h, w)) < density
    vals = rng.integers(0, h * w, (h, w)).astype(np.int32)
    lab = np.where(mask, vals, INF).astype(np.int32) if masked else vals
    return lab, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def cuda_device():
    """The card, for kernel tests; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("h,w", [(64, 128), (40, 384)])
@pytest.mark.parametrize("density", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("region", [False, True])
def test_row_scan_matches_pallas(h, w, density, region):
    lab, mask = _case(h, w, density, seed=h + int(density * 10),
                      masked=not region)
    want = np.asarray(jax_row_scan(jnp.asarray(lab),
                                   jnp.asarray(mask.astype(np.int32)),
                                   interpret=True, region=region))
    got = scans.row_segmented_min_scan(_t(lab), _t(mask), region=region)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w", [(64, 128), (96, 256)])
@pytest.mark.parametrize("density", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("region", [False, True])
def test_col_scan_matches_pallas(h, w, density, region):
    lab, mask = _case(h, w, density, seed=2 * h + int(density * 10),
                      masked=not region)
    want = np.asarray(jax_col_scan(jnp.asarray(lab),
                                   jnp.asarray(mask.astype(np.int32)),
                                   interpret=True, region=region))
    got = scans.col_segmented_min_scan(_t(lab), _t(mask), region=region)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w", [(37, 53), (1, 17), (300, 7)])
@pytest.mark.parametrize("axis", [0, 1])
def test_scans_match_xla_any_shape(h, w, axis):
    """Shapes the TPU kernels refuse, and labels that are not INF off the
    mask (the run's two bordering pixels take part in the plain scan)."""
    lab, mask = _case(h, w, 0.5, seed=h * w + axis, masked=False)
    lab_j, mask_j = jnp.asarray(lab), jnp.asarray(mask)
    want = np.asarray(jcc._segmented_min_scan(lab_j, mask_j, axis))
    got = tcc._segmented_min_scan(_t(lab), _t(mask), axis)
    np.testing.assert_array_equal(got.numpy(), want)
    want_r = np.asarray(jcc._region_min_scan(
        lab_j, jnp.asarray(mask.astype(np.int32)), axis))
    got_r = tcc._region_min_scan(_t(lab), _t(mask), axis)
    np.testing.assert_array_equal(got_r.numpy(), want_r)


def test_scan_rows_cols_match_xla():
    lab, mask = _case(48, 80, 0.6, seed=5)
    want = np.asarray(jcc._scan_rows_cols(jnp.asarray(lab),
                                          jnp.asarray(mask)))
    got = tcc._scan_rows_cols(_t(lab), _t(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    m32 = jnp.asarray(mask.astype(np.int32))
    want_r = np.asarray(jcc._scan_rows_cols_region(jnp.asarray(lab), m32))
    got_r = tcc._scan_rows_cols_region(_t(lab), _t(mask))
    np.testing.assert_array_equal(got_r.numpy(), want_r)


def test_uint8_mask_equals_bool_mask():
    lab, mask = _case(33, 65, 0.5, seed=9, masked=False)
    for region in (False, True):
        a = scans.row_segmented_min_scan(_t(lab), _t(mask), region=region)
        b = scans.row_segmented_min_scan(_t(lab), _t(mask.astype(np.uint8)),
                                         region=region)
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "mask_dtype", "shape", "rank"])
def test_scan_wrapper_rejects_bad_input(bad):
    lab = torch.zeros((8, 8), dtype=torch.int32)
    mask = torch.ones((8, 8), dtype=torch.bool)
    if bad == "dtype":
        lab = lab.long()
    elif bad == "mask_dtype":
        mask = mask.int()
    elif bad == "shape":
        mask = mask[:4]
    else:
        lab, mask = lab[None], mask[None]
    with pytest.raises(ValueError):
        scans.row_segmented_min_scan(lab, mask)
    with pytest.raises(ValueError):
        scans.col_segmented_min_scan(lab, mask)


def test_cpu_tensors_never_count_as_launches():
    before = dict(scans.LAUNCHES)
    lab, mask = _case(16, 16, 0.5, seed=1)
    scans.row_segmented_min_scan(_t(lab), _t(mask))
    scans.col_segmented_min_scan(_t(lab), _t(mask), region=True)
    assert scans.LAUNCHES == before


@pytest.mark.cuda
def test_scan_kernels_match_plain_on_card(cuda_device):
    for h, w in [(2176, 2176), (1000, 1537), (4096, 200), (3, 5),
                 (1, 1), (2, 20011), (20011, 3)]:
        for density in (0.1, 0.5, 0.9):
            lab, mask = _case(h, w, density, seed=h + w, masked=False)
            lab_d, mask_d = _t(lab).to(cuda_device), _t(mask).to(cuda_device)
            masked = torch.where(mask_d, lab_d, INF)
            for region, inp in ((False, masked), (True, lab_d)):
                for dim, kern in ((1, scans.row_segmented_min_scan),
                                  (0, scans.col_segmented_min_scan)):
                    got = kern(inp, mask_d, region=region)
                    want = scans.segmented_min_scan_plain(inp, mask_d, dim,
                                                          region)
                    assert torch.equal(got, want), (h, w, density, region)
