"""Port parity: the 3-class CC decode against the JAX package.

decode_interior_prob of the port (plain versions, CPU) against the JAX
device decode and the scipy golden on the same probability maps, bit for
bit.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp  # noqa: E402  (conftest pins JAX to the CPU)

from cellseg_tpu.decode import threeclass as jdec
from cellseg_tpu_torch.decode import threeclass as tdec

torch.set_num_threads(1)


def _prob_map(h, w, seed, sigma=2.5):
    """Smoothed noise scaled to [0, 1]: blobs, holes and specks of every
    size around the 0.5 threshold."""
    rng = np.random.default_rng(seed)
    p = ndimage.gaussian_filter(rng.random((h, w)), sigma)
    return ((p - p.min()) / (p.max() - p.min())).astype(np.float32)


@pytest.mark.parametrize("h,w", [(96, 128), (61, 83)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_matches_jax_and_golden(h, w, seed):
    p = _prob_map(h, w, seed)
    want_j = np.asarray(jdec.decode_interior_prob(jnp.asarray(p)))
    want_h = jdec.decode_interior_prob_host(p)
    got = tdec.decode_interior_prob(torch.from_numpy(p))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_j)
    np.testing.assert_array_equal(got.numpy(), want_h)
    assert want_h.max() > 1  # the case has several instances


def test_decode_fills_holes_and_drops_specks():
    """A 60-px hole is filled, a 64-px hole kept, a 15-px object dropped,
    a 16-px object kept; diagonal touching merges (8-conn)."""
    p = np.zeros((64, 96), np.float32)
    p[2:22, 2:22] = 1.0
    p[5:11, 5:15] = 0.0   # 60 px hole: filled
    p[2:22, 30:50] = 1.0
    p[5:13, 33:41] = 0.0  # 64 px hole: kept
    p[40:43, 5:10] = 1.0  # 15 px: dropped
    p[40:44, 20:24] = 1.0  # 16 px: kept
    p[50:55, 60:65] = 1.0
    p[55:60, 65:70] = 1.0  # touches the block above at one corner
    got = tdec.decode_interior_prob(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, jdec.decode_interior_prob_host(p))
    np.testing.assert_array_equal(
        got, np.asarray(jdec.decode_interior_prob(jnp.asarray(p))))
    assert got[7, 7] == got[2, 2] != 0
    assert got[7, 35] == 0
    assert got[41, 7] == 0 and got[41, 21] != 0
    assert got[52, 62] == got[57, 67] != 0


@pytest.mark.parametrize("value", [0.0, 1.0])
def test_decode_constant_maps(value):
    p = np.full((40, 56), value, np.float32)
    got = tdec.decode_interior_prob(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, jdec.decode_interior_prob_host(p))


def test_host_golden_matches_jax_host_golden():
    p = _prob_map(80, 80, seed=5)
    np.testing.assert_array_equal(tdec.decode_interior_prob_host(p),
                                  jdec.decode_interior_prob_host(p))
