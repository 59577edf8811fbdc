"""Port parity: connected components and rank areas against the JAX package.

label_components, region_roots, the relabel tails and the rank-area
filters of the port (plain versions, CPU) against ops/cc.py,
ops/rank_areas.py and scipy.ndimage, bit for bit, at both connectivities
and several densities, plus a serpentine that needs the phase-2 sweeps.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp  # noqa: E402  (conftest pins JAX to the CPU)

from cellseg_tpu.ops import cc as jcc
from cellseg_tpu.ops import rank_areas as jra
from cellseg_tpu_torch.ops import cc as tcc
from cellseg_tpu_torch.ops import rank_areas as tra

torch.set_num_threads(1)
INF = 2**31 - 1
H, W = 48, 80


def _t(a):
    """A torch tensor holding a copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(a))


def _mask(density, seed, shape=(H, W)):
    return np.random.default_rng(seed).random(shape) < density


def _serpentine(n=64):
    """2-px corridors and walls joined at alternating ends: one
    propagation iteration per corridor, so more than the 12 cheap ones."""
    mask = np.zeros((n, n), bool)
    rows = list(range(0, n - 1, 4))
    for k, r in enumerate(rows):
        mask[r:r + 2, 1:n - 1] = True
        if k + 1 < len(rows):
            c = n - 2 if k % 2 == 0 else 1
            mask[r + 2:r + 4, c] = True
    return mask


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("density", [0.2, 0.5, 0.8])
def test_label_components_matches_jax_and_scipy(connectivity, density):
    mask = _mask(density, seed=int(density * 10) + connectivity)
    want_j = np.asarray(jcc.label_components(jnp.asarray(mask),
                                             connectivity=connectivity))
    want_s, _ = ndimage.label(
        mask, ndimage.generate_binary_structure(2, connectivity))
    got = tcc.label_components(torch.from_numpy(mask), connectivity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_j)
    np.testing.assert_array_equal(got.numpy(), want_s)


@pytest.mark.parametrize("connectivity", [1, 2])
def test_serpentine_reaches_phase_two(connectivity, monkeypatch):
    mask = _serpentine()
    heavy = []
    real = tcc._heavy_body

    def spy(lab, m, conn):
        heavy.append(conn)
        return real(lab, m, conn)

    monkeypatch.setattr(tcc, "_heavy_body", spy)
    got = tcc.label_components(torch.from_numpy(mask), connectivity)
    want_j = np.asarray(jcc.label_components(jnp.asarray(mask),
                                             connectivity=connectivity))
    np.testing.assert_array_equal(got.numpy(), want_j)
    assert int(got.max()) == 1
    assert heavy, "the serpentine converged without the fused sweeps"


@pytest.mark.parametrize("density", [0.0, 0.3, 0.6, 1.0])
def test_region_roots_matches_jax(density):
    mask = _mask(density, seed=7 + int(density * 10))
    want = np.asarray(jcc.region_roots(jnp.asarray(mask)))
    got = tcc.region_roots(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    # roots are component-min indices, so ranking them per side gives
    # scipy's raster-order 4-conn labels of the mask and of its complement
    cross = ndimage.generate_binary_structure(2, 1)
    for side in (mask, ~mask):
        labels, _ = ndimage.label(side, cross)
        ranks = np.searchsorted(np.unique(got[side]), got[side]) + 1
        np.testing.assert_array_equal(ranks, labels[side])


@pytest.mark.parametrize("connectivity", [1, 2])
def test_propagate_matches_jax(connectivity):
    mask = _mask(0.55, seed=11)
    lin = np.arange(H * W, dtype=np.int32).reshape(H, W)
    lab = np.where(mask, lin, INF).astype(np.int32)
    want = np.asarray(jcc._propagate(jnp.asarray(lab), jnp.asarray(mask),
                                     connectivity, 1024))
    got = tcc._propagate(torch.from_numpy(lab), torch.from_numpy(mask),
                         connectivity)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sequential_from_roots_matches_jax():
    mask = _mask(0.5, seed=12)
    lin = np.arange(H * W, dtype=np.int32).reshape(H, W)
    roots = np.asarray(jcc._propagate(
        jnp.asarray(np.where(mask, lin, INF).astype(np.int32)),
        jnp.asarray(mask), 2, 1024))
    want = np.asarray(jcc.sequential_from_roots(
        jnp.asarray(roots), jnp.asarray(mask), 2))
    got = tcc.sequential_from_roots(_t(roots),
                                    torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("density", [0.3, 0.6])
def test_dense_region_ranks_matches_jax(density):
    mask = _mask(density, seed=13)
    m32 = jnp.asarray(mask.astype(np.int32))
    roots = jcc.region_roots(jnp.asarray(mask))
    dense_j, r_j, k_j = jra.dense_region_ranks(roots, m32)
    dense_t, r_t = tra.dense_region_ranks(_t(roots))
    np.testing.assert_array_equal(dense_t.numpy(), np.asarray(dense_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    assert int(r_t[-1, -1]) == int(k_j)


@pytest.mark.parametrize("threshold", [2, 5, 16])
@pytest.mark.parametrize("background", [False, True])
def test_small_mask_by_rank_matches_jax(threshold, background):
    mask = _mask(0.45, seed=14)
    roots = jcc.region_roots(jnp.asarray(mask))
    dense_j, _, k_j = jra.dense_region_ranks(
        roots, jnp.asarray(mask.astype(np.int32)))
    domain = ~mask if background else mask
    want = np.asarray(jra.small_mask_guarded(dense_j, k_j,
                                             jnp.asarray(domain), threshold))
    got = tra.small_mask_by_rank(_t(dense_j),
                                 torch.from_numpy(domain), threshold)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sequential_from_ranks_matches_jax():
    """The decode's relabel tail: table lookup == seeded propagation."""
    mask = _mask(0.5, seed=15)
    m_j = jnp.asarray(mask)
    roots = jcc.region_roots(m_j)
    dense, r_plane, _ = jra.dense_region_ranks(
        roots, jnp.asarray(mask.astype(np.int32)))
    lab = jcc._propagate(jnp.where(m_j, dense, jcc._INF), m_j, 2, 1024)
    want = np.asarray(jcc.sequential_from_ranks(lab, r_plane, roots, m_j, 2))
    got = tcc.sequential_from_ranks(_t(lab), _t(r_plane), _t(roots),
                                    _t(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_empty_and_full_masks():
    for mask in (np.zeros((9, 13), bool), np.ones((9, 13), bool)):
        for conn in (1, 2):
            got = tcc.label_components(torch.from_numpy(mask), conn).numpy()
            want, _ = ndimage.label(
                mask, ndimage.generate_binary_structure(2, conn))
            np.testing.assert_array_equal(got, want)
