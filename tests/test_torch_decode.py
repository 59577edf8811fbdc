"""Port parity: the 3-class decoders against the JAX package.

decode_interior_prob of the port (plain versions, CPU) against the JAX
device decode and the scipy golden on the same probability maps, bit for
bit; decode_boundary_watershed and the device area filters against the
JAX package's, bit for bit.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp  # noqa: E402  (conftest pins JAX to the CPU)

from cellseg_tpu.decode import threeclass as jdec
from cellseg_tpu.ops import cc as jcc
from cellseg_tpu_torch.decode import threeclass as tdec
from cellseg_tpu_torch.ops import cc as tcc

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


def _touching_cells(h, w, seed, n=40):
    """Interior and boundary probabilities of overlapping disks: the
    boundary class on each disk's rim, blurred, so touching cells meet
    across a thin boundary ridge."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    lab = np.zeros((h, w), np.int32)
    for i in range(n):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(5, 14)
        lab[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = i + 1
    rim = (ndimage.grey_dilation(lab, size=3) != ndimage.grey_erosion(
        lab, size=3)) & (lab > 0)
    interior = (lab > 0) & ~rim
    noise = rng.random((2, h, w)) * 0.1
    p_int = ndimage.gaussian_filter(interior.astype(float), 1.0) + noise[0]
    p_bnd = ndimage.gaussian_filter(rim.astype(float), 1.0) + noise[1]
    total = p_int + p_bnd + 0.2
    return ((p_int / total).astype(np.float32),
            (p_bnd / total).astype(np.float32))


@pytest.mark.parametrize("kind", ["touching", "noise"])
@pytest.mark.parametrize("h,w,seed", [(256, 512, 0), (96, 128, 1),
                                      (61, 83, 2)])
def test_boundary_watershed_matches_jax(kind, h, w, seed):
    if kind == "touching":
        p_int, p_bnd = _touching_cells(h, w, seed, n=max(4, h * w // 1500))
    else:
        p_int = _prob_map(h, w, seed)
        p_bnd = 0.5 * _prob_map(h, w, seed + 100)
    want = np.asarray(jdec.decode_boundary_watershed(jnp.asarray(p_int),
                                                     jnp.asarray(p_bnd)))
    got = tdec.decode_boundary_watershed(torch.from_numpy(p_int),
                                         torch.from_numpy(p_bnd))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 1


@pytest.mark.parametrize("h,w", [(256, 384), (96, 128), (61, 83)])
def test_decode_cc_stripe_route_matches_jax_and_golden(h, w):
    """cc_route="stripe": the same labels as the JAX device decode and the
    scipy golden, whether or not the route's gate admits the shape."""
    p = _prob_map(h, w, seed=h)
    want = np.asarray(jdec.decode_interior_prob(jnp.asarray(p)))
    got = tdec.decode_interior_prob(torch.from_numpy(p), cc_route="stripe")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  jdec.decode_interior_prob_host(p))
    assert want.max() > 1


@pytest.mark.parametrize("route", ["plain", "stripe"])
def test_boundary_watershed_cc_stripe_route_matches_jax(route):
    """The boundary decode with its CC work on the stripe route, on either
    watershed route: the labels of the global CC route."""
    p_int, p_bnd = _touching_cells(256, 256, seed=3, n=40)
    want = tdec.decode_boundary_watershed(torch.from_numpy(p_int),
                                          torch.from_numpy(p_bnd),
                                          route=route)
    got = tdec.decode_boundary_watershed(torch.from_numpy(p_int),
                                         torch.from_numpy(p_bnd),
                                         route=route, cc_route="stripe")
    assert torch.equal(got, want)
    if route == "plain":
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jdec.decode_boundary_watershed(jnp.asarray(p_int),
                                           jnp.asarray(p_bnd))))
    assert int(want.max()) > 1


def test_boundary_watershed_splits_touching_cells():
    """Two overlapping disks with a boundary ridge between them: CC on
    the interior merges them, the boundary watershed keeps two cells."""
    h, w = 48, 80
    yy, xx = np.mgrid[0:h, 0:w]
    d1 = np.hypot(yy - 24, xx - 26)
    d2 = np.hypot(yy - 24, xx - 52)
    cells = (d1 <= 15) | (d2 <= 15)
    ridge = np.abs(d1 - d2) <= 1.5
    p_int = np.where(cells & ~ridge, 0.9, 0.05).astype(np.float32)
    p_int[cells & ridge] = 0.55
    p_bnd = np.where(cells & ridge, 0.4, 0.05).astype(np.float32)
    cc = tdec.decode_interior_prob(torch.from_numpy(p_int)).numpy()
    bw = tdec.decode_boundary_watershed(torch.from_numpy(p_int),
                                        torch.from_numpy(p_bnd)).numpy()
    assert cc.max() == 1 and bw.max() == 2
    np.testing.assert_array_equal(bw > 0, cc > 0)
    np.testing.assert_array_equal(bw, np.asarray(
        jdec.decode_boundary_watershed(jnp.asarray(p_int),
                                       jnp.asarray(p_bnd))))


@pytest.mark.parametrize("density", [0.3, 0.55, 0.8])
@pytest.mark.parametrize("min_size,connectivity", [(4, 1), (16, 1), (16, 2),
                                                   (64, 2)])
def test_remove_small_objects_matches_jax(density, min_size, connectivity):
    mask = np.random.default_rng(int(density * 10)).random((72, 96)) < density
    want = np.asarray(jcc.remove_small_objects_jax(
        jnp.asarray(mask), min_size=min_size, connectivity=connectivity))
    got = tcc.remove_small_objects_torch(torch.from_numpy(mask), min_size,
                                         connectivity)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("density", [0.3, 0.55, 0.8])
@pytest.mark.parametrize("threshold", [8, 64, 100])
def test_remove_small_holes_matches_jax(density, threshold):
    """The decode's hole fill (4-conn, the reference's) with the object
    filter off."""
    mask = np.random.default_rng(int(density * 10) + 1).random(
        (72, 96)) < density
    want = np.asarray(jcc.remove_small_holes_jax(
        jnp.asarray(mask), area_threshold=threshold, connectivity=1))
    got = tdec._filtered_mask(torch.from_numpy(mask).float(),
                              hole_area=threshold, object_area=0)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_filtered_mask_is_the_area_filter_chain():
    """The mask the CC decode builds from one region propagation is
    remove_small_objects(remove_small_holes(p > 0.5)), which the boundary
    watershed uses as its mask."""
    p = _prob_map(120, 100, seed=7)
    mask = jcc.remove_small_holes_jax(jnp.asarray(p > 0.5), 64, 1)
    mask = jcc.remove_small_objects_jax(mask, 16, 1)
    np.testing.assert_array_equal(
        tdec._filtered_mask(torch.from_numpy(p))[0].numpy(), np.asarray(mask))


def _jax_stripe_route_decode(p_int, p_bnd, th_seed=0.7):
    """decode_boundary_watershed as the JAX package runs it on the TPU:
    its seeds and mask (threeclass.py:116-123), then watershed_jax's
    ws_local loop (ops/watershed.py:119-126) with the stripe kernel in
    interpret mode."""
    from cellseg_tpu.ops import watershed as jws
    from cellseg_tpu.ops.pallas.ws_local import stripe_ws_converge

    pi, pb = jnp.asarray(p_int), jnp.asarray(p_bnd)
    mask = jcc.remove_small_holes_jax(pi > 0.5, area_threshold=64,
                                      connectivity=1)
    mask = jcc.remove_small_objects_jax(mask, min_size=16, connectivity=1)
    core = jcc.remove_small_objects_jax(((pi - pb) > th_seed) & mask,
                                        min_size=4, connectivity=1)
    seeds = jcc.label_components(core, connectivity=2)
    e = jnp.where(mask, -pi, jws._BIG)
    state = (jnp.where(seeds > 0, e, jws._BIG),
             jnp.where(seeds > 0, 0, jws._INF_HOPS),
             jnp.where(seeds > 0, seeds, 0))
    for _ in range(512):
        new = jws.relax_once(*stripe_ws_converge(e, mask, *state,
                                                 interpret=True), e, mask)
        done = all(bool(jnp.all(a == b)) for a, b in zip(new, state))
        state = new
        if done:
            break
    return np.asarray(jnp.where(mask, state[2], 0))


@pytest.mark.parametrize("h,w,seed", [(256, 256, 0), (200, 128, 1),
                                      (136, 256, 2)])
def test_boundary_watershed_stripe_route_matches_jax_tpu_route(h, w, seed):
    p_int, p_bnd = _touching_cells(h, w, seed, n=max(4, h * w // 1500))
    want = _jax_stripe_route_decode(p_int, p_bnd)
    got = tdec.decode_boundary_watershed(torch.from_numpy(p_int),
                                         torch.from_numpy(p_bnd),
                                         route="stripe")
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 1
