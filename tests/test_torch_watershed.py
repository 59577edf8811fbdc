"""Port parity: the marker watershed against the JAX package.

The port's `watershed` (plain versions, CPU) against the JAX package's on
continuous, quantized and integer-valued (tie-heavy) terrain, labels bit
for bit, on both routes: the plain route against `watershed_jax` on the
CPU (which takes it), and the stripe route against the JAX package's TPU
route (watershed_jax's ws_local loop body) run with the Pallas stripe
kernel in interpret mode, on shapes of several stripes. Also the
behavioural tie cases of tests/test_watershed_ties.py, the sweep budget
and the sequential golden.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402  (conftest pins JAX to the CPU)

from cellseg_tpu.ops import watershed as jws
from cellseg_tpu.ops.pallas.ws_local import stripe_ws_converge as jax_local
from cellseg_tpu_torch.ops import watershed as tws

torch.set_num_threads(1)


def _bumps(h, w, n, seed):
    """Max of n cone-shaped cells on faint noise, a marker at each peak."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cell = rng.random((h, w)).astype(np.float32) * 0.05
    markers = np.zeros((h, w), np.int32)
    cy = rng.integers(8, h - 8, n)
    cx = rng.integers(8, w - 8, n)
    r = rng.integers(10, 30, n)
    for i in range(n):
        d = np.sqrt((yy - cy[i]) ** 2 + (xx - cx[i]) ** 2)
        cell = np.maximum(cell, np.clip(1.0 - d / r[i], 0, None))
        markers[cy[i], cx[i]] = i + 1
    return -cell.astype(np.float32), markers, cell > 0.1


def _terrain(kind, h=256, w=512, seed=0):
    """(elevation, markers, mask) at a shape of several 64-row stripes."""
    if kind in ("bumps", "bumps_quantized"):
        image, markers, mask = _bumps(h, w, 60, seed)
        if kind == "bumps_quantized":
            image = np.round(image, 2).astype(np.float32)
        return image, markers, mask
    rng = np.random.default_rng(seed)
    if kind == "integer":
        image = rng.integers(0, 4, (h, w)).astype(np.float32)
    else:  # normal noise quantized to 0.5
        image = (np.round(rng.normal(size=(h, w)) * 2) / 2).astype(np.float32)
    mask = rng.random((h, w)) < 0.85
    markers = np.zeros((h, w), np.int32)
    n = 40
    markers[rng.integers(0, h, n), rng.integers(0, w, n)] = np.arange(1, n + 1)
    return image, markers, mask


def _both(image, markers, mask, **kw):
    want = np.asarray(jws.watershed_jax(jnp.asarray(image),
                                        jnp.asarray(markers),
                                        jnp.asarray(mask), **kw))
    got = tws.watershed(torch.from_numpy(image), torch.from_numpy(markers),
                        torch.from_numpy(mask), **kw)
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("kind", ["bumps", "bumps_quantized", "integer",
                                  "quantized"])
def test_watershed_matches_jax(kind):
    image, markers, mask = _terrain(kind)
    got, want = _both(image, markers, mask)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 10


@pytest.mark.parametrize("max_iters", [1, 13, 20])
def test_sweep_budget_matches_jax(max_iters):
    """A budget that is no multiple of the sweeps per launch stops after
    exactly max_iters sweeps, as the JAX loop does."""
    image, markers, mask = _terrain("integer", 64, 96, seed=2)
    got, want = _both(image, markers, mask, max_iters=max_iters)
    np.testing.assert_array_equal(got, want)


def test_markers_off_the_mask_match_jax():
    """A marker outside the mask still seeds (at cost 3e38) but is not
    labeled itself."""
    image, markers, mask = _terrain("quantized", 40, 56, seed=4)
    markers[~mask] = 99
    got, want = _both(image, markers, mask)
    np.testing.assert_array_equal(got, want)
    assert not got[~mask].any()


def _jax_stripe_route(image, markers, mask, max_iters=512):
    """watershed_jax's route on the TPU (cellseg_tpu/ops/watershed.py:
    112-126), with the stripe kernel in interpret mode."""
    m = jnp.asarray(mask)
    e = jnp.where(m, jnp.asarray(image, jnp.float32), jws._BIG)
    seeded = jnp.asarray(markers) > 0
    state = (jnp.where(seeded, e, jws._BIG),
             jnp.where(seeded, 0, jws._INF_HOPS),
             jnp.where(seeded, jnp.asarray(markers, jnp.int32), 0))
    for _ in range(max_iters):
        new = jws.relax_once(*jax_local(e, m, *state, interpret=True), e, m)
        done = all(bool(jnp.all(a == b)) for a, b in zip(new, state))
        state = new
        if done:
            break
    return np.asarray(jnp.where(m, state[2], 0))


@pytest.mark.parametrize("kind", ["bumps", "bumps_quantized", "integer",
                                  "quantized"])
@pytest.mark.parametrize("h,w", [(200, 128), (136, 256), (256, 256)])
def test_stripe_route_matches_jax_tpu_route(kind, h, w):
    image, markers, mask = _terrain(kind, h, w, seed=h)
    want = _jax_stripe_route(image, markers, mask)
    got = tws.watershed(torch.from_numpy(image), torch.from_numpy(markers),
                        torch.from_numpy(mask), route="stripe")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 10


def test_stripe_route_budget_counts_outer_iterations():
    image, markers, mask = _terrain("integer", 136, 256, seed=3)
    for max_iters in (1, 2):
        got = tws.watershed(torch.from_numpy(image),
                            torch.from_numpy(markers),
                            torch.from_numpy(mask), max_iters=max_iters,
                            route="stripe")
        np.testing.assert_array_equal(
            got.numpy(), _jax_stripe_route(image, markers, mask, max_iters))


def test_stripe_route_off_the_tpu_shapes_is_the_plain_route():
    """W not a multiple of 128: the TPU, and the port, take the plain
    route."""
    image, markers, mask = _terrain("integer", 64, 96, seed=5)
    args = [torch.from_numpy(a) for a in (image, markers, mask)]
    assert not tws.stripe_route_supported(64, 96)
    assert tws.stripe_route_supported(64, 128)
    np.testing.assert_array_equal(tws.watershed(*args, route="stripe"),
                                  tws.watershed(*args))


@pytest.mark.parametrize("route", ["plain", "stripe"])
def test_watershed_plain_equals_watershed(route):
    image, markers, mask = _terrain("quantized", 64, 128, seed=8)
    args = [torch.from_numpy(a) for a in (image, markers, mask)]
    assert torch.equal(tws.watershed_plain(*args, route=route),
                       tws.watershed(*args, route=route))


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="route"):
        tws.watershed(torch.zeros(8, 8), torch.zeros(8, 8, dtype=torch.int32),
                      torch.ones(8, 8, dtype=torch.bool), route="local")


def test_flat_plateau_splits_by_arrival_not_marker_id():
    """A flat corridor with a marker at each end splits near the middle
    (tests/test_watershed_ties.py)."""
    h, w = 9, 41
    markers = np.zeros((h, w), np.int32)
    markers[4, 0] = 1
    markers[4, w - 1] = 2
    lab = tws.watershed(torch.zeros((h, w)), torch.from_numpy(markers),
                        torch.ones((h, w), dtype=torch.bool)).numpy()
    n1, n2 = int((lab == 1).sum()), int((lab == 2).sum())
    assert n1 + n2 == h * w
    assert abs(n1 - n2) <= h, (n1, n2)


def test_plateau_goes_to_nearest_marker():
    h, w = 7, 40
    markers = np.zeros((h, w), np.int32)
    markers[3, 0] = 1
    markers[3, 30] = 2
    lab = tws.watershed(torch.zeros((h, w)), torch.from_numpy(markers),
                        torch.ones((h, w), dtype=torch.bool)).numpy()
    assert lab[3, 35] == 2
    assert lab[3, 5] == 1


def test_quantized_predictions_device_vs_host_agreement():
    """Quantized basins (massive cost ties): the relaxation agrees with
    the sequential priority-flood golden on >= 99% of the mask."""
    h, w = 128, 128
    cell = np.zeros((h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    centers = [(32, 32), (32, 90), (90, 40), (88, 96), (64, 64)]
    markers = np.zeros((h, w), np.int32)
    for i, (cy, cx) in enumerate(centers):
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        cell = np.maximum(cell, np.clip(1.0 - d / 24.0, 0, None))
        markers[cy, cx] = i + 1
    cell_q = np.round(cell.astype(np.float32), 2)
    mask = cell_q > 0.05
    lab = tws.watershed(torch.from_numpy(-cell_q), torch.from_numpy(markers),
                        torch.from_numpy(mask)).numpy()
    lab_host = tws.watershed_host(-cell_q, markers, mask)
    assert set(np.unique(lab)) == set(np.unique(lab_host))
    agree = float((lab[mask] == lab_host[mask]).mean())
    assert agree >= 0.99, agree


def test_host_golden_matches_jax_host_golden():
    image, markers, mask = _terrain("bumps_quantized", 64, 80, seed=6)
    np.testing.assert_array_equal(
        tws.watershed_host(image, markers, mask),
        jws.watershed_host(image, markers, mask))
