"""Port parity: the block-local CC convergence (B4) and the CC stripe route
against the JAX package.

- The port's plain `stripe_converge` (CPU) against the Pallas kernel
  (ops/pallas/local_cc.py:stripe_converge) in interpret mode, bit for bit:
  at the JAX package's own stripe on shapes it splits into several stripes
  (128x2048: 2 of 64 rows; 256x1024: 2 of 128), and at the port's 16-row
  stripe on 64x128 against the Pallas kernel run on each 16-row slab
  alone; connectivity 1 and 2, region on and off, caps 1 and 3 (binding)
  and 16.
- The stripe route (`route="stripe"`) of label_components, region_roots,
  _propagate and remove_small_objects_torch against the JAX package's
  global route, scipy, and the JAX block-local outer loop rebuilt as in
  tests/test_pallas_local_cc.py, on a shape the route's gate admits
  (256x384) and one it does not (200x300).
- The CUDA kernel against the plain version on the card (marker `cuda`).
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp  # noqa: E402  (conftest pins JAX to the CPU)

from cellseg_tpu.ops import cc as jcc
from cellseg_tpu.ops.pallas.local_cc import _h_stripe
from cellseg_tpu.ops.pallas.local_cc import stripe_converge as jax_converge
from cellseg_tpu.ops.pallas.scans import col_segmented_min_scan as jax_col
from cellseg_tpu_torch.ops import cc as tcc
from cellseg_tpu_torch.ops.kernels import (
    launch_counts,
    local_cc,
    reset_launch_counts,
)

torch.set_num_threads(1)
INF = 2**31 - 1
# (connectivity, region); connectivity plays no part in region mode
MODES = [(1, False), (2, False), (1, True)]
MODE_IDS = ["conn1", "conn2", "region"]


def _inputs(h, w, density, seed, region):
    """(labels, mask) as numpy: linear indices, INF off the mask in plain
    mode, on a random mask."""
    mask = np.random.default_rng(seed).random((h, w)) < density
    lin = np.arange(h * w, dtype=np.int32).reshape(h, w)
    lab = lin if region else np.where(mask, lin, INF).astype(np.int32)
    return lab, mask


def _jax(lab, mask, connectivity, region, cap):
    return np.asarray(jax_converge(
        jnp.asarray(lab), jnp.asarray(mask.astype(np.int32)),
        connectivity=connectivity, region=region, cap=cap, interpret=True))


def _port(lab, mask, connectivity, region, cap, stripe=None, rounds=None):
    return local_cc.stripe_converge(
        torch.from_numpy(lab), torch.from_numpy(mask), connectivity, region,
        cap, stripe=stripe, rounds=rounds).numpy()


@pytest.fixture
def cuda_device():
    """The card, for kernel tests; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def test_stripe_heights():
    """jax_stripe is the JAX package's; cc_stripe is the largest divisor of
    H from 8 to it that fits in a block's shared memory."""
    for h, w in [(128, 2048), (256, 1024), (16, 128), (2176, 2176),
                 (1024, 1024), (256, 384), (48, 128), (200, 4096)]:
        assert local_cc.jax_stripe(h, w) == _h_stripe(h, w)
        s = local_cc.cc_stripe(h, w)
        assert s is not None and s >= 8 and h % s == 0
        assert s <= _h_stripe(h, w)
        assert local_cc.stripe_fits(s, w)
        assert local_cc.BYTES_PER_PX * s * w <= local_cc.SMEM_BYTES
        assert not any(h % t == 0 and local_cc.stripe_fits(t, w)
                       for t in range(s + 1, _h_stripe(h, w) + 1))
    # 2176 = 17 x 128: 128 stripes of 17 rows, one block each on 132 SMs
    assert local_cc.cc_stripe(2176, 2176) == 17
    assert local_cc.cc_stripe(1024, 1024) == 32
    assert local_cc.cc_stripe(128, 2048) == 16
    assert local_cc.cc_stripe(2048, 5760) == 8
    # no 8-row stripe fits, or no multiple of 8 divides H
    assert local_cc.cc_stripe(2048, 5888) is None
    assert local_cc.cc_stripe(100, 128) is None


@pytest.mark.parametrize("h,w", [(128, 2048), (256, 1024)])
@pytest.mark.parametrize("connectivity,region", MODES, ids=MODE_IDS)
def test_plain_matches_pallas_interpret(h, w, connectivity, region):
    assert h // _h_stripe(h, w) == 2
    lab, mask = _inputs(h, w, 0.45, seed=h + connectivity, region=region)
    want = _jax(lab, mask, connectivity, region, 16)
    got = _port(lab, mask, connectivity, region, 16, stripe=_h_stripe(h, w))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [1, 3])
@pytest.mark.parametrize("connectivity,region", MODES, ids=MODE_IDS)
def test_binding_cap_matches_pallas_interpret(cap, connectivity, region):
    """A stripe that has not converged stops after exactly `cap` rounds."""
    h, w = 128, 2048
    lab, mask = _inputs(h, w, 0.55, seed=cap, region=region)
    want = _jax(lab, mask, connectivity, region, cap)
    rounds = torch.zeros(2, dtype=torch.int32)
    got = _port(lab, mask, connectivity, region, cap, stripe=64,
                rounds=rounds)
    np.testing.assert_array_equal(got, want)
    assert rounds.tolist() == [cap, cap]


@pytest.mark.parametrize("cap", [1, 16])
@pytest.mark.parametrize("connectivity,region", MODES, ids=MODE_IDS)
def test_port_stripe_matches_pallas_on_slabs(cap, connectivity, region):
    """The port's stripe height (16 rows) on 64x128: each slab of 16 rows
    is the Pallas kernel's result on that slab alone (its own stripe for a
    16x128 plane is 16)."""
    assert _h_stripe(16, 128) == 16
    lab, mask = _inputs(64, 128, 0.5, seed=3 + cap, region=region)
    got = _port(lab, mask, connectivity, region, cap, stripe=16)
    for i in range(4):
        rows = slice(16 * i, 16 * i + 16)
        want = _jax(lab[rows], mask[rows], connectivity, region, cap)
        np.testing.assert_array_equal(got[rows], want)


@pytest.mark.parametrize("connectivity,region", MODES, ids=MODE_IDS)
def test_rounds_are_each_stripes_own_count(connectivity, region):
    """rounds[i] = r < cap: the r-th round changed nothing, so r - 1 rounds
    give the stripe's result and r - 2 do not."""
    h, w = 96, 256
    lab, mask = _inputs(h, w, 0.3, seed=5, region=region)
    rounds = torch.zeros(h // 16, dtype=torch.int32)
    got = _port(lab, mask, connectivity, region, 64, stripe=16,
                rounds=rounds)
    assert 2 <= int(rounds.min()) and int(rounds.max()) < 64
    for i, r in enumerate(rounds.tolist()):
        rows = slice(16 * i, 16 * i + 16)
        part = lab[rows].copy(), mask[rows].copy()
        assert np.array_equal(
            _port(*part, connectivity, region, r - 1), got[rows])
        assert not np.array_equal(
            _port(*part, connectivity, region, r - 2), got[rows])


def test_uint8_regions_of_several_values():
    """Region mode on a mask of values 0-3: runs of equal value."""
    rng = np.random.default_rng(8)
    vals = rng.integers(0, 4, (32, 128)).astype(np.uint8)
    lab = np.arange(32 * 128, dtype=np.int32).reshape(32, 128)
    want = np.asarray(jax_converge(jnp.asarray(lab),
                                   jnp.asarray(vals.astype(np.int32)),
                                   region=True, interpret=True))
    got = _port(lab, vals, 1, True, 16, stripe=_h_stripe(32, 128))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", ["stripe", "no_stripe", "cap",
                                 "connectivity", "rounds", "dtype"])
def test_stripe_converge_rejects_bad_arguments(bad):
    lab, mask = (torch.from_numpy(a) for a in _inputs(32, 128, 0.5, 0, False))
    kw = {}
    if bad == "stripe":
        kw["stripe"] = 7
    elif bad == "no_stripe":
        lab, mask = lab[:3], mask[:3]
    elif bad == "cap":
        kw["cap"] = -1
    elif bad == "connectivity":
        kw["connectivity"] = 3
    elif bad == "rounds":
        kw["rounds"] = torch.zeros(2, dtype=torch.int64)
    else:
        lab = lab.to(torch.int64)
    with pytest.raises(ValueError):
        local_cc.stripe_converge(lab, mask, **kw)


def test_cpu_tensors_never_count_as_launches():
    reset_launch_counts()
    lab, mask = _inputs(32, 128, 0.5, 1, False)
    local_cc.stripe_converge(torch.from_numpy(lab), torch.from_numpy(mask))
    mask_t = torch.from_numpy(mask)
    assert tcc.stripe_route_supported(*mask_t.shape)
    tcc.label_components(mask_t, 2, route="stripe")
    assert launch_counts()["stripe_converge"] == 0


def test_stripe_route_gate():
    """The JAX gate's shapes, with the port's stripe: decided from the
    shape alone."""
    admitted = [(256, 384), (2176, 2176), (8, 128), (3072, 256),
                (2048, 5760)]
    refused = [(200, 300), (256, 200), (100, 128), (3080, 128),
               (2048, 5888), (0, 0)]
    for h, w in admitted:
        assert tcc.stripe_route_supported(h, w), (h, w)
    for h, w in refused:
        assert not tcc.stripe_route_supported(h, w), (h, w)


@pytest.mark.parametrize("route", ["local", "Stripe", ""])
def test_unknown_route_raises(route):
    mask = torch.ones(8, 128, dtype=torch.bool)
    with pytest.raises(ValueError, match="route"):
        tcc.label_components(mask, route=route)
    with pytest.raises(ValueError, match="route"):
        tcc.region_roots(mask, route=route)


def _spy_stripe_route(monkeypatch):
    """Record every stripe_converge call made through ops/cc.py."""
    calls = []
    real = tcc.stripe_converge

    def spy(*args, **kw):
        calls.append(kw.get("region", False))
        return real(*args, **kw)

    monkeypatch.setattr(tcc, "stripe_converge", spy)
    return calls


@pytest.mark.parametrize("h,w", [(256, 384), (200, 300)])
@pytest.mark.parametrize("connectivity", [1, 2])
def test_label_components_stripe_route_matches_jax(h, w, connectivity,
                                                   monkeypatch):
    mask = np.random.default_rng(h + connectivity).random((h, w)) < 0.55
    calls = _spy_stripe_route(monkeypatch)
    got = tcc.label_components(torch.from_numpy(mask), connectivity,
                               route="stripe").numpy()
    want = np.asarray(jcc.label_components(jnp.asarray(mask),
                                           connectivity=connectivity))
    np.testing.assert_array_equal(got, want)
    want_s, _ = ndimage.label(
        mask, ndimage.generate_binary_structure(2, connectivity))
    np.testing.assert_array_equal(got, want_s)
    assert bool(calls) == tcc.stripe_route_supported(h, w)


@pytest.mark.parametrize("h,w", [(256, 384), (200, 300)])
def test_region_roots_stripe_route_matches_jax(h, w, monkeypatch):
    mask = np.random.default_rng(w).random((h, w)) < 0.5
    calls = _spy_stripe_route(monkeypatch)
    got = tcc.region_roots(torch.from_numpy(mask), route="stripe").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcc.region_roots(jnp.asarray(mask))))
    assert calls == ([True] * len(calls)
                     if tcc.stripe_route_supported(h, w) else [])
    assert bool(calls) == tcc.stripe_route_supported(h, w)


@pytest.mark.parametrize("h,w", [(256, 384), (200, 300)])
@pytest.mark.parametrize("min_size,connectivity", [(4, 1), (16, 2)])
def test_remove_small_objects_stripe_route_matches_jax(h, w, min_size,
                                                       connectivity):
    mask = np.random.default_rng(min_size).random((h, w)) < 0.45
    got = tcc.remove_small_objects_torch(torch.from_numpy(mask), min_size,
                                         connectivity, route="stripe")
    want = np.asarray(jcc.remove_small_objects_jax(
        jnp.asarray(mask), min_size=min_size, connectivity=connectivity))
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_outer_fixed_point(lab, mask, connectivity=1, region=False):
    """The JAX block-local route (ops/cc.py:_propagate / _propagate_region
    with CELLSEG_LOCALCC=1) rebuilt with the Pallas kernels in interpret
    mode, as tests/test_pallas_local_cc.py does."""
    m = jnp.asarray(mask.astype(np.int32))
    cur = jnp.asarray(lab)
    for _ in range(64):
        new = jax_converge(cur, m, connectivity=connectivity, region=region,
                           interpret=True)
        new = jax_col(new, m, region=region, interpret=True)
        if connectivity == 2 and not region:
            new = jcc._sweep_min(new, jnp.asarray(mask), 2)
        if bool(jnp.all(new == cur)):
            return np.asarray(cur)
        cur = new
    raise AssertionError("outer loop did not converge")


@pytest.mark.parametrize("connectivity,region", MODES, ids=MODE_IDS)
def test_stripe_route_matches_jax_block_local_route(connectivity, region):
    h, w = 256, 384
    lab, mask = _inputs(h, w, 0.5, seed=11 + connectivity, region=region)
    want = _jax_outer_fixed_point(lab, mask, connectivity, region)
    if region:
        got = tcc._propagate_region(torch.from_numpy(lab),
                                    torch.from_numpy(mask), route="stripe")
    else:
        got = tcc._propagate(torch.from_numpy(lab), torch.from_numpy(mask),
                             connectivity, route="stripe")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("connectivity", [1, 2])
def test_stripe_route_iterations_stop_at_max_iters(connectivity,
                                                   monkeypatch):
    """The route's outer loop runs at most max_iters bodies, as the global
    route does; a budget of 1 leaves a labyrinth unconverged."""
    calls = _spy_stripe_route(monkeypatch)
    h, w = 64, 1024
    assert local_cc.cc_stripe(h, w) == 32
    mask = np.zeros((h, w), bool)
    for k, r in enumerate(range(0, h - 1, 4)):  # a serpentine, 2 stripes
        mask[r:r + 2, 1:w - 1] = True
        if r + 4 < h:
            c = w - 2 if k % 2 == 0 else 1
            mask[r + 2:r + 4, c] = True
    mask_t = torch.from_numpy(mask)
    lab = torch.where(mask_t, torch.arange(h * w, dtype=torch.int32).view(
        h, w), INF)
    one = tcc._propagate(lab, mask_t, connectivity, max_iters=1,
                         route="stripe")
    assert len(calls) == 1
    full = tcc._propagate(lab, mask_t, connectivity, route="stripe")
    assert len(calls) > 2 and not torch.equal(one, full)
    assert int(tcc.sequential_from_roots(full, mask_t).max()) == 1


@pytest.mark.cuda
def test_local_cc_kernel_matches_plain_on_card(cuda_device):
    """Every mode, densities from sparse to dense, binding and loose caps,
    arbitrary labels off the mask, ragged widths, 1-row stripes, rows
    whose threads straddle warps (17, 24 and 3 rows), and a stripe of more
    rows than the block has threads: the labels and the rounds per stripe
    equal."""
    rng = np.random.default_rng(0)
    cases = [(2176, 2176, None), (2176, 2176, 16), (1024, 1024, None),
             (256, 384, None), (2048, 5760, None), (64, 200, 8),
             (24, 1000, 24), (3, 5, 3), (1, 1, 1), (5, 33, 1),
             (1100, 7, 1100)]
    assert local_cc.cc_stripe(2176, 2176) == 17
    for h, w, stripe in cases:
        n = h // (stripe or local_cc.cc_stripe(h, w))
        for density in (0.1, 0.5, 0.9):
            mask = torch.from_numpy(rng.random((h, w)) < density)
            vals = torch.from_numpy(
                rng.integers(0, h * w, (h, w)).astype(np.int32))
            regions = torch.from_numpy(
                rng.integers(0, 3, (h, w)).astype(np.uint8))
            inputs = [(torch.where(mask, vals, INF), mask, 1, False),
                      (torch.where(mask, vals, INF), mask, 2, False),
                      (vals, mask, 2, False),
                      (vals, mask, 1, True), (vals, regions, 1, True)]
            for lab, m, conn, region in inputs:
                lab, m = lab.to(cuda_device), m.to(cuda_device)
                for cap in (16, 2, 0):
                    r_got = torch.zeros(n, dtype=torch.int32,
                                        device=cuda_device)
                    r_want = torch.zeros_like(r_got)
                    got = local_cc.stripe_converge(
                        lab, m, conn, region, cap, stripe, r_got)
                    torch.cuda.synchronize()
                    want = local_cc.stripe_converge_plain(
                        lab, m, conn, region, cap, stripe, r_want)
                    key = (h, w, density, conn, region, cap)
                    assert torch.equal(got, want), key
                    assert torch.equal(r_got, r_want), key
