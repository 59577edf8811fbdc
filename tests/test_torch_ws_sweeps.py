"""Port parity: the fused watershed relaxation sweeps (B6) against JAX.

The port's plain version (CPU) against the Pallas kernel in interpret
mode and against k calls of the JAX package's relax_once, on the inputs
tests/test_pallas_ws_sweeps.py builds, plus integer-valued (tie-heavy)
elevations: cost, hops and label planes bit for bit. The CUDA kernel is
held against the plain version on the card (marker `cuda`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402  (conftest pins JAX to the CPU)

from cellseg_tpu.ops import watershed as jws
from cellseg_tpu.ops.pallas.ws_sweeps import fused_ws_sweeps as jax_fused
from cellseg_tpu_torch.ops import watershed as tws
from cellseg_tpu_torch.ops.kernels import (
    launch_counts,
    reset_launch_counts,
    ws_sweeps,
)

torch.set_num_threads(1)
TERRAINS = ("continuous", "quantized", "integer")


def _world(h, w, n_seeds, seed, terrain="continuous", density=0.85):
    """(e, mask, cost, hops, label) as numpy arrays: the watershed's
    initial state over random elevations, as test_pallas_ws_sweeps.py
    builds it."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(h, w)).astype(np.float32)
    if terrain == "quantized":
        img = np.round(img * 2) / 2  # plateau-heavy elevation
    elif terrain == "integer":
        img = rng.integers(0, 4, (h, w)).astype(np.float32)
    mask = rng.random((h, w)) < density
    markers = np.zeros((h, w), np.int32)
    ys = rng.integers(0, h, n_seeds)
    xs = rng.integers(0, w, n_seeds)
    markers[ys, xs] = np.arange(1, n_seeds + 1)
    markers *= mask
    e = np.where(mask, img, jws._BIG).astype(np.float32)
    seeded = markers > 0
    cost = np.where(seeded, e, jws._BIG).astype(np.float32)
    hops = np.where(seeded, 0, int(jws._INF_HOPS)).astype(np.int32)
    label = np.where(seeded, markers, 0).astype(np.int32)
    return e, mask, cost, hops, label


def _torch(arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _jax_relax(state, e, mask, n):
    c, h, lab = (jnp.asarray(a) for a in state)
    e_j, m_j = jnp.asarray(e), jnp.asarray(mask)
    for _ in range(n):
        c, h, lab = jws.relax_once(c, h, lab, e_j, m_j)
    return [np.asarray(a) for a in (c, h, lab)]


def _assert_planes_equal(got, want):
    for g, wnt, name in zip(got, want, ("cost", "hops", "label")):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(wnt), err_msg=name)


@pytest.fixture
def cuda_device():
    """The card, for kernel tests; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("h,w", [(128, 128), (192, 256)])
@pytest.mark.parametrize("terrain", TERRAINS)
def test_plain_matches_pallas_interpret(h, w, terrain):
    e, mask, cost, hops, label = _world(h, w, 24, seed=h, terrain=terrain)
    want = jax_fused(*(jnp.asarray(a) for a in (e, mask, cost, hops, label)),
                     k=8, stripe=64, interpret=True)
    got = ws_sweeps.fused_ws_sweeps(*_torch((e, mask, cost, hops, label)),
                                    k=8)
    _assert_planes_equal(got, want)


@pytest.mark.parametrize("h,w", [(64, 128), (37, 53)])
@pytest.mark.parametrize("terrain", TERRAINS)
@pytest.mark.parametrize("k", [1, 3, 8])
def test_plain_matches_k_relax_once(h, w, terrain, k):
    e, mask, cost, hops, label = _world(h, w, 12, seed=w + k,
                                        terrain=terrain)
    want = _jax_relax((cost, hops, label), e, mask, k)
    got = ws_sweeps.fused_ws_sweeps(*_torch((e, mask, cost, hops, label)),
                                    k=k)
    _assert_planes_equal(got, want)


@pytest.mark.parametrize("terrain", TERRAINS)
@pytest.mark.parametrize("density", [0.5, 0.85])
def test_relax_once_matches_jax_mid_flood(terrain, density):
    """relax_once from a state ten sweeps into the flood, where fronts
    meet and the hops and label tie-breaks decide."""
    e, mask, cost, hops, label = _world(48, 72, 30, seed=5, terrain=terrain,
                                        density=density)
    state = _jax_relax((cost, hops, label), e, mask, 10)
    want = _jax_relax(state, e, mask, 1)
    e_t, mask_t = torch.from_numpy(e), torch.from_numpy(mask)
    got = tws.relax_once(*_torch(state), e_t, mask_t)
    _assert_planes_equal(got, want)


def test_more_than_one_launch_worth_of_sweeps():
    """k above one launch's budget composes: 20 sweeps == 8 + 8 + 4."""
    e, mask, cost, hops, label = _world(40, 40, 6, seed=3,
                                        terrain="integer")
    got = ws_sweeps.fused_ws_sweeps(*_torch((e, mask, cost, hops, label)),
                                    k=20)
    _assert_planes_equal(got, _jax_relax((cost, hops, label), e, mask, 20))


def test_uint8_mask_equals_bool_mask():
    e, mask, cost, hops, label = _world(30, 41, 8, seed=9)
    e, mask_b, cost, hops, label = _torch((e, mask, cost, hops, label))
    a = ws_sweeps.fused_ws_sweeps(e, mask_b, cost, hops, label, k=5)
    b = ws_sweeps.fused_ws_sweeps(e, mask_b.to(torch.uint8), cost, hops,
                                  label, k=5)
    _assert_planes_equal(a, b)


@pytest.mark.parametrize("bad", ["k", "dtype", "shape", "dims"])
def test_fused_ws_sweeps_rejects_bad_arguments(bad):
    e, mask, cost, hops, label = _torch(_world(8, 8, 2, seed=0))
    kw = {"k": 1}
    if bad == "k":
        kw["k"] = 0
    elif bad == "dtype":
        hops = hops.to(torch.int64)
    elif bad == "shape":
        label = label[:, :7]
    else:
        e, mask, cost, hops, label = (t[None] for t in
                                      (e, mask, cost, hops, label))
    with pytest.raises(ValueError):
        ws_sweeps.fused_ws_sweeps(e, mask, cost, hops, label, **kw)


def test_cpu_tensors_never_count_as_launches():
    reset_launch_counts()
    ws_sweeps.fused_ws_sweeps(*_torch(_world(16, 16, 3, seed=1)), k=9)
    assert launch_counts()["fused_ws_sweeps"] == 0


@pytest.mark.cuda
def test_ws_sweeps_kernel_matches_plain_on_card(cuda_device):
    for h, w in [(2176, 2176), (1000, 1537), (4096, 200), (3, 5),
                 (1, 1), (2, 20011), (20011, 3)]:
        for terrain in TERRAINS:
            for density in (0.5, 0.85):
                planes = _world(h, w, max(2, h * w // 4000), seed=h + w,
                                terrain=terrain, density=density)
                args = [torch.from_numpy(a).to(cuda_device) for a in planes]
                for k in (1, 8, 20):
                    got = ws_sweeps.fused_ws_sweeps(*args, k=k)
                    want = ws_sweeps.fused_ws_sweeps_plain(*args, k=k)
                    for g, wnt in zip(got, want):
                        assert torch.equal(g, wnt), (h, w, terrain, k)
