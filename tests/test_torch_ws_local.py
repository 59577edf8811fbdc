"""Port parity: the block-local watershed convergence (B5) against JAX.

The port's plain version (CPU) against the Pallas kernel
(ops/pallas/ws_local.py:stripe_ws_converge) in interpret mode, on shapes
of several stripes (the JAX package's own stripe choice: 5 stripes of 40
rows at 200x128, 17 of 8 at 136x256, 2 of 128 at 256x256), over
continuous, 0.5-quantized and integer-valued (tie-heavy) elevations, from
the initial state and from mid-flood: cost, hops and label planes bit for
bit. The CUDA kernel is held against the plain version on the card
(marker `cuda`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402  (conftest pins JAX to the CPU)

from cellseg_tpu.ops import watershed as jws
from cellseg_tpu.ops.pallas.ws_local import _ws_stripe
from cellseg_tpu.ops.pallas.ws_local import stripe_ws_converge as jax_local
from cellseg_tpu_torch.ops.kernels import (
    launch_counts,
    reset_launch_counts,
    ws_local,
    ws_sweeps,
)

torch.set_num_threads(1)
TERRAINS = ("continuous", "quantized", "integer")
SHAPES = [(200, 128), (136, 256), (256, 256)]


def _world(h, w, n_seeds, seed, terrain="continuous", density=0.85):
    """(e, mask, cost, hops, label) as numpy arrays: the watershed's
    initial state over random elevations."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(h, w)).astype(np.float32)
    if terrain == "quantized":
        img = np.round(img * 2) / 2
    elif terrain == "integer":
        img = rng.integers(0, 4, (h, w)).astype(np.float32)
    mask = rng.random((h, w)) < density
    markers = np.zeros((h, w), np.int32)
    markers[rng.integers(0, h, n_seeds), rng.integers(0, w, n_seeds)] = (
        np.arange(1, n_seeds + 1))
    markers *= mask
    e = np.where(mask, img, jws._BIG).astype(np.float32)
    seeded = markers > 0
    cost = np.where(seeded, e, jws._BIG).astype(np.float32)
    hops = np.where(seeded, 0, int(jws._INF_HOPS)).astype(np.int32)
    label = np.where(seeded, markers, 0).astype(np.int32)
    return e, mask, cost, hops, label


def _torch(arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


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


def test_shapes_have_several_stripes():
    for h, w in SHAPES:
        assert ws_local.ws_stripe(h, w) == _ws_stripe(h, w)
        assert h // ws_local.ws_stripe(h, w) >= 2


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("terrain", TERRAINS)
@pytest.mark.parametrize("start", ["initial", "mid_flood"])
def test_plain_matches_pallas_interpret(h, w, terrain, start):
    e, mask, cost, hops, label = _world(h, w, 40, seed=h + w,
                                        terrain=terrain)
    if start == "mid_flood":
        # a state after a global stripe pass and 3 sweeps: fronts that
        # crossed stripe edges, where the hops and label tie-breaks decide
        cost, hops, label = (a.numpy() for a in ws_sweeps.fused_ws_sweeps(
            *_torch((e, mask)), *ws_local.stripe_ws_converge(
                *_torch((e, mask, cost, hops, label))), k=3))
    want = jax_local(*(jnp.asarray(a) for a in (e, mask, cost, hops, label)),
                     interpret=True)
    got = ws_local.stripe_ws_converge(*_torch((e, mask, cost, hops, label)))
    _assert_planes_equal(got, want)


@pytest.mark.parametrize("cap", [0, 1, 3, 17])
def test_cap_matches_pallas_interpret(cap):
    """A stripe that has not converged stops after exactly `cap` sweeps."""
    e, mask, cost, hops, label = _world(200, 128, 6, seed=cap,
                                        terrain="integer")
    want = jax_local(*(jnp.asarray(a) for a in (e, mask, cost, hops, label)),
                     cap=cap, interpret=True)
    got = ws_local.stripe_ws_converge(*_torch((e, mask, cost, hops, label)),
                                      cap=cap)
    _assert_planes_equal(got, want)


def test_sweeps_are_each_stripes_own_count():
    """sweeps[i] is the sweeps stripe i ran: the last one changed nothing
    (below the cap), so one sweep fewer, on the stripe alone, gives the
    same stripe."""
    e, mask, cost, hops, label = _torch(_world(136, 256, 30, seed=2))
    sweeps = torch.zeros(17, dtype=torch.int32)
    got = ws_local.stripe_ws_converge(e, mask, cost, hops, label,
                                      sweeps=sweeps)
    assert 1 <= int(sweeps.min()) and int(sweeps.max()) < 256
    assert len(set(sweeps.tolist())) > 1
    for i in (0, 8, 16):
        rows = slice(8 * i, 8 * i + 8)
        n = int(sweeps[i])
        part = ws_sweeps.fused_ws_sweeps(
            *(t[rows].contiguous() for t in (e, mask, cost, hops, label)),
            k=max(n - 1, 1))
        for g, p in zip(got, part):
            assert torch.equal(g[rows], p)


def test_one_stripe_is_the_plain_fixed_point():
    """stripe = H: the whole plane relaxes to the plain route's fixed
    point, with its sweep count."""
    e, mask, cost, hops, label = _torch(_world(45, 70, 12, seed=4,
                                               terrain="quantized"))
    sweeps = torch.zeros(1, dtype=torch.int32)
    got = ws_local.stripe_ws_converge(e, mask, cost, hops, label, stripe=45,
                                      sweeps=sweeps)
    state, n = (cost, hops, label), 0
    while True:
        new = ws_sweeps.fused_ws_sweeps(e, mask, *state, k=1)
        n += 1
        if all(torch.equal(a, b) for a, b in zip(new, state)):
            break
        state = new
    _assert_planes_equal(got, [t.numpy() for t in state])
    assert int(sweeps[0]) == n


@pytest.mark.parametrize("bad", ["stripe", "no_stripe", "cap", "sweeps",
                                 "dtype"])
def test_stripe_ws_converge_rejects_bad_arguments(bad):
    e, mask, cost, hops, label = _torch(_world(24, 128, 4, seed=0))
    kw = {}
    if bad == "stripe":
        kw["stripe"] = 7
    elif bad == "no_stripe":
        e, mask, cost, hops, label = (t[:3] for t in
                                      (e, mask, cost, hops, label))
    elif bad == "cap":
        kw["cap"] = -1
    elif bad == "sweeps":
        kw["sweeps"] = torch.zeros(2, dtype=torch.int64)
    else:
        cost = cost.to(torch.float64)
    with pytest.raises(ValueError):
        ws_local.stripe_ws_converge(e, mask, cost, hops, label, **kw)


def test_cpu_tensors_never_count_as_launches():
    reset_launch_counts()
    ws_local.stripe_ws_converge(*_torch(_world(16, 128, 3, seed=1)))
    assert launch_counts()["stripe_ws_converge"] == 0


# (h, w, stripe) -> the kernel variant ws_cluster_size picks: blocks of
# the cluster per stripe, 0 for the global-memory variant. Planes narrower
# than 16 columns leave some blocks of the cluster without a column.
# 12360 columns in stripes of 8 rows are the widest whose slab of 16
# blocks fits in 227 KB (773 columns, 232,436 bytes); 16 columns more do
# not.
PLANS = {(2176, 2176, 16): 16, (1000, 1537, 40): 16, (4096, 200, 128): 16,
         (3, 5, 3): 16, (1, 1, 1): 16, (4, 20011, 2): 16, (20011, 3, 1): 16,
         (64, 200, 16): 16, (64, 400, 16): 16, (64, 800, 16): 16,
         (16, 12360, 8): 16, (16, 12376, 8): 0}


@pytest.mark.parametrize("h,w,stripe", list(PLANS))
def test_cluster_size_rule(h, w, stripe):
    """The variant is a function of the shape: 16 blocks where the slab of
    one of them fits in a block's shared memory, else 0 (global
    memory)."""
    c = ws_local.ws_cluster_size(h, w, stripe)
    assert c == PLANS[h, w, stripe]
    fits = ws_local.cluster_smem_bytes(
        stripe, -(-w // ws_local.MAX_CLUSTER)) <= ws_local.SMEM_BYTES
    assert c == (ws_local.MAX_CLUSTER if fits else 0)


def test_cluster_size_rule_covers_every_variant():
    assert set(PLANS.values()) == {0, ws_local.MAX_CLUSTER}
    # the route's own stripes at the JAX package's stripe height
    assert ws_local.ws_cluster_size(2176, 2176, ws_local.ws_stripe(
        2176, 2176)) == 16
    assert ws_local.cluster_smem_bytes(16, 136) == 75480


@pytest.mark.cuda
def test_ws_local_kernel_matches_plain_on_card(cuda_device):
    """Every variant and cluster size the shape rule picks (PLANS),
    among them the stripe just inside and the one just outside the
    largest cluster: all three planes and the sweeps per stripe equal."""
    for h, w, stripe in [(2176, 2176, None), *PLANS]:
        for terrain in TERRAINS:
            for density in (0.5, 0.85):
                planes = _world(h, w, max(2, h * w // 4000), seed=h + w,
                                terrain=terrain, density=density)
                args = [torch.from_numpy(a).to(cuda_device) for a in planes]
                for cap in (256, 5):
                    n = h // (stripe or ws_local.ws_stripe(h, w))
                    s_got = torch.zeros(n, dtype=torch.int32,
                                        device=cuda_device)
                    s_want = torch.zeros_like(s_got)
                    got = ws_local.stripe_ws_converge(
                        *args, cap=cap, stripe=stripe, sweeps=s_got)
                    want = ws_local.stripe_ws_converge_plain(
                        *args, cap=cap, stripe=stripe, sweeps=s_want)
                    for g, wnt in zip(got, want):
                        assert torch.equal(g, wnt), (h, w, terrain, cap)
                    assert torch.equal(s_got, s_want), (h, w, terrain, cap)
