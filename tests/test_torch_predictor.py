"""Port parity: normalization, sliding window, checkpoint reader and the
whole 3-class slice against the JAX package, on the CPU.

- normalization: bit-identical uint8 (device and host paths);
- sliding window: a pointwise model, so the blend arithmetic alone is
  compared (uniform and clamped grids, constant and gaussian blends,
  duplicate pad tiles);
- the msgpack reader: the same arrays as flax.serialization;
- the slice: the trained checkpoint on synthetic images; probabilities
  within 1e-4; CC labels identical except where |p - 0.5| < 1e-4, instance
  F1 >= 0.999; boundary-watershed labels (with and without the dihedral
  TTA) at instance F1 >= 0.999 and pixel agreement >= 0.999, since a 1e-5
  move of P(interior) can move a ridge pixel (the decode itself is held
  bit for bit in test_torch_decode.py); the boundary watershed's stripe
  route (the JAX package's TPU route) against the decode of the same
  probabilities; the CC stripe route (`cc_route="stripe"`) against the
  JAX predictor, as the global route is.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: E402  (conftest pins JAX to the CPU)
import jax.numpy as jnp
from flax import serialization

from cellseg_tpu.infer import sliding_window as jsw
from cellseg_tpu.infer.predictor import Predictor as JaxPredictor
from cellseg_tpu.infer.predictor import _bucket_up as jax_bucket_up
from cellseg_tpu.metrics.f1 import score_pair
from cellseg_tpu.pipeline import normalize as jnorm
from cellseg_tpu.train.checkpoint import load_model_for_inference as jload
from cellseg_tpu_torch import checkpoint as tckpt
from cellseg_tpu_torch.device import resolve_device
from cellseg_tpu_torch.infer import sliding_window as tsw
from cellseg_tpu_torch.infer.predictor import Predictor, _bucket_up
from cellseg_tpu_torch.pipeline import normalize as tnorm

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "bench_unet_3class.ckpt")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from make_synthetic_dataset import make_image  # noqa: E402


def _images():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    zero_ch = rgb.copy()
    zero_ch[..., 1] = 0
    const_ch = rgb.copy()
    const_ch[..., 2] = 77
    sparse = np.where(rng.random((40, 40, 1)) < 0.05, rgb[:40, :40, :1], 0)
    u16 = (rng.random((30, 50, 2)) * 4000).astype(np.uint16)
    return {"rgb": rgb, "gray": rgb[..., :1], "two": rgb[..., :2],
            "zero_channel": zero_ch, "constant_channel": const_ch,
            "sparse": sparse, "uint16": u16}


@pytest.mark.parametrize("name", list(_images()))
def test_normalize_device_matches_jax(name):
    img = _images()[name]
    want = np.asarray(jnorm.normalize_image_jax(jnp.asarray(img)))
    got = tnorm.normalize_image_torch(torch.from_numpy(img))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["rgb", "gray", "zero_channel", "sparse"])
def test_normalize_host_matches_jax(name):
    img = _images()[name]
    np.testing.assert_array_equal(tnorm.normalize_image(img),
                                  jnorm.normalize_image(img))


def test_tiling_helpers_match_jax():
    for size in (1, 63, 64, 65, 200, 256, 448, 500, 2048):
        for roi, overlap in ((64, 0.25), (256, 0.25), (256, 0.5)):
            np.testing.assert_array_equal(
                tsw.tile_origins(size, roi, overlap),
                jsw.tile_origins(size, roi, overlap))
            stride = int(roi * (1 - overlap))
            for bucket in (1, 64, 256):
                assert (_bucket_up(size, bucket, roi, stride)
                        == jax_bucket_up(size, bucket, roi, stride))
    for n in (1, 5, 8, 9, 100, 128, 129, 144, 300):
        assert tsw.balanced_sw_batch(n) == jsw.balanced_sw_batch(n)


@pytest.mark.parametrize("hw", [(208, 208), (200, 136), (50, 90)])
@pytest.mark.parametrize("mode", ["constant", "gaussian"])
def test_sliding_window_matches_jax_pointwise(hw, mode):
    """208 is a uniform grid (parity blend), 200x136 a clamped one
    (accumulate and divide), 50x90 is smaller than the ROI. sw_batch 4
    pads the tile count with duplicates."""
    x = np.random.default_rng(1).random((*hw, 3)).astype(np.float32)
    scale = np.array([2.0, -1.0], np.float32)

    def jax_fn(params, tiles):
        return tiles[..., :2] * scale + 1.0

    def torch_fn(tiles):
        return tiles[..., :2] * torch.from_numpy(scale) + 1.0

    kw = dict(roi=64, sw_batch=4, overlap=0.25, out_channels=2, mode=mode)
    want = np.asarray(jsw.sliding_window_inference(
        jax_fn, None, jnp.asarray(x), **kw))
    got = tsw.sliding_window_inference(torch_fn, torch.from_numpy(x), **kw)
    assert got.shape == want.shape == (*hw, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _assert_same_tree(a, b, path="") -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


def test_msgpack_reader_matches_flax_on_checkpoint():
    with open(CKPT, "rb") as f:
        data = f.read()
    _assert_same_tree(serialization.msgpack_restore(data),
                      tckpt.msgpack_restore(data))


def test_msgpack_reader_matches_flax_on_all_types():
    rng = np.random.default_rng(2)
    tree = {
        "f32": rng.random((3, 4)).astype(np.float32),
        "f64": rng.random(5),
        "i8": np.arange(-5, 5, dtype=np.int8),
        "u16": np.arange(7, dtype=np.uint16),
        "i64": np.array([-(2**40), 2**40]),
        "bool": np.array([True, False]),
        "big": rng.random(70000).astype(np.float32),  # 32-bit length ext
        "scalar": np.float32(1.5),
        "ints": {"a": 0, "b": 127, "c": 128, "d": -1, "e": -33, "f": 2**17,
                 "g": -(2**17), "h": 2**40, "i": -(2**40)},
        "floats": {"x": 0.1, "y": -1e300},
        "strs": {"short": "x", "long": "y" * 300},
        "flags": {"t": True, "f": False, "n": None},
        "nested": {str(i): {"k": np.full((i + 1,), i, np.int32)}
                   for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    _assert_same_tree(serialization.msgpack_restore(data),
                      tckpt.msgpack_restore(data))


@pytest.fixture(scope="module")
def models():
    jm, jp, _ = jload(CKPT)
    tm, _ = tckpt.load_model_for_inference(CKPT, device="cpu")
    return jm, jp, tm


def _jax_run(jm, jp, img, **opts):
    """The JAX predictor's labels and forward output (the interior
    probability, or interior and boundary for the boundary watershed)."""
    pred = JaxPredictor(lambda p, t: jm.apply(p, t), jp, **opts)
    from cellseg_tpu.io.images import to_hwc_raw

    raw = to_hwc_raw(img)
    h, w, c = raw.shape
    stride = int(pred.roi * (1 - pred.overlap))
    ph = jax_bucket_up(h, pred.bucket, pred.roi, stride)
    pw = jax_bucket_up(w, pred.bucket, pred.roi, stride)
    padded = np.zeros((ph, pw, c), raw.dtype)
    padded[:h, :w] = raw
    labels, interior = pred._program(ph, pw, c)(
        jp, jnp.asarray(padded), jnp.int32(h), jnp.int32(w))
    return (np.asarray(labels)[:h, :w].astype(np.int32),
            np.asarray(interior)[:h, :w])


def _assert_slice_parity(jm, jp, tm, img, port_opts=None, **opts):
    """port_opts: Predictor options of the port alone."""
    want, p_jax = _jax_run(jm, jp, img, **opts)
    pred = Predictor(tm, device="cpu", **opts, **(port_opts or {}))
    labels, probs, h, w = pred.predict_device(img)
    got = labels.numpy()[:h, :w].astype(np.int32)
    p_port = probs.numpy()[:h, :w]
    assert got.shape == want.shape == img.shape[:2]
    assert p_port.shape == p_jax.shape
    assert np.abs(p_port - p_jax).max() < 1e-4
    if opts.get("decode") == "boundary_watershed":
        assert float((got == want).mean()) >= 0.999
    elif (ambiguous := np.abs(p_jax - 0.5) < 1e-4).any():
        # a flipped ambiguous pixel may renumber later instances, so only
        # the foreground is compared pixel by pixel
        assert not (((got > 0) != (want > 0)) & ~ambiguous).any()
    else:
        np.testing.assert_array_equal(got, want)
    assert score_pair(want, got)["f1"] >= 0.999
    np.testing.assert_array_equal(pred.predict(img), got)
    return got


def test_slice_matches_jax_rgb_384x512(models):
    jm, jp, tm = models
    img, _ = make_image(np.random.default_rng(3), 512)
    got = _assert_slice_parity(jm, jp, tm, img[:384])
    assert got.max() > 10


def test_slice_matches_jax_grayscale(models):
    """A 2-D image: one channel goes up, the device repeats it to 3."""
    jm, jp, tm = models
    img, _ = make_image(np.random.default_rng(4), 256, n_cells=30,
                        invert=True)
    _assert_slice_parity(jm, jp, tm, img[:200, :240, 0])


def test_predict_many_equals_predict(models):
    _, _, tm = models
    rng = np.random.default_rng(5)
    imgs = [make_image(rng, 256, n_cells=20)[0][:, :, 0] for _ in range(2)]
    pred = Predictor(tm, device="cpu")
    many = list(pred.predict_many(iter(imgs)))
    assert len(many) == 2
    for img, labels in zip(imgs, many):
        np.testing.assert_array_equal(labels, pred.predict(img))


@pytest.mark.parametrize("opts", [{"decode": "boundary_watershed"},
                                  {"tta": True},
                                  {"decode": "boundary_watershed",
                                   "tta": True}],
                         ids=["boundary_watershed", "tta",
                              "boundary_watershed_tta"])
def test_predictor_options_match_jax(models, opts):
    """A 200x240 crop: one 256x256 tile per view, eight views with tta."""
    jm, jp, tm = models
    img, _ = make_image(np.random.default_rng(6), 256, n_cells=40)
    got = _assert_slice_parity(jm, jp, tm, img[:200, :240], **opts)
    assert got.max() > 5


def test_stripe_route_predictor_is_its_decode(models):
    """ws_route="stripe": the same probabilities as the plain route, and
    labels that are the stripe-route decode of them."""
    from cellseg_tpu_torch.decode.threeclass import decode_boundary_watershed

    _, _, tm = models
    img, _ = make_image(np.random.default_rng(6), 256, n_cells=40)
    img = img[:200, :240]
    pred = Predictor(tm, device="cpu", decode="boundary_watershed",
                     ws_route="stripe")
    labels, probs, h, w = pred.predict_device(img)
    plain = Predictor(tm, device="cpu", decode="boundary_watershed")
    _, probs_plain, _, _ = plain.predict_device(img)
    assert torch.equal(probs, probs_plain)
    p = probs.clone()
    p[h:] = 0.0
    p[:, w:] = 0.0
    want = decode_boundary_watershed(p[..., 0].contiguous(),
                                     p[..., 1].contiguous(), route="stripe")
    assert torch.equal(labels, want.to(torch.uint16))
    assert int(want.max()) > 5


@pytest.mark.parametrize("opts", [{}, {"decode": "boundary_watershed"}],
                         ids=["cc", "boundary_watershed"])
def test_cc_stripe_route_predictor_matches_jax(models, opts):
    """cc_route="stripe" on a 256x256 canvas (two stripes of 128 rows): the
    JAX predictor's labels, and the same labels as the global route."""
    from cellseg_tpu_torch.ops.cc import stripe_route_supported

    jm, jp, tm = models
    img, _ = make_image(np.random.default_rng(6), 256, n_cells=40)
    img = img[:200, :240]
    assert stripe_route_supported(256, 256)
    got = _assert_slice_parity(jm, jp, tm, img,
                               port_opts={"cc_route": "stripe"}, **opts)
    np.testing.assert_array_equal(
        got, Predictor(tm, device="cpu", **opts).predict(img))
    assert got.max() > 5


def test_unknown_cc_route_raises():
    with pytest.raises(ValueError, match="route"):
        Predictor(lambda t: t, device="cpu", cc_route="local")
    with pytest.raises(ValueError, match="route"):
        Predictor(lambda t: t, device="cpu", cc_route="plain")


def test_unknown_decode_raises():
    with pytest.raises(ValueError, match="decode"):
        Predictor(lambda t: t, device="cpu", decode="flow")
    with pytest.raises(ValueError, match="route"):
        Predictor(lambda t: t, device="cpu", decode="boundary_watershed",
                  ws_route="local")


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(lambda t: t)
    assert resolve_device("cpu") == torch.device("cpu")
