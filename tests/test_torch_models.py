"""Port parity: the UNet and its layers against the flax models.

Each layer whose padding, kernel layout or statistics differ between
flax and torch is pinned on its own (stride-2 SAME conv, SAME transposed
conv, GroupNorm, PReLU), then a narrow UNet (channels 4-8-16) and the
trained checkpoint run end to end with weights carried by convert_params.
float32 on the CPU; tolerance 1e-4 absolute (1e-5 for single convolutions).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax  # noqa: E402  (conftest pins JAX to the CPU)
import jax.numpy as jnp
from flax import linen as nn

from cellseg_tpu.models import blocks as jblocks
from cellseg_tpu.models import build_model as jax_build_model
from cellseg_tpu_torch.checkpoint import convert_params
from cellseg_tpu_torch.models import blocks, build_model

torch.set_num_threads(1)
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "bench_unet_3class.ckpt")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(params, seed):
    """Random offsets on every leaf, so biases, norm scales and PReLU
    slopes are not at their initial values."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
            np.float32), params)


def _to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("hw", [(16, 16), (15, 17), (8, 9)])
@pytest.mark.parametrize("kernel", [3, 1])
def test_stride2_same_conv_matches_flax(hw, kernel):
    rng = np.random.default_rng(kernel)
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    layer = nn.Conv(7, (kernel, kernel), strides=(2, 2), padding="SAME")
    params = _perturbed(layer.init(jax.random.PRNGKey(0), x), 1)
    want = np.asarray(layer.apply(params, x))
    conv = blocks.SameConv2d(5, 7, kernel, stride=2)
    p = params["params"]
    conv.weight.data = torch.from_numpy(
        p["kernel"].transpose(3, 2, 0, 1).copy())
    conv.bias.data = torch.from_numpy(p["bias"].copy())
    got = _to_nhwc(conv(_to_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_symmetric_padding_is_wrong_on_even_sizes():
    """The trap SameConv2d exists for: torch's padding=1 shifts the
    stride-2 sampling grid by one pixel on even inputs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    layer = nn.Conv(4, (3, 3), strides=(2, 2), padding="SAME")
    params = layer.init(jax.random.PRNGKey(0), x)
    want = np.asarray(layer.apply(params, x))
    w = torch.from_numpy(
        np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    naive = _to_nhwc(F.conv2d(_to_nchw(x), w, stride=2, padding=1))
    assert np.abs(naive - want).max() > 1e-2


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
@pytest.mark.parametrize("stride", [2, 1])
def test_same_conv_transpose_matches_flax(hw, stride):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, *hw, 6)).astype(np.float32)
    layer = nn.ConvTranspose(4, (3, 3), strides=(stride, stride),
                             padding="SAME")
    params = _perturbed(layer.init(jax.random.PRNGKey(0), x), 2)
    want = np.asarray(layer.apply(params, x))
    up = blocks.SameConvTranspose2d(6, 4, 3, stride)
    p = params["params"]
    up.weight.data = torch.from_numpy(
        p["kernel"][::-1, ::-1].transpose(2, 3, 0, 1).copy())
    up.bias.data = torch.from_numpy(p["bias"].copy())
    got = _to_nhwc(up(_to_nchw(x)))
    assert got.shape == want.shape == (2, hw[0] * stride, hw[1] * stride, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("feats", [6, 16])
def test_instance_norm_matches_flax(feats):
    rng = np.random.default_rng(feats)
    # an offset mean, where the variance formula matters
    x = (3.0 + rng.standard_normal((2, 12, 10, feats))).astype(np.float32)
    layer = jblocks.make_norm("instance")(feats)
    params = _perturbed(layer.init(jax.random.PRNGKey(0), x), 3)
    want = np.asarray(layer.apply(params, x))
    norm = blocks.make_norm("instance")(feats)
    assert norm.eps == 1e-6
    norm.weight.data = torch.from_numpy(params["params"]["scale"].copy())
    norm.bias.data = torch.from_numpy(params["params"]["bias"].copy())
    got = _to_nhwc(norm(_to_nchw(x)))
    # E[x^2] - E[x]^2 cancels: the float32 rounding of the two means (summed
    # in another order than XLA's) is scaled by mean^2 / var, about 10 here
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("alpha", [0.25, -0.3])
def test_prelu_matches_flax(alpha):
    x = np.linspace(-4, 4, 101, dtype=np.float32).reshape(1, 101, 1, 1)
    layer = jblocks.Activation(kind="prelu")
    want = np.asarray(layer.apply({"params": {"alpha": np.float32(alpha)}},
                                  x))
    act = blocks.Activation("prelu")
    act.alpha.data = torch.tensor(alpha)
    got = act(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("factory,kind", [(blocks.make_norm, "group"),
                                          (blocks.make_norm, "layer"),
                                          (blocks.Activation, "relu"),
                                          (blocks.Activation, "gelu")])
def test_unported_norms_and_activations_name_their_item(factory, kind):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        factory(kind)


@pytest.mark.parametrize("stride,in_ch", [(2, 3), (1, 8)])
def test_residual_unit_matches_flax(stride, in_ch):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 16, 14, in_ch)).astype(np.float32)
    layer = jblocks.ResidualUnit(features=8, strides=stride, subunits=2)
    params = _perturbed(_np_tree(layer.init(jax.random.PRNGKey(0), x)), 4)
    want = np.asarray(layer.apply(params, x))
    unit = blocks.ResidualUnit(in_ch, 8, stride, subunits=2)
    state = convert_params({"ResidualUnit_0": params["params"]})
    unit.load_state_dict({k.removeprefix("res_units.0."): v
                          for k, v in state.items()})
    got = _to_nhwc(unit(_to_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 96, 64, 3),
                                   (1, 128, 128, 3)])
def test_narrow_unet_matches_flax(shape):
    channels = (4, 8, 16)
    jm = jax_build_model("unet", channels=channels)
    params = _perturbed(_np_tree(
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))), 5)
    model = build_model("unet", channels=channels)
    model.load_state_dict(convert_params(params))
    x = np.random.default_rng(6).random(shape).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*shape[:3], 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_trained_unet_matches_flax(monkeypatch):
    """One 256x256 tile through the trained weights. Also pins why the
    port computes GroupNorm with flax's formula: torch's own GroupNorm
    puts the same logits outside the tolerance."""
    from cellseg_tpu.train.checkpoint import load_model_for_inference as jload
    from cellseg_tpu_torch.checkpoint import load_model_for_inference

    jm, jp, _ = jload(CKPT)
    model, cfg = load_model_for_inference(CKPT, device="cpu")
    assert cfg["model_name"] == "unet" and not model.training
    x = np.random.default_rng(7).random((1, 256, 256, 3)).astype(np.float32)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    monkeypatch.setattr(blocks.FlaxGroupNorm, "forward",
                        torch.nn.GroupNorm.forward)
    with torch.no_grad():
        stock = model(torch.from_numpy(x)).numpy()
    assert np.abs(stock - want).max() > 1e-4


@pytest.mark.parametrize("name", ["dunet", "flownet", "unetr", "swinunetr"])
def test_unported_models_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(name)


def test_build_model_leading_parameters_match_jax():
    """name, num_class and input_size, in the JAX factory's order and with
    its defaults, so positional calls mean the same in both."""
    import inspect

    want = list(inspect.signature(jax_build_model).parameters.values())[:3]
    got = list(inspect.signature(build_model).parameters.values())[:3]
    assert [(p.name, p.default, p.kind) for p in got] == [
        (p.name, p.default, p.kind) for p in want]
    assert [p.name for p in got] == ["name", "num_class", "input_size"]
    model = build_model("unet", 2, 128, channels=(4, 8))
    assert model.encoder is not None
    assert build_model("unet", 2, 128, in_channels=1,
                       channels=(4, 8)) is not None


def test_unknown_model_raises():
    with pytest.raises(ValueError):
        build_model("resnet")
