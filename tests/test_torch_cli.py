"""The port's predict CLI (reference -i/-o ABI) on synthetic images.

Images in the style of scripts/make_synthetic_dataset.py are written to
tmp_path; the port's CLI (device cpu) must write `{stem}_label.tiff` maps
equal to its Predictor's labels and to the JAX CLI's output.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401,E402  (conftest pins JAX to the CPU)

from cellseg_tpu.cli.predict import main as jax_predict_main
from cellseg_tpu.metrics.f1 import score_pair
from cellseg_tpu_torch.checkpoint import load_model_for_inference
from cellseg_tpu_torch.cli.predict import main as predict_main
from cellseg_tpu_torch.infer.predictor import Predictor
from cellseg_tpu_torch.io import imread, imwrite

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "bench_unet_3class.ckpt")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from make_synthetic_dataset import make_image  # noqa: E402


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(7)
    rgb, _ = make_image(rng, 192, n_cells=25)
    gray, _ = make_image(rng, 160, n_cells=20, invert=True)
    imwrite(str(d / "cell_00000.png"), rgb)
    imwrite(str(d / "cell_00001.tif"), gray[:, :, 0])
    return d


def test_cli_writes_labels_equal_to_predictor(inputs, tmp_path):
    out = tmp_path / "out"
    predict_main(["-i", str(inputs), "-o", str(out), "--model_path", CKPT,
                  "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["cell_00000_label.tiff",
                                       "cell_00001_label.tiff"]
    model, _ = load_model_for_inference(CKPT, device="cpu")
    pred = Predictor(model, device="cpu")
    for stem, shape in (("cell_00000", (192, 192)),
                        ("cell_00001", (160, 160))):
        labels = imread(str(out / f"{stem}_label.tiff"))
        assert labels.shape == shape and labels.dtype == np.uint16
        src = [f for f in os.listdir(inputs) if f.startswith(stem)][0]
        want = pred.predict(imread(str(inputs / src)))
        np.testing.assert_array_equal(labels.astype(np.int32), want)
        assert labels.max() > 3


def test_cli_matches_jax_cli(inputs, tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    predict_main(["-i", str(inputs), "-o", str(ours), "--model_path", CKPT,
                  "--device", "cpu", "--show_overlay"])
    jax_predict_main(["-i", str(inputs), "-o", str(theirs),
                      "--model_path", CKPT])
    for name in ("cell_00000_label.tiff", "cell_00001_label.tiff"):
        a = imread(str(ours / name)).astype(np.int32)
        b = imread(str(theirs / name)).astype(np.int32)
        assert score_pair(b, a)["f1"] >= 0.999
    assert (ours / "overlay_cell_00000.png").exists()


def test_cli_model_name_override(inputs, tmp_path):
    """--model_name rebuilds the architecture by name and restores the
    checkpoint file inside --model_path."""
    out = tmp_path / "out"
    predict_main(["-i", str(inputs), "-o", str(out),
                  "--model_path", os.path.dirname(CKPT),
                  "--checkpoint", os.path.basename(CKPT),
                  "--model_name", "unet", "--device", "cpu"])
    assert (out / "cell_00000_label.tiff").exists()


@pytest.mark.parametrize("flags", [["--decode", "boundary_watershed"],
                                   ["--tta"]], ids=["boundary_watershed",
                                                    "tta"])
def test_cli_decode_options_match_predictor_and_jax_cli(inputs, tmp_path,
                                                         flags):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    predict_main(["-i", str(inputs), "-o", str(ours), "--model_path", CKPT,
                  "--device", "cpu", *flags])
    jax_predict_main(["-i", str(inputs), "-o", str(theirs),
                      "--model_path", CKPT, *flags])
    model, _ = load_model_for_inference(CKPT, device="cpu")
    pred = Predictor(model, device="cpu",
                     decode="boundary_watershed" if "--decode" in flags
                     else "cc", tta="--tta" in flags)
    for stem in ("cell_00000", "cell_00001"):
        a = imread(str(ours / f"{stem}_label.tiff")).astype(np.int32)
        b = imread(str(theirs / f"{stem}_label.tiff")).astype(np.int32)
        src = [f for f in os.listdir(inputs) if f.startswith(stem)][0]
        np.testing.assert_array_equal(a, pred.predict(imread(
            str(inputs / src))))
        assert score_pair(b, a)["f1"] >= 0.999
        assert a.max() > 3


def test_cli_stripe_route_matches_predictor(inputs, tmp_path):
    out = tmp_path / "out"
    predict_main(["-i", str(inputs), "-o", str(out), "--model_path", CKPT,
                  "--device", "cpu", "--decode", "boundary_watershed",
                  "--ws_route", "stripe"])
    model, _ = load_model_for_inference(CKPT, device="cpu")
    pred = Predictor(model, device="cpu", decode="boundary_watershed",
                     ws_route="stripe")
    for stem in ("cell_00000", "cell_00001"):
        a = imread(str(out / f"{stem}_label.tiff")).astype(np.int32)
        src = [f for f in os.listdir(inputs) if f.startswith(stem)][0]
        np.testing.assert_array_equal(a, pred.predict(imread(
            str(inputs / src))))
        assert a.max() > 3


def test_cli_cc_stripe_route_matches_predictor_and_jax_cli(inputs,
                                                           tmp_path):
    """--cc_route stripe: the labels of the global route, the port's
    Predictor on the stripe route, and the JAX CLI's."""
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    predict_main(["-i", str(inputs), "-o", str(ours), "--model_path", CKPT,
                  "--device", "cpu", "--cc_route", "stripe"])
    jax_predict_main(["-i", str(inputs), "-o", str(theirs),
                      "--model_path", CKPT])
    model, _ = load_model_for_inference(CKPT, device="cpu")
    stripe = Predictor(model, device="cpu", cc_route="stripe")
    glob = Predictor(model, device="cpu")
    for stem in ("cell_00000", "cell_00001"):
        a = imread(str(ours / f"{stem}_label.tiff")).astype(np.int32)
        b = imread(str(theirs / f"{stem}_label.tiff")).astype(np.int32)
        src = [f for f in os.listdir(inputs) if f.startswith(stem)][0]
        img = imread(str(inputs / src))
        np.testing.assert_array_equal(a, stripe.predict(img))
        np.testing.assert_array_equal(a, glob.predict(img))
        assert score_pair(b, a)["f1"] >= 0.999
        assert a.max() > 3


def test_cli_unknown_cc_route_exits(inputs, tmp_path):
    with pytest.raises(SystemExit):
        predict_main(["-i", str(inputs), "-o", str(tmp_path / "o"),
                      "--model_path", CKPT, "--device", "cpu",
                      "--cc_route", "local"])


def test_cli_model_name_passes_input_size(inputs, tmp_path, monkeypatch):
    """--model_name builds the model with --input_size, as the JAX CLI
    does (cli/predict.py:87-88)."""
    from cellseg_tpu_torch.cli import predict as cli

    seen = []
    real = cli.build_model

    def spy(*args, **kw):
        seen.append(kw.get("input_size"))
        return real(*args, **kw)

    monkeypatch.setattr(cli, "build_model", spy)
    predict_main(["-i", str(inputs), "-o", str(tmp_path / "o"),
                  "--model_path", os.path.dirname(CKPT),
                  "--checkpoint", os.path.basename(CKPT),
                  "--model_name", "unet", "--input_size", "192",
                  "--device", "cpu"])
    assert seen == [192]
    assert (tmp_path / "o" / "cell_00000_label.tiff").exists()


def test_cli_unported_model_raises(inputs, tmp_path):
    with pytest.raises(NotImplementedError, match="A9"):
        predict_main(["-i", str(inputs), "-o", str(tmp_path / "o"),
                      "--model_path", os.path.dirname(CKPT),
                      "--checkpoint", os.path.basename(CKPT),
                      "--model_name", "dunet", "--device", "cpu"])
