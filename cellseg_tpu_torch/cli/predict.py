"""CLI: whole-image instance segmentation, the challenge submission ABI.

`python -m cellseg_tpu_torch.cli.predict -i <input dir> -o <output dir>`
reads every image in the input directory, runs normalization, the
sliding-window UNet and the decode (CC, or --decode boundary_watershed
with --ws_route plain or stripe; --tta averages the 8 dihedral views) on
the card, and writes `{stem}_label.tiff` instance maps. Flags follow
cellseg_tpu.cli.predict, plus --device (default cuda; cpu runs the plain
PyTorch path), --ws_route and --cc_route (global or stripe: the CC
propagation's route, same labels).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..checkpoint import convert_params, load_checkpoint, load_model_for_inference
from ..infer.predictor import Predictor
from ..io import imread, imwrite, imwrite_instance_tiff, list_images
from ..models import build_model

join = os.path.join


def main(argv=None):
    parser = argparse.ArgumentParser(
        "GPU microscopy image segmentation", add_help=False)
    parser.add_argument("-i", "--input_path", default="./inputs", type=str,
                        help="input image directory")
    parser.add_argument("-o", "--output_path", default="./outputs", type=str,
                        help="output path")
    parser.add_argument("--model_path", default="./work_dir/unet_3class",
                        help="checkpoint directory (with config.json "
                             "sidecar) or a .ckpt file with a sibling .json")
    parser.add_argument("--checkpoint", default="best_model.ckpt",
                        help="checkpoint file within model_path")
    parser.add_argument("--show_overlay", default=False,
                        action="store_true", help="save segmentation overlay")
    parser.add_argument("--model_name", default=None,
                        help="override model architecture (default: sidecar)")
    parser.add_argument("--num_class", default=3, type=int)
    parser.add_argument("--input_size", default=256, type=int,
                        help="sliding-window ROI size")
    parser.add_argument("--sw_batch_size", default="auto",
                        help="tiles per forward step; 'auto' sizes it to "
                             "the slide (results are identical for any "
                             "value)")
    parser.add_argument("--bucket", default=256, type=int,
                        help="shape bucket (1 = pad only to the ROI, exact "
                             "reference tiling)")
    parser.add_argument("--blend", default="constant",
                        choices=["constant", "gaussian"],
                        help="sliding-window blending mode")
    parser.add_argument("--decode", default="cc",
                        choices=["cc", "boundary_watershed"],
                        help="cc = reference parity (CC on interior); "
                             "boundary_watershed = seeded split of "
                             "touching cells")
    parser.add_argument("--ws_route", default="plain",
                        choices=["plain", "stripe"],
                        help="boundary watershed's route: plain = the JAX "
                             "package's labels off the TPU; stripe = its "
                             "block-local route on the TPU")
    parser.add_argument("--cc_route", default="global",
                        choices=["global", "stripe"],
                        help="CC propagation's route: global = scans and "
                             "sweeps over the whole plane; stripe = "
                             "block-local convergence per row stripe (the "
                             "JAX package's CELLSEG_LOCALCC route); the "
                             "labels are the same")
    parser.add_argument("--overlap", default=0.25, type=float,
                        help="sliding-window tile overlap fraction")
    parser.add_argument("--tta", action="store_true",
                        help="dihedral test-time augmentation (8x forward "
                             "cost)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("-h", "--help", action="help")
    args = parser.parse_args(argv)

    if args.model_name:
        model = build_model(args.model_name, num_class=args.num_class,
                            input_size=args.input_size)
        payload = load_checkpoint(join(args.model_path, args.checkpoint))
        model.load_state_dict(convert_params(payload["params"]))
    else:
        model, _ = load_model_for_inference(args.model_path, args.checkpoint,
                                            device=args.device)
    predictor = Predictor(
        model, roi=args.input_size,
        sw_batch=(args.sw_batch_size if args.sw_batch_size == "auto"
                  else int(args.sw_batch_size)),
        num_class=args.num_class, bucket=args.bucket, mode=args.blend,
        overlap=args.overlap, decode=args.decode, tta=args.tta,
        ws_route=args.ws_route, cc_route=args.cc_route, device=args.device)

    os.makedirs(args.output_path, exist_ok=True)
    for img_name in list_images(args.input_path):
        t0 = time.time()
        img = np.asarray(imread(join(args.input_path, img_name)))
        labels = predictor.predict(img)
        stem = img_name.split(".")[0]
        imwrite_instance_tiff(join(args.output_path, stem + "_label.tiff"),
                              labels)
        print(f"Prediction finished: {img_name}; img size = {img.shape}; "
              f"costing: {time.time() - t0:.2f}s")

        if args.show_overlay:
            from ..ops.host_morphology import (
                binary_dilation_disk,
                find_boundaries_inner,
            )

            boundary = binary_dilation_disk(find_boundaries_inner(labels), 2)
            overlay = img.copy()
            if overlay.ndim == 2:
                overlay = np.repeat(overlay[..., None], 3, axis=-1)
            overlay[boundary] = 255
            imwrite(join(args.output_path, "overlay_" + stem + ".png"),
                    overlay.astype(np.uint8))


if __name__ == "__main__":
    main()
