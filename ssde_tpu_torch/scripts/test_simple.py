#!/usr/bin/env python
"""Single-image / folder depth inference on the GPU (counterpart of
``scripts/test_simple.py``, reference test_simple.py), offline only.

Reads the feed height and width embedded in ``encoder.pth`` (reference
test_simple.py:76-77), or in ``encoder.ckpt``'s ``extra`` in a folder of the
JAX package's ``.ckpt`` files, and writes, next to each input image,
``<name>_disp.npy`` (the scaled disparity at depths 0.1 to 100, (1, H, W, 1)
as the JAX script writes it) and ``<name>_disp.jpeg`` (the magma colormap of
the disparity resized bilinearly to the input's size; skipped, with a
message, where matplotlib is not installed).

Run: python -m ssde_tpu_torch.scripts.test_simple --image_path <file or folder>
       --model_path <folder of encoder.pth, depth.pth, or of their .ckpt>
       [--ext jpg] [--no_cuda]

The model-zoo download of ``--model_name`` is not ported: the folder
``models/<name>`` must exist. float32 with TF32 off, on the card unless
--no_cuda asks for the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import List, Tuple

import numpy as np
import torch
from PIL import Image

from ..checkpoint import load_eval_folder, read_meta
from ..config import Options
from ..io import colormap_disparity
from ..ops.geometry import disp_to_depth
from ..ops.image import resize_bilinear
from ..train.steps import build_mono_models, mono_infer
from .evaluate_depth import eval_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Simple testing function for depth prediction (GPU).")
    parser.add_argument("--image_path", type=str, required=True,
                        help="path to a test image or folder of images")
    parser.add_argument("--model_path", type=str, default=None,
                        help="path to a checkpoint folder (reference .pth or JAX .ckpt)")
    parser.add_argument("--model_name", type=str, default=None,
                        help="name of a models/<name> checkpoint folder")
    parser.add_argument("--ext", type=str, default="jpg")
    parser.add_argument("--num_layers", type=int, default=18)
    parser.add_argument("--no_colormap", action="store_true")
    parser.add_argument("--no_cuda", action="store_true", help="run on the CPU")
    return parser.parse_args(argv)


def test_simple(args) -> List[Tuple[str, float]]:
    """Predict every image; returns (path, host seconds from decode to the
    files written) per image."""
    device = eval_device(args)
    folder = args.model_path or os.path.join("models", args.model_name)
    feed_height, feed_width = 192, 640
    if os.path.isdir(folder):  # encoder.pth or encoder.ckpt carries the feed size
        meta = read_meta(folder)
        feed_height = int(meta.get("height", feed_height))
        feed_width = int(meta.get("width", feed_width))
    opt = Options(height=feed_height, width=feed_width, num_layers=args.num_layers,
                  compute_dtype="float32")
    models = build_mono_models(opt, device)
    load_eval_folder(folder, models, ("encoder", "depth"))

    if os.path.isfile(args.image_path):
        paths = [args.image_path]
        output_dir = os.path.dirname(args.image_path)
    else:
        paths = glob.glob(os.path.join(args.image_path, f"*.{args.ext}"))
        output_dir = args.image_path
    print(f"-> Predicting on {len(paths)} test images")

    times = []
    for idx, image_path in enumerate(paths):
        if image_path.endswith("_disp.jpg"):
            continue
        t0 = time.perf_counter()
        with Image.open(image_path) as img:
            img = img.convert("RGB")
            orig_w, orig_h = img.size
            resized = img.resize((feed_width, feed_height), Image.LANCZOS)
        x = torch.from_numpy(np.asarray(resized, np.float32) / 255.0).permute(2, 0, 1)[None]
        disp = mono_infer(models, x)
        disp_resized = resize_bilinear(disp, (orig_h, orig_w))[0, 0]

        name = os.path.splitext(os.path.basename(image_path))[0]
        scaled_disp, _ = disp_to_depth(disp, 0.1, 100)
        np.save(os.path.join(output_dir, f"{name}_disp.npy"),
                scaled_disp.permute(0, 2, 3, 1).cpu().numpy())
        if not args.no_colormap:
            try:
                colored = colormap_disparity(disp_resized.cpu().numpy())
            except ImportError:
                print("   matplotlib is not installed: colormap skipped")
            else:
                Image.fromarray(colored).save(os.path.join(output_dir, f"{name}_disp.jpeg"))
        times.append((image_path, time.perf_counter() - t0))
        print(f"   Processed {idx + 1} of {len(paths)} images - saved prediction")
    print("-> Done!")
    return times


def main(argv=None):
    return test_simple(parse_args(argv))


if __name__ == "__main__":
    main()
