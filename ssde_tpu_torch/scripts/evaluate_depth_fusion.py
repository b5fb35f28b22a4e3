#!/usr/bin/env python
"""Eigen-split depth evaluation of the 3-frame fusion models on the GPU
(counterpart of ``scripts/evaluate_depth_fusion.py``; reference
evaluate_depth_13.py and evaluate_depth_fusion_v3.py).

Each test item loads frames [0, -1, -2] (a missing neighbour is the centre
frame), the three ride the batch axis through the encoder and decoder, the
fusion stack of ``--fusion_variant`` (``pyramid``, ``v3``, the default, or
``scale_loop``; ``--disable_attention`` for v3's conv units) fuses them,
and the fused scale-0 disparity is scored with the eigen protocol.

Run: python -m ssde_tpu_torch.scripts.evaluate_depth_fusion --fusion_variant v3
       --load_weights_folder <folder of encoder.pth, depth.pth, fusion.pth, or .ckpt>
       --data_path <KITTI raw> [--no_cuda]

The ground truth is ``gt_depths.npz`` beside the split's test list
(``scripts/export_gt_depth``). The networks run in float32 with TF32 off,
as the JAX script forces float32 matmuls (:44-45); on the card unless
--no_cuda asks for the CPU. The pyramid's and the scale loop's disparities
are not sigmoids (a tanh and a raw conv), so ``disp_to_depth`` can give
negative depths and a metric can be NaN: that is the reference's result.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..checkpoint import load_eval_folder
from ..config import MonodepthOptions, Options
from ..data.kitti import KITTIRAWDataset
from ..data.pipeline import Loader, to_device
from ..data.splits import readlines, split_file
from ..data.transforms import preprocess_batch
from ..eval.depth import evaluate_depth_predictions
from ..ops.geometry import disp_to_depth
from ..train.steps_fusion import CONTEXT_IDS, VARIANTS, build_fusion_models, fusion_infer
from .evaluate_depth import eval_device, load_gt_depths, print_metrics

BATCH = 8  # the JAX script's loader (:57)


def load_fusion_models(opt: Options, variant: str, device):
    """float32 depth encoder, decoder and the ``variant``'s fusion module,
    loaded from ``opt.load_weights_folder`` (strict; the three files
    required)."""
    if opt.load_weights_folder is None:
        raise ValueError("evaluate_depth_fusion needs --load_weights_folder")
    opt.compute_dtype = "float32"
    models = build_fusion_models(opt, variant, device)
    load_eval_folder(os.path.expanduser(opt.load_weights_folder), models,
                     ("encoder", "depth", "fusion"))
    return models


def predict_disps(opt: Options, variant: str, device) -> np.ndarray:
    """(N, H, W) float32 scaled disparities of the test split, in its order:
    batches of 8 from the port's Loader, each preprocessed on the device
    and through :func:`fusion_infer`."""
    filenames = readlines(split_file(opt.eval_split, "test"))
    models = load_fusion_models(opt, variant, device)
    ds = KITTIRAWDataset(opt.data_path, filenames, opt.height, opt.width,
                         frame_idxs=list(CONTEXT_IDS), is_train=False,
                         img_ext=".png" if opt.png else ".jpg", load_depth=False)
    loader = Loader(ds, BATCH, shuffle=False, drop_last=False, num_workers=opt.num_workers)
    disps = []
    for batch in loader:
        inputs = preprocess_batch(to_device(batch, device), opt.height, opt.width,
                                  opt.num_scales, list(CONTEXT_IDS), is_train=False)
        disp = fusion_infer(models, inputs)["disp/0"][:, 0].cpu().numpy()
        disps.append(disp_to_depth(disp, opt.min_depth, opt.max_depth)[0])
    return np.concatenate(disps, axis=0)


def evaluate(opt: Options, variant: str = "v3") -> dict:
    """The metrics dict of the eigen protocol (``scripts/evaluate_depth_fusion.py:105-121``),
    its table printed."""
    pred_disps = predict_disps(opt, variant, eval_device(opt))
    metrics = evaluate_depth_predictions(
        pred_disps, load_gt_depths(opt), eval_split=opt.eval_split,
        disable_median_scaling=opt.disable_median_scaling,
        pred_depth_scale_factor=opt.pred_depth_scale_factor)
    print_metrics(metrics)
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--fusion_variant", type=str, default="v3", choices=list(VARIANTS))
    args, remaining = parser.parse_known_args(argv)
    return evaluate(MonodepthOptions().parse(remaining), args.fusion_variant)


if __name__ == "__main__":
    main()
