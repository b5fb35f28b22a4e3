#!/usr/bin/env python
"""Eigen-split depth evaluation of a mono model on the GPU (counterpart of
``scripts/evaluate_depth.py``, reference evaluate_depth.py).

Supports --eval_mono/--eval_stereo, --ext_disp_to_eval (with
--eval_eigen_to_benchmark), --save_pred_disps, --no_eval, --post_process
(flip averaging), --disable_median_scaling and the benchmark-submission PNG
export. Outputs (``disps_<split>_split.npy``, ``benchmark_predictions/``)
go into --load_weights_folder, as in the original.

Run: python -m ssde_tpu_torch.scripts.evaluate_depth --eval_mono
       --load_weights_folder <folder of encoder.pth, depth.pth, or of their .ckpt>
       --data_path <KITTI raw> [--post_process] [--no_cuda]

The ground truth is ``gt_depths.npz`` beside the split's test list
(``scripts/export_gt_depth``). The networks run in float32 with TF32 off,
as the JAX script forces float32 matmuls (:46); on the card unless
--no_cuda asks for the CPU.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from ..checkpoint import load_eval_folder
from ..config import MonodepthOptions, Options
from ..data.kitti import KITTIRAWDataset
from ..data.pipeline import Loader, to_device
from ..data.splits import DEFAULT_SPLITS_DIR, readlines, split_file
from ..eval.depth import (
    STEREO_SCALE_FACTOR,
    batch_post_process_disparity,
    evaluate_depth_predictions,
)
from ..ops.geometry import disp_to_depth
from ..train.steps import build_mono_models, mono_infer
from ..train.trainer import run_device

METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def eval_device(opt, device=None) -> torch.device:
    """The evaluation scripts' device (:func:`run_device` of ``opt``, which
    carries ``no_cuda``), with TF32 off for cuDNN and cuBLAS, process-wide,
    so that float32 is float32."""
    device = run_device(opt, device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def print_metrics(metrics) -> None:
    print("\n  " + ("{:>8} | " * 7).format(*METRIC_NAMES))
    print(("&{: 8.3f}  " * 7).format(*[metrics[n] for n in METRIC_NAMES]) + "\\\\")


def load_gt_depths(opt: Options) -> List[np.ndarray]:
    """The float32 maps of ``gt_depths.npz`` beside the split's test list.
    The conversion also reads a file whose maps were stored as Python
    floats (the JAX export's, when all maps have one shape)."""
    gt_path = os.path.join(os.path.dirname(split_file(opt.eval_split, "test")),
                           "gt_depths.npz")
    data = np.load(gt_path, fix_imports=True, encoding="latin1", allow_pickle=True)["data"]
    return [np.asarray(g, np.float32) for g in data]


def load_mono_models(opt: Options, device):
    """float32 depth encoder and decoder loaded from
    ``opt.load_weights_folder`` (strict; both files required)."""
    opt.compute_dtype = "float32"
    models = build_mono_models(opt, device)
    load_eval_folder(os.path.expanduser(opt.load_weights_folder), models, ("encoder", "depth"))
    return models


def predict_disps(opt: Options, device) -> np.ndarray:
    """(N, H, W) float32 scaled disparities of the test split, in its order:
    batches of 16 from the port's Loader, each through :func:`mono_infer`;
    with --post_process also the images flipped along the width and
    :func:`batch_post_process_disparity` of both."""
    filenames = readlines(split_file(opt.eval_split, "test"))
    models = load_mono_models(opt, device)
    ds = KITTIRAWDataset(opt.data_path, filenames, opt.height, opt.width,
                         frame_idxs=[0], is_train=False,
                         img_ext=".png" if opt.png else ".jpg", load_depth=False)
    loader = Loader(ds, 16, shuffle=False, drop_last=False, num_workers=opt.num_workers)
    disps = []
    for batch in loader:
        imgs = to_device({"color/0": batch["color/0"]}, device)["color/0"].permute(0, 3, 1, 2)
        disp = mono_infer(models, imgs)[:, 0].cpu().numpy()
        if opt.post_process:
            flipped = mono_infer(models, imgs.flip(-1))[:, 0].cpu().numpy()
            disp = batch_post_process_disparity(disp, flipped[:, :, ::-1]).astype(np.float32)
        disps.append(disp_to_depth(disp, opt.min_depth, opt.max_depth)[0])
    return np.concatenate(disps, axis=0)


def save_benchmark_pngs(pred_disps: np.ndarray, save_dir: str) -> None:
    """KITTI benchmark submission format (reference evaluate_depth.py:163-171):
    disparity resized to 1216x352, depth = 5.4 / disp clipped to [0, 80] m,
    stored as uint16 PNG at 1/256 m."""
    os.makedirs(save_dir, exist_ok=True)
    for idx in range(len(pred_disps)):
        disp = Image.fromarray(pred_disps[idx].astype(np.float32), "F")
        disp_resized = np.asarray(disp.resize((1216, 352), Image.BILINEAR), np.float32)
        depth = np.clip(STEREO_SCALE_FACTOR / disp_resized, 0, 80)
        Image.fromarray(np.uint16(depth * 256)).save(os.path.join(save_dir, f"{idx:010d}.png"))


def evaluate(opt: Options, device=None) -> Optional[dict]:
    """The eigen protocol of ``scripts/evaluate_depth.py:98-168``: the
    metrics dict, or None under --no_eval and for the benchmark split."""
    if opt.ext_disp_to_eval is not None:
        pred_disps = np.load(opt.ext_disp_to_eval)
        if opt.eval_eigen_to_benchmark:
            ids = np.load(os.path.join(DEFAULT_SPLITS_DIR, "benchmark",
                                       "eigen_to_benchmark_ids.npy"))
            pred_disps = pred_disps[ids]
    else:
        assert opt.eval_mono != opt.eval_stereo, (
            "Please choose mono or stereo evaluation by setting either "
            "--eval_mono or --eval_stereo")
        pred_disps = predict_disps(opt, eval_device(opt, device))

    if opt.save_pred_disps:
        out = os.path.join(opt.load_weights_folder, f"disps_{opt.eval_split}_split.npy")
        print(f"-> Saving predicted disparities to {out}")
        np.save(out, pred_disps)

    if opt.no_eval:
        print("-> Evaluation disabled. Done.")
        return None

    if opt.eval_split == "benchmark":
        save_dir = os.path.join(opt.load_weights_folder, "benchmark_predictions")
        print(f"-> Saving out benchmark predictions to {save_dir}")
        save_benchmark_pngs(pred_disps, save_dir)
        print("-> No ground truth is available for the KITTI benchmark; done.")
        return None

    gt_depths = load_gt_depths(opt)
    disable_median = opt.disable_median_scaling
    scale_factor = opt.pred_depth_scale_factor
    if opt.eval_stereo:
        print(f"   Stereo evaluation - disabling median scaling, "
              f"scaling by {STEREO_SCALE_FACTOR}")
        disable_median = True
        scale_factor = STEREO_SCALE_FACTOR
    else:
        print("   Mono evaluation - using median scaling")

    metrics = evaluate_depth_predictions(
        pred_disps, gt_depths, eval_split=opt.eval_split,
        disable_median_scaling=disable_median, pred_depth_scale_factor=scale_factor)
    if "med_scale" in metrics:
        print(" Scaling ratios | med: {:0.3f} | std: {:0.3f}".format(
            metrics["med_scale"], metrics["med_scale_std"]))
    print_metrics(metrics)
    print("\n-> Done!")
    return metrics


def main(argv=None):
    return evaluate(MonodepthOptions().parse(argv))


if __name__ == "__main__":
    main()
