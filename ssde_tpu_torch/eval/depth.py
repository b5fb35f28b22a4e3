"""Depth evaluation protocol (numpy, host-side): ``ssde_tpu/eval/depth.py``,
copied so that the port imports nothing of ``ssde_tpu``
(``tests/test_torch_config.py`` holds the copy to the original).

Reproduces the Monodepth2 eigen evaluation exactly (reference
evaluate_depth.py): resize prediction to GT resolution, 1/disp, eigen crop,
median scaling, clamp [1e-3, 80], seven metrics.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# eigen crop fractions (reference evaluate_depth.py:204-205)
EIGEN_CROP = (0.40810811, 0.99189189, 0.03594771, 0.96405229)
MIN_DEPTH = 1e-3
MAX_DEPTH = 80.0
STEREO_SCALE_FACTOR = 5.4


def compute_errors(gt: np.ndarray, pred: np.ndarray):
    """abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3 (evaluate_depth.py:27-45)."""
    thresh = np.maximum((gt / pred), (pred / gt))
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25**2).mean()
    a3 = (thresh < 1.25**3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def batch_post_process_disparity(l_disp: np.ndarray, r_disp: np.ndarray):
    """Monodepthv1 flip-averaging post-process (evaluate_depth.py:48-56)."""
    _, h, w = l_disp.shape
    m_disp = 0.5 * (l_disp + r_disp)
    l, _ = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h))
    l_mask = (1.0 - np.clip(20 * (l - 0.05), 0, 1))[None, ...]
    r_mask = l_mask[:, :, ::-1]
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m_disp


def _resize_bilinear_np(img: np.ndarray, out_hw) -> np.ndarray:
    """align_corners=False bilinear resize for (H, W) numpy arrays."""
    h, w = img.shape
    oh, ow = out_hw
    ys = np.clip((np.arange(oh) + 0.5) * h / oh - 0.5, 0, h - 1)
    xs = np.clip((np.arange(ow) + 0.5) * w / ow - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    top = img[np.ix_(y0, x0)] * (1 - wx) + img[np.ix_(y0, x1)] * wx
    bot = img[np.ix_(y1, x0)] * (1 - wx) + img[np.ix_(y1, x1)] * wx
    return top * (1 - wy) + bot * wy


def disp_to_eval_depth(disp: np.ndarray, gt_shape) -> np.ndarray:
    """Scaled disparity at network res -> depth at GT res."""
    disp_resized = _resize_bilinear_np(disp, gt_shape)
    return 1.0 / np.maximum(disp_resized, 1e-12)


def evaluate_depth_predictions(
    pred_disps: np.ndarray,
    gt_depths: List[np.ndarray],
    *,
    eval_split: str = "eigen",
    disable_median_scaling: bool = False,
    pred_depth_scale_factor: float = 1.0,
) -> Dict[str, float]:
    """Full protocol over a set of predictions (evaluate_depth.py:177-235).

    pred_disps: (N, h, w) *scaled* disparities (output of disp_to_depth[0]).
    """
    errors = []
    ratios = []
    for i in range(len(pred_disps)):
        gt_depth = gt_depths[i]
        gt_height, gt_width = gt_depth.shape[:2]
        pred_depth = disp_to_eval_depth(pred_disps[i], (gt_height, gt_width))

        if eval_split in ("eigen", "eigen_benchmark"):
            mask = np.logical_and(gt_depth > MIN_DEPTH, gt_depth < MAX_DEPTH)
            if eval_split == "eigen":
                crop = np.array(
                    [
                        EIGEN_CROP[0] * gt_height, EIGEN_CROP[1] * gt_height,
                        EIGEN_CROP[2] * gt_width, EIGEN_CROP[3] * gt_width,
                    ]
                ).astype(np.int32)
                crop_mask = np.zeros(mask.shape)
                crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
                mask = np.logical_and(mask, crop_mask)
        else:
            mask = gt_depth > 0

        pred = pred_depth[mask.astype(bool)]
        gt = gt_depth[mask.astype(bool)]

        pred *= pred_depth_scale_factor
        if not disable_median_scaling:
            ratio = np.median(gt) / np.median(pred)
            ratios.append(ratio)
            pred *= ratio

        pred = np.clip(pred, MIN_DEPTH, MAX_DEPTH)
        errors.append(compute_errors(gt, pred))

    mean_errors = np.array(errors).mean(0)
    names = ["abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3"]
    out = dict(zip(names, [float(v) for v in mean_errors]))
    if ratios:
        r = np.array(ratios)
        out["med_scale"] = float(np.median(r))
        out["med_scale_std"] = float(np.std(r / np.median(r)))
    return out
