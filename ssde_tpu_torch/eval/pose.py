"""Odometry evaluation: ATE over 5-frame tracks (reference
evaluate_pose.py:23-46, from SfMLearner).

A copy of ``ssde_tpu/eval/pose.py``, so that the port imports nothing of
``ssde_tpu``; ``tests/test_torch_eval_copies.py`` holds it to the original.
"""

from __future__ import annotations

import numpy as np


def dump_xyz(source_to_target_transformations):
    xyzs = []
    cam_to_world = np.eye(4)
    xyzs.append(cam_to_world[:3, 3])
    for T in source_to_target_transformations:
        cam_to_world = np.dot(cam_to_world, T)
        xyzs.append(cam_to_world[:3, 3])
    return np.array(xyzs)


def compute_ate(gtruth_xyz: np.ndarray, pred_xyz_o: np.ndarray) -> float:
    offset = gtruth_xyz[0] - pred_xyz_o[0]
    pred_xyz = pred_xyz_o + offset[None, :]
    scale = np.sum(gtruth_xyz * pred_xyz) / np.sum(pred_xyz**2)
    alignment_error = pred_xyz * scale - gtruth_xyz
    rmse = np.sqrt(np.sum(alignment_error**2)) / gtruth_xyz.shape[0]
    return float(rmse)


def evaluate_pose_sequence(pred_poses: np.ndarray, gt_global_poses: np.ndarray,
                           track_length: int = 5):
    """ATE mean/std over sliding tracks (evaluate_pose.py:104-125).

    pred_poses: (N, 4, 4) frame-to-frame transforms.
    gt_global_poses: (N+1, 4, 4) cam-to-world.
    """
    gt_local = []
    for i in range(1, len(gt_global_poses)):
        gt_local.append(
            np.linalg.inv(gt_global_poses[i - 1]) @ gt_global_poses[i]
        )
    ates = []
    num_frames = gt_global_poses.shape[0]
    for i in range(0, num_frames - 1):
        local_xyzs = dump_xyz(pred_poses[i : i + track_length - 1])
        gt_xyzs = dump_xyz(gt_local[i : i + track_length - 1])
        ates.append(compute_ate(gt_xyzs, local_xyzs))
    return float(np.mean(ates)), float(np.std(ates))
