#!/usr/bin/env python
"""Odometry (ATE) evaluation on odom_9 / odom_10 on the GPU (counterpart of
``scripts/evaluate_pose.py``, reference evaluate_pose.py).

Every test line's frame pair (0, 1) goes through the 6-channel pose encoder
and the PoseDecoder; the first frame's axis-angle and translation become a
4x4 transform, and the transforms are scored against ``poses/<seq>.txt``
over 5-frame tracks. ``poses.npy`` is written into --load_weights_folder,
as in the original.

Run: python -m ssde_tpu_torch.scripts.evaluate_pose --eval_split odom_9
       --load_weights_folder <folder of pose_encoder.pth, pose.pth, or of their .ckpt>
       --data_path <KITTI odometry> [--no_cuda]

float32 with TF32 off, on the card unless --no_cuda asks for the CPU.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from ..checkpoint import load_eval_folder
from ..config import MonodepthOptions, Options
from ..data.kitti import KITTIOdomDataset
from ..data.kitti_utils import read_odom_poses
from ..data.pipeline import Loader, to_device
from ..data.splits import readlines, split_file
from ..eval.pose import evaluate_pose_sequence
from ..models import PoseDecoder, ResnetEncoder
from ..ops.geometry import transformation_from_parameters
from .evaluate_depth import eval_device


def load_pose_models(opt: Options, device) -> SimpleNamespace:
    """The pose encoder (two stacked frames) and decoder, loaded from
    ``opt.load_weights_folder`` (strict; both files required), in eval mode."""
    pose_encoder = ResnetEncoder(opt.num_layers, num_input_images=2)
    pose = PoseDecoder(pose_encoder.num_ch_enc, num_input_features=1,
                       num_frames_to_predict_for=2)
    models = SimpleNamespace(pose_encoder=pose_encoder.to(device).eval(),
                             pose=pose.to(device).eval())
    load_eval_folder(os.path.expanduser(opt.load_weights_folder), models,
                     ("pose_encoder", "pose"))
    return models


def predict_poses(opt: Options, sequence_id: int, device) -> np.ndarray:
    """(N, 4, 4) float32 transforms, one per test line, in its order."""
    filenames = readlines(split_file("odom", f"test_files_{sequence_id:02d}"))
    ds = KITTIOdomDataset(opt.data_path, filenames, opt.height, opt.width,
                          frame_idxs=[0, 1], is_train=False,
                          img_ext=".png" if opt.png else ".jpg")
    loader = Loader(ds, 16, shuffle=False, drop_last=False, num_workers=opt.num_workers)
    models = load_pose_models(opt, device)
    pred_poses = []
    for batch in loader:
        b = to_device({k: batch[k] for k in ("color/0", "color/1")}, device)
        pair = torch.cat([b["color/0"], b["color/1"]], -1).permute(0, 3, 1, 2)
        with torch.inference_mode():
            aa, t = models.pose([models.pose_encoder(pair)])
            T = transformation_from_parameters(aa[:, 0], t[:, 0])
        pred_poses.append(T.cpu().numpy())
    return np.concatenate(pred_poses, axis=0)


def evaluate(opt: Options, device=None):
    """(mean ATE, its std) over the sequence; ``poses.npy`` saved."""
    assert os.path.isdir(opt.load_weights_folder), \
        f"Cannot find a folder at {opt.load_weights_folder}"
    assert opt.eval_split in ("odom_9", "odom_10"), \
        "eval_split should be either odom_9 or odom_10"
    sequence_id = int(opt.eval_split.split("_")[1])
    pred_poses = predict_poses(opt, sequence_id, eval_device(opt, device))

    gt_global_poses = read_odom_poses(
        os.path.join(opt.data_path, "poses", f"{sequence_id:02d}.txt"))
    mean_ate, std_ate = evaluate_pose_sequence(pred_poses, gt_global_poses)
    print("\n   Trajectory error: {:0.3f}, std: {:0.3f}\n".format(mean_ate, std_ate))

    save_path = os.path.join(opt.load_weights_folder, "poses.npy")
    np.save(save_path, pred_poses)
    print("-> Predictions saved to", save_path)
    return mean_ate, std_ate


def main(argv=None):
    return evaluate(MonodepthOptions().parse(argv))


if __name__ == "__main__":
    main()
