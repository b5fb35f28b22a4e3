#!/usr/bin/env python
"""Precompute the scene-sorted ``gt_depths_seq.npz`` for the streaming
(scene) protocol of ``evaluate_depth_gru_fusion`` (counterpart of
``scripts/export_gt_depth_seq.py``, reference export_gt_depth_seq.py).

Test lines are grouped by scene and sorted by frame index, so that whole
scenes stream in order; ``index`` holds "<scene> <frame>" per entry. The
file goes next to the split's ``test_files.txt`` (under
``$SSDE_SPLITS_DIR`` where that is set); ``data`` is a 1-D object array of
float32 maps, as ``export_gt_depth`` writes it.

Run: python -m ssde_tpu_torch.scripts.export_gt_depth_seq --data_path <KITTI raw>
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np

from ..data.kitti_utils import generate_depth_map
from ..data.splits import readlines, split_file
from .export_gt_depth import object_array


def export_gt_depths_seq(data_path: str, split: str) -> str:
    """Write the split's scene-sorted ground truth; returns the file's path."""
    lines = readlines(split_file(split, "test"))
    by_scene = defaultdict(list)
    for line in lines:
        folder, frame_id, _ = line.split()
        by_scene[folder].append(int(frame_id))

    gt_depths, index = [], []
    for folder in sorted(by_scene):
        for frame_id in sorted(by_scene[folder]):
            calib_dir = os.path.join(data_path, folder.split("/")[0])
            velo = os.path.join(data_path, folder, "velodyne_points/data",
                                "{:010d}.bin".format(frame_id))
            gt_depths.append(generate_depth_map(calib_dir, velo, 2, True).astype(np.float32))
            index.append(f"{folder} {frame_id}")

    output_path = os.path.join(os.path.dirname(split_file(split, "test")),
                               "gt_depths_seq.npz")
    print(f"Saving {len(gt_depths)} depths to {output_path}")
    np.savez_compressed(output_path, data=object_array(gt_depths),
                        index=np.array(index))
    return output_path


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="export_gt_depth_seq")
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--split", type=str, default="eigen",
                        choices=["eigen", "eigen_benchmark"])
    args = parser.parse_args(argv)
    return export_gt_depths_seq(args.data_path, args.split)


if __name__ == "__main__":
    main()
