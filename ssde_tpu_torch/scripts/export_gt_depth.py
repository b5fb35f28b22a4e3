#!/usr/bin/env python
"""Precompute ``gt_depths.npz`` for a split (counterpart of
``scripts/export_gt_depth.py``, reference export_gt_depth.py).

The file goes next to the split's ``test_files.txt`` (under
``$SSDE_SPLITS_DIR`` where that is set). Velodyne maps come from the port's
``data/kitti_utils.generate_depth_map`` (the native projection that
``ssde_tpu_torch/native.py`` builds with g++).

``data`` is a 1-D object array of float32 maps, one per test line, whatever
their shapes. The JAX script's ``np.array(maps, dtype="object")`` gives that
only when the shapes differ (real KITTI's drives); maps of one shape become
an (N, H, W) array of Python floats, on which its evaluation fails in
``np.log``. :func:`object_array` avoids that.

Run: python -m ssde_tpu_torch.scripts.export_gt_depth --data_path <KITTI raw>
       --split eigen
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.kitti_utils import generate_depth_map
from ..data.splits import readlines, split_file


def object_array(arrays) -> np.ndarray:
    """A 1-D object array holding ``arrays`` as they are."""
    out = np.empty(len(arrays), dtype=object)
    for i, a in enumerate(arrays):
        out[i] = a
    return out


def export_gt_depths_kitti(data_path: str, split: str) -> str:
    """Write the split's ground truth; returns the file's path."""
    lines = readlines(split_file(split, "test"))
    print(f"Exporting ground truth depths for {split}")
    gt_depths = []
    for line in lines:
        folder, frame_id, _ = line.split()
        frame_id = int(frame_id)
        if split == "eigen":
            calib_dir = os.path.join(data_path, folder.split("/")[0])
            velo = os.path.join(data_path, folder, "velodyne_points/data",
                                "{:010d}.bin".format(frame_id))
            gt_depth = generate_depth_map(calib_dir, velo, 2, True)
        elif split == "eigen_benchmark":
            from PIL import Image

            gt_path = os.path.join(data_path, folder, "proj_depth", "groundtruth",
                                   "image_02", "{:010d}.png".format(frame_id))
            gt_depth = np.asarray(Image.open(gt_path)).astype(np.float32) / 256
        else:
            raise ValueError(f"unsupported split {split}")
        gt_depths.append(gt_depth.astype(np.float32))

    output_path = os.path.join(os.path.dirname(split_file(split, "test")), "gt_depths.npz")
    print(f"Saving to {output_path}")
    np.savez_compressed(output_path, data=object_array(gt_depths))
    return output_path


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="export_gt_depth")
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--split", type=str, required=True,
                        choices=["eigen", "eigen_benchmark"])
    args = parser.parse_args(argv)
    return export_gt_depths_kitti(args.data_path, args.split)


if __name__ == "__main__":
    main()
