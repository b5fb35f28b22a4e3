"""KITTI raw-data utilities: calibration files, velodyne scans -> sparse
depth maps, odometry poses (a copy of ``ssde_tpu/data/kitti_utils.py``
:17-106).

The projection runs in ``native/velodyne.cpp``
(:func:`ssde_tpu_torch.native.project_velodyne_native`);
:func:`project_velodyne_numpy` is its twin, which the tests use. Both keep
the points in front of the car that land in the image and resolve a pixel
hit twice by the minimum depth (reference kitti_utils.py:46-98).
"""

from __future__ import annotations

import os

import numpy as np

from ..native import project_velodyne_native


def read_calib_file(path: str) -> dict:
    """Parse a KITTI calib file of ``key: v0 v1 ...`` lines."""
    data = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                data[key] = value
    return data


def load_velodyne_points(path: str) -> np.ndarray:
    """Load a .bin LiDAR scan as (N, 4) homogeneous points."""
    points = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1.0
    return points


def project_velodyne_numpy(velo: np.ndarray, P: np.ndarray, height: int, width: int,
                           vel_depth: bool = False) -> np.ndarray:
    """The numpy projection of ``ssde_tpu/data/kitti_utils.py:71-96``."""
    velo = velo[velo[:, 0] >= 0, :]  # points in front of the car only
    pts_im = (P @ velo.T).T
    pts_im[:, :2] = pts_im[:, :2] / pts_im[:, 2:3]
    depth_vals = velo[:, 0] if vel_depth else pts_im[:, 2]
    # the devkit convention: -1 so that pixel centers start at 0
    cols = np.round(pts_im[:, 0]) - 1
    rows = np.round(pts_im[:, 1]) - 1
    valid = ((cols >= 0) & (rows >= 0) & (cols < width) & (rows < height)
             & (depth_vals > 0))
    cols = cols[valid].astype(np.int64)
    rows = rows[valid].astype(np.int64)
    depth_vals = depth_vals[valid]
    depth = np.zeros((height, width), dtype=np.float32)
    # a pixel hit twice keeps the minimum: sorted descending, it lands last
    order = np.lexsort((-depth_vals, rows * width + cols))
    rows, cols, depth_vals = rows[order], cols[order], depth_vals[order]
    depth[rows, cols] = depth_vals
    depth[depth < 0] = 0
    return depth


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """Sparse (375, 1242)-style depth image of a velodyne scan in camera
    ``cam`` (reference kitti_utils.py:46-98), projected natively."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    T_velo2cam = np.eye(4)
    T_velo2cam[:3, :3] = velo2cam["R"].reshape(3, 3)
    T_velo2cam[:3, 3] = velo2cam["T"]
    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)
    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    P_velo2im = P_rect @ R_rect @ T_velo2cam
    velo = load_velodyne_points(velo_filename)
    return project_velodyne_native(velo, P_velo2im, int(im_shape[0]), int(im_shape[1]),
                                   vel_depth)


def read_odom_poses(path: str) -> np.ndarray:
    """KITTI odometry GT poses file -> (N, 4, 4) cam-to-world matrices."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = rows.shape[0]
    out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    out[:, :3, :] = rows
    return out
