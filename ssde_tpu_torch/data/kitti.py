"""Host-side KITTI datasets (numpy copy of ``ssde_tpu/data/kitti.py``
:40-313).

The host does what must be host-bound: JPEG/PNG decode, one PIL-LANCZOS
resize to the working resolution, the optional horizontal flip and the
velodyne ground truth. The pyramid, colour jitter and intrinsics scaling
run on the device (``data/transforms.preprocess_batch``).

Item contract (numpy), the JAX package's:
  f"color/{i}":   (H, W, 3) float32 in [0, 1] (uint8 under ``decoded_cache``),
                  already flipped if do_flip
  "K":            (4, 4) normalized intrinsics
  "depth_gt":     (375, 1242) float32  [only when velodyne data exists]
  "stereo_T":     (4, 4) float32       [only with "s" in frame_idxs]
  "jitter":       (4,) float32 [brightness, contrast, saturation, hue]
                  (identity = [1, 1, 1, 0])

Missing neighbour frames fall back to frame 0 (mono_dataset.py:166-170).
``ssde_tpu.data`` cannot be imported without JAX (its ``__init__`` imports
the device-side transforms), so the port copies what it needs;
``tests/test_torch_kitti.py`` holds every item to the original's.
"""

from __future__ import annotations

import hashlib
import os
import random
import threading
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from .kitti_utils import generate_depth_map
from .splits import parse_line

# normalized KITTI intrinsics (reference kitti_dataset.py:25-28)
KITTI_K = np.array(
    [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    dtype=np.float32,
)
FULL_RES_SHAPE = (1242, 375)
SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}
IDENTITY_JITTER = np.array([1.0, 1.0, 1.0, 0.0], dtype=np.float32)


def pil_load_resized(path: str, width: int, height: int, do_flip: bool) -> np.ndarray:
    """(height, width, 3) float32 in [0, 1]: decode, LANCZOS resize, flip."""
    with open(path, "rb") as f:
        with Image.open(f) as img:
            img = img.convert("RGB")
            img = img.resize((width, height), Image.LANCZOS)
            if do_flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            return np.asarray(img, dtype=np.float32) / 255.0


def load_resized_uint8(path: str, width: int, height: int, do_flip: bool,
                       cache_dir: Optional[str] = None) -> np.ndarray:
    """Decode and resize to uint8, with an optional decode-once disk cache.

    With ``cache_dir`` the first visit stores the resized frame (before the
    flip) as ``.npy``, keyed by path, size and the source's size and
    mtime; later visits skip the decode. Unlike the JAX package's copy,
    each thread writes its own temporary file before the rename. uint8 frames also quarter the copy
    to the device, where ``preprocess_batch`` converts them.
    """
    if cache_dir is None:
        arr = None
    else:
        try:
            st = os.stat(path)
            stamp = f"{st.st_size}:{st.st_mtime_ns}"
        except OSError:
            stamp = "?"
        key = hashlib.md5(f"{path}|{width}x{height}|{stamp}".encode()).hexdigest()
        cpath = os.path.join(cache_dir, f"{key}.npy")
        arr = np.load(cpath, mmap_mode="r") if os.path.exists(cpath) else None
    if arr is None:
        with open(path, "rb") as f:
            with Image.open(f) as img:
                img = img.convert("RGB").resize((width, height), Image.LANCZOS)
                arr = np.asarray(img, dtype=np.uint8)
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            # a temporary file per process and thread: the loader's threads
            # decode a frame that several items share at the same time
            tmp = cpath + f".tmp{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, cpath)  # atomic against concurrent workers
    arr = np.asarray(arr)
    if do_flip:
        arr = arr[:, ::-1].copy()
    return arr


def item_rng(seed: int, epoch: int, index: int) -> random.Random:
    """Deterministic per-(seed, epoch, index) RNG stream for __getitem__."""
    return random.Random((seed * 1_000_003 + epoch) * 1_000_003 + index)


def sample_jitter(rng: random.Random) -> np.ndarray:
    """brightness/contrast/saturation in [0.8, 1.2], hue in [-0.1, 0.1]
    (reference mono_dataset.py:72-75)."""
    return np.array([rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2),
                     rng.uniform(0.8, 1.2), rng.uniform(-0.1, 0.1)],
                    dtype=np.float32)


class KITTIDataset:
    """Map-style dataset over split-file lines."""

    def __init__(self, data_path: str, filenames: Sequence[str], height: int, width: int,
                 frame_idxs: Sequence, is_train: bool = False, img_ext: str = ".jpg",
                 load_depth: Optional[bool] = None, seed: int = 0,
                 decoded_cache: Optional[str] = None):
        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.frame_idxs = list(frame_idxs)
        self.is_train = is_train
        self.img_ext = img_ext
        self.K = KITTI_K
        self.seed = seed
        self._epoch = 0
        self.decoded_cache = decoded_cache
        self.load_depth = self.check_depth() if load_depth is None else load_depth

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-item augmentation streams."""
        self._epoch = epoch

    def __len__(self):
        return len(self.filenames)

    def get_image_path(self, folder, frame_index, side):
        raise NotImplementedError

    def get_depth(self, folder, frame_index, side, do_flip):
        raise NotImplementedError

    def check_depth(self) -> bool:
        if not self.filenames:
            return False
        folder, frame_index, _ = parse_line(self.filenames[0])
        velo = os.path.join(self.data_path, folder,
                            "velodyne_points/data/{:010d}.bin".format(int(frame_index)))
        return os.path.isfile(velo)

    def get_color(self, folder, frame_index, side, do_flip):
        path = self.get_image_path(folder, frame_index, side)
        if not os.path.exists(path):
            return None
        if self.decoded_cache is not None:
            return load_resized_uint8(path, self.width, self.height, do_flip,
                                      self.decoded_cache)
        return pil_load_resized(path, self.width, self.height, do_flip)

    def __getitem__(self, index):
        folder, frame_index, side = parse_line(self.filenames[index])
        rng = item_rng(self.seed, self._epoch, index)
        do_flip = self.is_train and rng.random() > 0.5
        do_jitter = self.is_train and rng.random() > 0.5

        inputs = {"color/0": self.get_color(folder, frame_index, side, do_flip)}
        if inputs["color/0"] is None:
            raise FileNotFoundError(
                f"Missing centre frame for split entry {index}: "
                f"{self.get_image_path(folder, frame_index, side)}")
        for i in self.frame_idxs:
            if i == "s":
                other = {"r": "l", "l": "r"}[side]
                stereo = self.get_color(folder, frame_index, other, do_flip)
                if stereo is None:
                    raise FileNotFoundError(
                        f"Missing stereo pair for split entry {index}: "
                        f"{self.get_image_path(folder, frame_index, other)}")
                inputs[f"color/{i}"] = stereo
            elif i != 0:
                color = self.get_color(folder, frame_index + i, side, do_flip)
                inputs[f"color/{i}"] = color if color is not None else inputs["color/0"]

        inputs["K"] = self.K.copy()
        inputs["jitter"] = sample_jitter(rng) if do_jitter else IDENTITY_JITTER
        if self.load_depth:
            inputs["depth_gt"] = self.get_depth(folder, frame_index, side, do_flip)
        if "s" in self.frame_idxs:
            stereo_T = np.eye(4, dtype=np.float32)
            baseline_sign = -1 if do_flip else 1
            side_sign = -1 if side == "l" else 1
            stereo_T[0, 3] = side_sign * baseline_sign * 0.1
            inputs["stereo_T"] = stereo_T
        return inputs


class KITTIRAWDataset(KITTIDataset):
    """Raw KITTI layout with velodyne GT (reference kitti_dataset.py:59-86)."""

    def get_image_path(self, folder, frame_index, side):
        f_str = "{:010d}{}".format(frame_index, self.img_ext)
        return os.path.join(self.data_path, folder,
                            "image_0{}/data".format(SIDE_MAP[side]), f_str)

    def get_depth(self, folder, frame_index, side, do_flip):
        calib_path = os.path.join(self.data_path, folder.split("/")[0])
        velo = os.path.join(self.data_path, folder,
                            "velodyne_points/data/{:010d}.bin".format(int(frame_index)))
        depth_gt = generate_depth_map(calib_path, velo, SIDE_MAP[side])
        depth_gt = _resize_nn(depth_gt, FULL_RES_SHAPE[::-1])
        if do_flip:
            depth_gt = np.fliplr(depth_gt).copy()
        return depth_gt.astype(np.float32)


class KITTIOdomDataset(KITTIDataset):
    """Odometry layout (reference kitti_dataset.py:89-102)."""

    def get_image_path(self, folder, frame_index, side):
        f_str = "{:06d}{}".format(frame_index, self.img_ext)
        return os.path.join(self.data_path, "sequences/{:02d}".format(int(folder)),
                            "image_{}".format(SIDE_MAP[side]), f_str)

    def check_depth(self):
        return False


class KITTIDepthDataset(KITTIDataset):
    """Improved-GT png depth maps (reference kitti_dataset.py:105-135)."""

    def get_image_path(self, folder, frame_index, side):
        f_str = "{:010d}{}".format(frame_index, self.img_ext)
        return os.path.join(self.data_path, folder,
                            "image_0{}/data".format(SIDE_MAP[side]), f_str)

    def get_depth(self, folder, frame_index, side, do_flip):
        f_str = "{:010d}.png".format(frame_index)
        depth_path = os.path.join(self.data_path, folder,
                                  "proj_depth/groundtruth/image_0{}".format(SIDE_MAP[side]),
                                  f_str)
        with Image.open(depth_path) as img:
            img = img.resize(FULL_RES_SHAPE, Image.NEAREST)
            depth_gt = np.asarray(img).astype(np.float32) / 256.0
        if do_flip:
            depth_gt = np.fliplr(depth_gt).copy()
        return depth_gt


def _resize_nn(img: np.ndarray, out_hw) -> np.ndarray:
    """Nearest-neighbour resize (order 0, range preserved)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img
    rows = np.minimum((np.arange(oh) * h / oh).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(ow) * w / ow).astype(np.int64), w - 1)
    return img[rows][:, cols]
